"""What a run loads: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``gmres_tpu`` (the part of a module's name before its first dot,
compared whole: ``gmres_tpu_torch`` begins with ``gmres_tpu``); and the
plain reference, the inputs and the generators load nothing of the
program, ``gmres_tpu_torch``.  Each case runs in a fresh interpreter."""

import json
import subprocess
import sys

from benchmark.harness import ROOT

TOP = "sorted({m.split('.')[0] for m in sys.modules})"


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"import sys\n{code}\nprint(json.dumps({TOP}))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = loaded("import json\nfrom benchmark.harness import run_cell, emit\n"
                  "emit(run_cell('convdiff4M-mixed.seq', 3, 0.0, True, device='cpu', "
                  "overrides={'operator': {'nx': 16}, 'solver': {'restart_length': 8}}))")
    assert "gmres_tpu_torch" in mods and "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "gmres_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded(
        "import json, torch\nfrom benchmark.reference import Reference\n"
        "from benchmark import inputs\nfrom benchmark.operators import generator\n"
        "rp, c, v = generator('convection_diffusion_2d').build(nx=8, beta=2.0)\n"
        "ref = Reference(rp, c, v, 'cpu')\n"
        "b = ref.matvec(torch.from_numpy(inputs.rand_vect(64, 1)))\n"
        "assert ref.backward_error(b, torch.zeros(64, dtype=torch.float64)) > 0")
    assert not mods & {"gmres_tpu_torch", "jax", "jaxlib", "flax", "gmres_tpu"}


def test_emit_refuses_a_loaded_jax_package(monkeypatch, capsys):
    import pytest

    from benchmark import harness

    monkeypatch.setitem(sys.modules, "gmres_tpu.solver", object())
    with pytest.raises(harness.NoResult, match="gmres_tpu"):
        harness.emit({"checks": {}})
    assert capsys.readouterr().out == ""


def test_no_result_without_a_card_or_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark, and on a
    machine without a card, a run exits with another code than 0 and
    prints no result."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (tmp_path, ROOT):
        p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                            "convdiff4M-mixed.seq", "--seed", "1", "--seconds", "1", "--trace",
                            "0"], cwd=cwd, capture_output=True, text=True)
        if cwd == ROOT and p.returncode == 0:
            continue  # a machine with a card runs the cell
        assert p.returncode != 0 and "{" not in p.stdout
