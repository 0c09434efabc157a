"""The check must fail where the answers are wrong: the control (the
program's own float32 path, one precision below the float64 outer residual
the configuration states, which reports a backward error its answer does
not have) and the faults a cell can have, each planted under a run that
otherwise goes as on the card.  A sound run of the same seed passes."""

import dataclasses

import pytest
import torch

import gmres_tpu_torch.solver.batched as batched
import gmres_tpu_torch.solver.gmres as gmres
from benchmark.harness import run_cell

# restarts of 8 steps, so that every solve takes several cycles, as at the
# cells' sizes
TINY = {"operator": {"nx": 24}, "solver": {"restart_length": 8, "max_restarts": 60}}
SEQ, ILU, BATCH = "convdiff4M-mixed.seq", "convdiff1M-ilu0-mixed.seq", "convdiff4M-mixed.batch8"


def cpu_run(workload, overrides=None):
    return run_cell(workload, 2024, 0.0, False, device="cpu",
                    overrides={**TINY, **(overrides or {})})


@pytest.mark.parametrize("workload", [SEQ, ILU, BATCH])
def test_sound_and_control(workload):
    assert cpu_run(workload)["correct"]
    r = cpu_run(workload, {"solver": {**TINY["solver"], "mode": "single"}})
    assert not r["correct"]
    gap = r["checks"]["worst_reported_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("workload", [SEQ, ILU, BATCH])
def test_step_returns_state_unchanged(workload, monkeypatch):
    """The solution update leaves x as it was."""
    monkeypatch.setattr(gmres._NativeBasis, "update", lambda self, x, y: x)
    r = cpu_run(workload)
    assert not r["correct"] and r["failed"] == r["attempted"]


@pytest.mark.parametrize("workload", [SEQ, ILU])
def test_answer_altered_where_produced(workload, monkeypatch):
    """solve's answer with one entry off by 1 (the entries lie in [0, 1)):
    about 5 / (||A||_F ||x||) of backward error, which is 4.5e-7 at the 4M
    cell's size."""
    solve = gmres.solve

    def altered(*args, **kw):
        res = solve(*args, **kw)
        x = res.x.clone()
        x[0] += 1
        return dataclasses.replace(res, x=x)

    monkeypatch.setattr(gmres, "solve", altered)
    assert not cpu_run(workload)["correct"]


def test_batch_answer_altered_where_produced(monkeypatch):
    solve_batched = batched.solve_batched

    def altered(*args, **kw):
        res = solve_batched(*args, **kw)
        res[3].x[0] += 1
        return res

    monkeypatch.setattr(batched, "solve_batched", altered)
    r = cpu_run(BATCH)
    assert not r["correct"] and r["failed"] >= 1


def test_half_of_the_batch_left_out(monkeypatch):
    """Only the first half of the right-hand sides solved; the others given
    the mean of those answers, marked converged."""
    solve_batched = batched.solve_batched

    def half(A, B, cfg=None, **kw):
        res = solve_batched(A, B[: B.shape[0] // 2], cfg, **kw)
        mean = torch.stack([r.x for r in res]).mean(dim=0)
        return res + [dataclasses.replace(res[0], x=mean.clone()) for _ in res]

    monkeypatch.setattr(batched, "solve_batched", half)
    r = cpu_run(BATCH)
    assert not r["correct"] and r["failed"] >= r["attempted"] // 2


@pytest.mark.cuda
def test_on_the_card(card):
    """A sound run and the control at a small grid through the card's
    kernels."""
    small = {"operator": {"nx": 256}}
    assert run_cell(SEQ, 77, 0.5, False, device=card, overrides=small)["correct"]
    assert not run_cell(SEQ, 77, 0.0, False, device=card,
                        overrides={**small, "solver": {"mode": "single"}})["correct"]
