"""Each cell end to end on the port's CPU path at a tiny grid: the
harness's set-up, window, traced call and check, with ``correct`` true and
the metrics the cell reports (the device readers find no device operation
on the CPU and leave theirs out)."""

import json
from pathlib import Path

import pytest

from benchmark.harness import ROOT, load_cell, run_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = {"operator": {"nx": 24}, "solver": {"restart_length": 8}}
# the readers of the device's trace find nothing on the CPU
DEVICE_METRICS = {m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
                  if m["source"] == "device_trace"}


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run(workload):
    r = run_cell(workload, 2 ** 31 + 17, 0.2, False, device="cpu", overrides=TINY)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {m["name"] for m in load_cell(workload).end_to_end}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert r["checks"]["worst_backward_error"]["value"] <= 1e-8


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run(workload, tmp_path, monkeypatch):
    import benchmark.harness as h

    monkeypatch.setattr(h, "TRACE_DIR", tmp_path)
    r = run_cell(workload, 5, 0.1, True, device="cpu", overrides=TINY)
    assert r["correct"]
    want = {m["name"] for m in load_cell(workload).per_layer} - DEVICE_METRICS
    assert set(r["metrics"]) == want
    assert Path(tmp_path / f"{workload}.json").is_file()
    assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r


def test_same_seed_same_inputs():
    a = run_cell(CELLS[0], 99, 0.0, False, device="cpu", overrides=TINY)
    b = run_cell(CELLS[0], 99, 0.0, False, device="cpu", overrides=TINY)
    assert a["checks"] == b["checks"]
