"""The per-layer readers on made-up traces: each byte rule against PERF.md
section 6 (K1 (D+2)n, lanes (D+2s)n, residual (D+3s)n fp64, K2 (rows+1)n,
K3 GRAM and K3 SUMSQ (rows+2)n), the counts, and the union of busy
intervals."""

import pytest

from benchmark import trace
from benchmark.harness import Run, loop_steps, read_metric

N, D = 4096, 5
K1 = "void dia_spmv_kernel<{t}, {r}, true, {l}>(DiaArgs<{t}>, DiaOffsets)"
K2 = "void basis_gram_kernel<float, float, true, 1>(float const*, float const*)"
K2X2 = "void basis_gram_kernel<float, float, true, 2>(float const*, float const*)"
K3G = "void basis_update_gram_kernel<float, float, true>(float const*)"
K3S = "void basis_update_kernel<float, float, true, 1>(float const*)"
K6 = "void ilu_levels_kernel<float, 0>(LevelParams<float>)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>()"


def run(events, cycles=None, calls=None, window_s=1.0, mode="mixed"):
    return Run({"solver": {"mode": mode}}, N, D, {"stage_s": 1.5}, window_s,
               calls or [{"iters": [60], "steps": 60, "seconds": window_s}], events, cycles)


def at(name, start, dur):
    return (name, start, start + dur)


@pytest.mark.parametrize("t,w", [("float", 4), ("double", 8)])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_spmv_bytes(t, w, lanes):
    ev = [at(K1.format(t=t, r="false", l=lanes), 0.0, 10.0)]
    need = (D + 2 * lanes) * N * w
    assert read_metric("spmv_roofline", run(ev)) == pytest.approx(
        100 * need / 3.35e12 / 10e-6)


@pytest.mark.parametrize("lanes", [1, 8])
def test_spmv_residual_bytes(lanes):
    ev = [at(K1.format(t="double", r="true", l=lanes), 0.0, 20.0),
          at(K1.format(t="float", r="false", l=lanes), 30.0, 10.0)]
    need = (D + 3 * lanes) * N * 8 + (D + 2 * lanes) * N * 4
    assert read_metric("spmv_roofline", run(ev)) == pytest.approx(
        100 * need / 3.35e12 / 30e-6)


def test_orth_bytes():
    ev = [at(K2, 0, 5), at(K3G, 10, 6), at(K3S, 20, 7), at(K2X2, 30, 100), at(TORCH, 200, 50)]
    cycles = [[3, 2]]
    # step with r rows: K2 (r+1) + K3 GRAM (r+2) + K3 SUMSQ (r+2) values
    values = sum(3 * r + 5 for k in cycles[0] for r in range(1, k + 1))
    assert values == (3 * 6 + 15) + (3 * 3 + 10)
    assert read_metric("orth_roofline", run(ev, cycles)) == pytest.approx(
        100 * values * N * 4 / 3.35e12 / 18e-6)
    # the same sweeps on a float64 basis; and sweeps that do not share a basis type
    ev64 = [(name.replace("float", "double"), s, e) for name, s, e in ev]
    assert read_metric("orth_roofline", run(ev64, cycles)) == pytest.approx(
        100 * values * N * 8 / 3.35e12 / 18e-6)
    assert read_metric("orth_roofline", run(ev[:1] + ev64[1:], cycles)) is None


def test_nothing_to_read():
    ev = [at(TORCH, 0, 5)]
    for name in ("spmv_roofline", "orth_roofline", "precond_apply_ms"):
        assert read_metric(name, run(ev, [[30]])) is None
    for name in ("kernels_per_step", "device_idle", "device_s_per_rhs"):
        assert read_metric(name, run(None)) is None
    assert read_metric("precond_build_s", run(ev)) is None


def test_counts_and_idle():
    ev = [at(K6, 0, 4000), at(K6, 5000, 4200), at("Memcpy DtoH (Device -> Pinned)", 9300, 5),
          at(TORCH, 9200, 400)]
    r = run(ev, cycles=[[30, 30]], calls=[{"iters": [60], "steps": 60, "seconds": 0.5},
                                          {"iters": [90], "steps": 90, "seconds": 0.5}])
    assert read_metric("precond_apply_ms", r) == pytest.approx(4.1)
    assert read_metric("kernels_per_step", r) == pytest.approx(3 / 60)
    assert read_metric("iters_per_rhs", r) == 75
    busy = 4000 + 4200 + 400
    assert trace.busy_us(ev) == busy
    assert read_metric("device_idle", r) == pytest.approx(
        100 * (1 - busy * 1e-6 / 60 / (1.0 / 150)))
    assert read_metric("stage_s", r) == 1.5
    assert read_metric("device_s_per_rhs", r) == pytest.approx(busy * 1e-6)  # one lane


def test_loop_steps_of_lanes():
    assert loop_steps([[30, 30, 12]]) == 72
    assert loop_steps([[30, 30, 12], [30, 30], [30, 30, 30, 5]]) == 30 + 30 + 30 + 5


def test_breakdown():
    ev = [at(K1.format(t="float", r="false", l=1), 0, 10), at(K2, 15, 5),
          at(K1.format(t="double", r="true", l=1), 30, 10), at(TORCH, 45, 1)]
    b = trace.breakdown(ev)
    assert b["device_ops"][0] == ["K1 float lanes 1", pytest.approx(10e-6)]
    assert dict((k, v) for k, v in b["device_ops"])["K1 residual"] == pytest.approx(10e-6)
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["K2 -> K1 residual"] == pytest.approx(10e-6)
    assert gaps["K1 float lanes 1 -> K2"] == pytest.approx(5e-6)
    assert trace.group(TORCH) == "at::native::vectorized_elementwise_kernel<CUDAFunctor_add>"
