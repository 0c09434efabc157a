"""The readers of the program's spans on made-up spans and device records:
the join of a kernel to its launch by correlation id, the innermost span
at a launch, ``givens_launches_per_step``, ``idle_by_span``, and the
host-clock readers; and none of them reads a program without spans."""

import pytest

from benchmark import spans
from benchmark.harness import Run, read_metric
from gmres_tpu_torch.utils.profiling import Span

MS = 1_000_000  # nanoseconds
K1 = "void dia_spmv_kernel<float, false, true, 1>(DiaArgs<float>, DiaOffsets)"
K2 = "void basis_gram_kernel<float, float, true, 1>(float const*, float const*)"
MUL = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_mul<float>>()"
MV = "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4>()"


def span(name, start, end, parent=None, **attrs):
    return Span(name, start, end, parent, 0, attrs)


def one_step(t0):
    """A cycle's span list of one step from t0 (ms): the step from t0 to
    t0 + 10, its SpMV 0-2, its sweeps 2-5, its Givens 5-10."""
    return [span("step", t0 * MS, (t0 + 10) * MS, 0, k=0),
            span("step.spmv", t0 * MS, (t0 + 2) * MS, 1),
            span("step.orth", (t0 + 2) * MS, (t0 + 5) * MS, 1),
            span("step.givens", (t0 + 5) * MS, (t0 + 10) * MS, 1)]


def traced_spans():
    out = [span("cycle", 0, 30 * MS, i=0)] + one_step(0)
    out += [span("cycle.read", 20 * MS, 29 * MS, 0)]
    return out


# (name, device start, device end, host launch) in ns
KERNELS = [(K1, 1 * MS, 3 * MS, int(0.5 * MS)),
           (K2, 3 * MS, 6 * MS, int(2.5 * MS)),
           (MUL, 8 * MS, 9 * MS, int(5.5 * MS)),
           (MV, 9 * MS, 10 * MS, int(6 * MS)),
           ("Memcpy DtoD (Device -> Device)", 10 * MS, 11 * MS, int(7 * MS)),
           (MUL, 25 * MS, 26 * MS, int(12 * MS)),     # launched under the cycle alone
           (MUL, 27 * MS, 28 * MS, None)]             # its launch record lost


def run_with(c):
    r = Run({"solver": {"mode": "mixed"}}, 64, 5, {}, 1.0,
            [{"iters": [1], "steps": 1, "seconds": 1.0}], [], [[1]])
    setattr(r, spans.ATTR, c)
    return r


def collected(kernels=KERNELS, loop_steps=1):
    setup = [span("stage", 0, 9 * MS), span("stage.pack", 0, 7 * MS, 0),
             span("stage.upload", 7 * MS, 9 * MS, 0),
             span("precond.build", 10 * MS, 20 * MS),
             span("precond.factor", 10 * MS, 16 * MS, 3)]
    added = [span("solve", 0, 100 * MS, entry="solve", lanes=1),
             span("solve.prepare", 0, 3 * MS, 0),
             span("cycle", 3 * MS, 60 * MS, 0, i=0),
             span("step", 4 * MS, 6 * MS, 2, k=0), span("step", 6 * MS, 10 * MS, 2, k=1),
             span("cycle.read", 50 * MS, 58 * MS, 2),
             span("cycle", 60 * MS, 99 * MS, 0, i=1),
             span("cycle.read", 61 * MS, 65 * MS, 6)]
    return spans.Collected(setup, traced_spans(), kernels, loop_steps, added)


class FakeEvent:
    def __init__(self, name, start, end, cuda, corr):
        self._v = (name, start, end, cuda, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[4]


class FakeProf:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_a_kernel_is_joined_to_its_launch_by_correlation_id():
    events = [FakeEvent("cudaLaunchKernel", 500, 510, False, 7),
              FakeEvent(K1, 900, 990, True, 7),
              FakeEvent("cuLaunchKernel", 600, 610, False, 8),
              FakeEvent(MUL, 1000, 1010, True, 8),
              # a host operator whose own id happens to equal a kernel's
              FakeEvent("aten::mul", 700, 720, False, 9),
              FakeEvent(MV, 1100, 1120, True, 9)]
    assert spans.device_records(FakeProf(events)) == [
        (K1, 900, 990, 500), (MUL, 1000, 1010, 600), (MV, 1100, 1120, None)]


def test_the_innermost_span_at_a_launch():
    s = traced_spans()
    times = [int(0.5 * MS), int(2.5 * MS), int(5.5 * MS), 12 * MS, 21 * MS, 31 * MS, 0]
    names = [None if i is None else s[i].name for i in spans.innermost(s, times)]
    assert names == ["step.spmv", "step.orth", "step.givens", "cycle", "cycle.read", None,
                     "step.spmv"]
    assert spans.layer_of(s, KERNELS) == ["step.spmv", "step.orth", "step.givens",
                                          "step.givens", "step.givens", "cycle", None]


@pytest.mark.parametrize("steps", [1, 4])
def test_givens_launches_per_step(steps):
    # the elementwise and mv kernels under step.givens; not the copy, not K1 or K2
    r = run_with(collected(loop_steps=steps))
    assert read_metric("givens_launches_per_step", r) == pytest.approx(2 / steps)
    assert read_metric("givens_launches_per_step.ilu0", r) == pytest.approx(2 / steps)
    lost = [(n, a, b, None) for n, a, b, _ in KERNELS]
    assert read_metric("givens_launches_per_step", run_with(collected(lost))) is None


def test_idle_by_span():
    idle = dict(spans.idle_by_span(traced_spans(), KERNELS))
    # gaps: 6-8 ms ended by the mul launched under step.givens, 11-25 ms by
    # the mul launched under the cycle, 26-27 ms by the one whose launch was lost
    assert idle == pytest.approx({"step.givens": 2e-3, "cycle": 14e-3, "unattributed": 1e-3})
    # overlapping operations leave no gap
    assert spans.idle_by_span([], [(K1, 0, 10, 0), (K2, 5, 8, 1), (MUL, 9, 12, 2)]) == []


def test_host_clock_readers():
    r = run_with(collected())
    assert read_metric("host_ms_per_step", r) == pytest.approx(3.0)
    assert read_metric("host_ms_per_step.ilu0", r) == pytest.approx(3.0)
    assert read_metric("cycle_wait_ms", r) == pytest.approx(6.0)
    assert read_metric("call_setup_ms.ilu0", r) == pytest.approx(3.0)
    assert read_metric("stage_pack_s", r) == pytest.approx(7e-3)
    assert read_metric("precond_factor_s", r) == pytest.approx(6e-3)
    no_precond = collected()
    no_precond.setup = no_precond.setup[:3]
    assert read_metric("precond_factor_s", run_with(no_precond)) is None


def test_self_seconds():
    # the call: 100 ms, of which prepare 3, cycles 57 and 39; the steps 2 and 4
    own = spans.self_seconds(collected().added)
    assert own == pytest.approx({"solve": 1e-3, "solve.prepare": 3e-3, "cycle": 78e-3,
                                 "step": 6e-3, "cycle.read": 12e-3})


NEW = ["host_ms_per_step", "givens_launches_per_step", "cycle_wait_ms", "call_setup_ms",
       "stage_pack_s", "precond_factor_s"]


def test_a_program_without_spans_gives_nothing_to_read(monkeypatch):
    from gmres_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recording")
    r = Run({"solver": {"mode": "mixed"}}, 64, 5, {}, 1.0,
            [{"iters": [1], "steps": 1, "seconds": 1.0}], [], [[1]])
    assert [read_metric(name, r) for name in NEW] == [None] * len(NEW)


def test_an_untraced_run_gives_nothing_to_read():
    r = Run({"solver": {"mode": "mixed"}}, 64, 5, {}, 1.0,
            [{"iters": [1], "steps": 1, "seconds": 1.0}])
    assert [read_metric(name, r) for name in NEW] == [None] * len(NEW)
