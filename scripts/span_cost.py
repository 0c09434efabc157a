"""What recording the program's spans costs a call: one cell of
``BENCHMARK.json`` set up by the benchmark's harness, then interleaved
pairs of blocks of calls, one block with the spans off and one with them
on (``utils.profiling.recording``, the profiler off), the order of the
two alternating from pair to pair.  Then one call under the profiler
(the device's records only, as the benchmark traces a call) and
``--after`` more pairs: what a profiler session leaves behind in the
process.  Prints one JSON line: each block's seconds a call, and the
on/off ratio of each pair.

    python3 scripts/span_cost.py --workload convdiff4M-mixed.seq --pairs 8 --calls 8 --after 4
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="convdiff4M-mixed.seq")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--pairs", type=int, default=8)
    p.add_argument("--calls", type=int, default=8)
    p.add_argument("--after", type=int, default=4)
    args = p.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import Setup, load_cell
    from gmres_tpu_torch.utils.profiling import recording

    setup = Setup(load_cell(args.workload), "cuda", {})
    B = setup.pool(args.seed)
    idx = list(range(setup.lanes))
    setup.call(B, idx)

    step_ms = []

    def block(on: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spans = []
        for _ in range(args.calls):
            if on:
                with recording() as spans:
                    setup.call(B, idx)
            else:
                setup.call(B, idx)
        wall = (time.perf_counter() - t0) / args.calls
        steps = [s.end_ns - s.start_ns for s in spans if s.name == "step"]
        if on:
            # the mean step span of the block's last call, as host_ms_per_step reads it
            step_ms.append(sum(steps) / len(steps) * 1e-6)
        return wall

    def pairs(n: int) -> dict:
        off, on = [], []
        for i in range(n):
            for flag in ((False, True) if i % 2 == 0 else (True, False)):
                (on if flag else off).append(block(flag))
        ratios = [a / b for a, b in zip(on, off)]
        return {"off_s": off, "on_s": on, "on_over_off": ratios,
                "median_ratio": statistics.median(ratios),
                "on_slower_in": sum(r > 1 for r in ratios), "step_ms": step_ms[-len(on):]}

    before = pairs(args.pairs)
    with profile(activities=[ProfilerActivity.CUDA]):
        setup.call(B, idx)
        torch.cuda.synchronize()
    after = pairs(args.after) if args.after else None
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(),
                      "calls_a_block": args.calls, "before_a_profile": before,
                      "after_a_profile": after}))


if __name__ == "__main__":
    main()
