"""The readings a cell's limits are set from, in one process:

    python3 -m benchmark.limits --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

Set-up is made once.  For each seed of ``--seeds`` the pool of right-hand
sides of a run with that ``--seed`` is solved once through the cell's entry
point as the cell configures it, and each answer judged as a run judges it:
a check's lower reading is the largest it reads over these seeds.  For each
of ``--control-seeds`` the same is done under each control of
``--controls``, the program's own lower-precision paths switched on:
``single``, the whole solve in float32 (the precision below the float64 of
the outer residual and the answer), and ``bf16``, the Krylov loop in
bfloat16 (below its float32) under the float64 outer residual, without the
escalation to float32.  A check's upper reading is the smallest a control
gives.  Prints a line a seed and, last, a JSON summary.  Needs the card, as
a run does."""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from benchmark.harness import Setup, judge, load_cell, reported

CONTROLS = {
    "single": {"mode": "single"},
    "bf16": {"mode": {"outer": "float64", "inner": "bfloat16", "precond": "float32"},
             "bf16_escalation": False},
}


def readings(setup: Setup, reference, seed: int, cfg) -> dict:
    B = setup.pool(seed)
    lanes, size = setup.lanes, len(B)
    answers, iters, converged = [], [], []
    t0 = time.perf_counter()
    for i in range(size // lanes):
        idx = [i * lanes + j for j in range(lanes)]
        for b, r in zip(idx, setup.call(B, idx, cfg=cfg, record_history=True)):
            answers.append((b, r.x, reported(r)))
            iters.append(r.total_iters)
            converged.append(r.converged)
    seconds = time.perf_counter() - t0
    numbers = judge(reference, B, answers)
    worst = {k: max((n[k] for n in numbers if k in n), default=math.inf)
             for k in ("worst_backward_error", "worst_reported_gap")}
    return {"seed": seed, **worst, "unconverged": converged.count(False), "iters": iters,
            "seconds": seconds}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--controls", default="single,bf16")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cell = load_cell(args.workload)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spans: dict = {}
    setup = Setup(cell, args.device, spans)
    reference = setup.reference()
    print(f"setup {json.dumps(spans)}", flush=True)
    sound = [readings(setup, reference, int(s), setup.cfg) for s in args.seeds.split(",")]
    for r in sound:
        print(json.dumps({"run": "sound", **r}), flush=True)
    checks = cell.config["checks"]
    lower = {k: max(r[k] for r in sound) for k in checks}
    upper = {}
    for name in args.controls.split(","):
        cfg = setup.config_for({**cell.config["solver"], **CONTROLS[name]})
        for s in filter(None, args.control_seeds.split(",")):
            r = readings(setup, reference, int(s), cfg)
            print(json.dumps({"run": f"control {name}", **r}), flush=True)
            for k in checks:
                upper.setdefault(name, {})[k] = min(upper.get(name, {}).get(k, math.inf), r[k])
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "limits": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
