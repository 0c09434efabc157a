"""Run one cell of ``BENCHMARK.json`` once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for (without them it exits 2 and prints no result).  The last line of
standard output is the result's JSON object; the numbers the check compared
are the last lines of standard error.  ``setup_s`` counts from this
module's first line."""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness import NoResult, emit, run_cell

    try:
        emit(run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START))
    except NoResult as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
