"""Best-config selector — the reference's ``find-min.py`` capability:
per-matrix, per-mode minimum-median-time configuration over accumulated
history rows, emitted in timing-script or plotting (python-dict) formats
(``find-min.py:26-130``; ``gmres_tpu/experiments/findmin.py``).

    python -m gmres_tpu_torch.experiments.findmin --plotting-format \\
        1e-8 cgsr cuda identity convdiff1024
"""

from __future__ import annotations

import argparse
import sys
from statistics import median

from gmres_tpu_torch.experiments.history import min_median_config, process_rows


def collect(mat, in_dir, **filters):
    buckets = {"b": [], "mp": [], "p": [], "s": []}
    handlers = {code: buckets[code].append for code in buckets}
    process_rows(mat, handlers, in_dir=in_dir, **filters)
    return {code: min_median_config(rows) for code, rows in buckets.items()}


def _plot_tuple(best):
    if not best:
        return "('-', '-', '-', '-', '-', '-', '-', '-')"
    totals = best["totals"]
    loc = best["loc"]
    return (
        f"({min(totals)}, {median(totals)}, {max(totals)}, "
        f"{best['restarts']}, {best['total_iters']}, "
        f"'{loc[0]}', '{loc[1]}', '{loc[2]}')"
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Parses history files to determine the optimal configuration"
    )
    p.add_argument("--timing-script-format", action="store_true")
    p.add_argument("--plotting-format", action="store_true")
    p.add_argument("--rlen", default=None)
    p.add_argument("--rtol", default=None)
    p.add_argument("--rorth", default=None)
    p.add_argument("--in-dir", default=".")
    p.add_argument("tol")
    p.add_argument("orth")
    p.add_argument("device", help="Device used for the results, e.g. cuda or cpu.")
    p.add_argument("prec", help="The preconditioner")
    p.add_argument("mats", nargs="+")
    args = p.parse_args(argv)

    if args.timing_script_format and args.plotting_format:
        print("Cannot use both timing-script and plotting formats")
        return 1

    emitted = 0
    for mat in args.mats:
        best = collect(
            mat, args.in_dir,
            tol=args.tol, orth=args.orth, device=args.device, prec=args.prec,
            rlen=args.rlen, rtol=args.rtol, rorth=args.rorth,
        )
        if not best["b"]:
            print(f"findmin: no baseline rows for {mat!r} under the given "
                  f"filters in {args.in_dir!r}", file=sys.stderr)
            continue
        emitted += 1
        if args.plotting_format:
            print(
                f"'{mat}': [{_plot_tuple(best['b'])}, {_plot_tuple(best['mp'])}, "
                f"{_plot_tuple(best['p'])}, {_plot_tuple(best['s'])}],"
            )
        else:
            b, mp = best["b"], best["mp"]
            mp_part = (
                f" {mp['ilu_median']} {mp['gmres_median']} "
                f"({mp['loc'][0]}, {mp['loc'][1]}, {mp['loc'][2]})"
                if mp
                else " - - (-, -, -)"
            )
            print(
                f"{mat} {b['ilu_median']} {b['gmres_median']} "
                f"({b['loc'][0]}, {b['loc'][1]}, {b['loc'][2]})" + mp_part
            )
    if emitted == 0:
        # an empty selection is a failed measurement, not a success: callers
        # must see a nonzero exit
        print("findmin: no matching history rows at all", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
