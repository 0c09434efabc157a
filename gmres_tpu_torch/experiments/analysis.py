"""Benchmark analysis, the capability of the reference's
``plots-and-data.ipynb`` as a library and a command line
(``gmres_tpu/experiments/analysis.py``, carried):

- per-matrix best-config timings per mode (min/med/max over seeds) from the
  history store;
- speedup of each mode vs the fp64 baseline, with geometric means;
- the notebook's log2-axis speedup bar chart with min/max error bars;
- LaTeX table generators (timings and iteration counts);
- matrix property table (rows, nnz, bandwidth, optional condest, on the
  port's ``solver/condest.py``).

matplotlib is imported only by ``plot_speedups`` (``--plot``); a machine
without it raises there, naming it.
"""

from __future__ import annotations

import argparse
import math
import sys

from gmres_tpu_torch.experiments.findmin import collect

MODES = [("b", "baseline"), ("mp", "mixed"), ("p", "single-prec"), ("s", "single")]


def best_timings(mats, tol, orth, device, prec, in_dir="."):
    """{mat: {mode_code: {'min','med','max','restarts','total_iters','loc'}}}"""
    out = {}
    for mat in mats:
        best = collect(mat, in_dir, tol=tol, orth=orth, device=device,
                       prec=prec, rlen=None, rtol=None, rorth=None)
        row = {}
        for code, b in best.items():
            if not b:
                continue
            totals = sorted(b["totals"])
            row[code] = dict(
                min=totals[0],
                med=totals[len(totals) // 2] if len(totals) % 2 else
                    0.5 * (totals[len(totals) // 2 - 1] + totals[len(totals) // 2]),
                max=totals[-1],
                restarts=b["restarts"],
                total_iters=b["total_iters"],
                loc=b["loc"],
            )
        if row.get("b"):
            out[mat] = row
    return out


def speedups(timings, mode_code="mp"):
    """{mat: (speedup_med, speedup_min, speedup_max)} vs baseline, plus
    the geometric mean over matrices (the notebook's headline numbers)."""
    per_mat = {}
    logs = []
    for mat, row in timings.items():
        if "b" not in row or mode_code not in row:
            continue
        base, mode = row["b"], row[mode_code]
        s_med = base["med"] / mode["med"]
        # conservative error bars: slowest-vs-fastest pairing
        s_min = base["min"] / mode["max"]
        s_max = base["max"] / mode["min"]
        per_mat[mat] = (s_med, s_min, s_max)
        if s_med > 0 and math.isfinite(s_med):
            logs.append(math.log(s_med))
    geo = math.exp(sum(logs) / len(logs)) if logs else float("nan")
    return per_mat, geo


def latex_timing_table(timings):
    lines = [
        r"\begin{tabular}{l" + "r" * (2 * len(MODES)) + "}",
        "matrix & "
        + " & ".join(f"{name} med & iters" for _, name in MODES)
        + r" \\",
    ]
    for mat, row in sorted(timings.items()):
        cells = []
        for code, _ in MODES:
            if code in row:
                cells += [f"{row[code]['med']:.4g}", str(row[code]["total_iters"])]
            else:
                cells += ["-", "-"]
        lines.append(f"{mat} & " + " & ".join(cells) + r" \\")
    lines.append(r"\end{tabular}")
    return "\n".join(lines)


def plot_speedups(timings, mode_code="mp", out_path="speedups.png", title=None):
    """The notebook's log2 bar chart with min/max error bars."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_speedups (--plot) needs matplotlib, which this Python "
                          "cannot import; the tables need nothing") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    per_mat, geo = speedups(timings, mode_code)
    mats = sorted(per_mat)
    med = np.array([per_mat[m][0] for m in mats])
    lo = np.array([per_mat[m][1] for m in mats])
    hi = np.array([per_mat[m][2] for m in mats])

    fig, ax = plt.subplots(figsize=(max(6, 0.5 * len(mats)), 4))
    xs = np.arange(len(mats))
    ax.bar(xs, np.log2(med), color="#4878a8")
    ax.errorbar(xs, np.log2(med),
                yerr=[np.log2(med) - np.log2(lo), np.log2(hi) - np.log2(med)],
                fmt="none", ecolor="black", capsize=2)
    ax.axhline(0, color="black", lw=0.8)
    ax.set_xticks(xs)
    ax.set_xticklabels(mats, rotation=60, ha="right", fontsize=8)
    ax.set_ylabel("log2 speedup vs fp64 baseline")
    ax.set_title(title or f"{mode_code} speedup (geo-mean {geo:.3f}x)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return geo


def matrix_properties(mats, in_dir=".", condest_iters=0, device="cuda"):
    """Property table like the notebook's cell 1 (rows, nnz, bandwidth,
    optional cond estimate via solver/condest on ``device``)."""
    import os

    from gmres_tpu_torch.io.loader import load_matrix
    from gmres_tpu_torch.ops.reorder import bandwidth

    rows = []
    mat_dir = os.getenv("MTXDIR", "mats")
    for mat in mats:
        A = load_matrix(os.path.join(mat_dir, mat + ".mtx"))
        entry = dict(mat=mat, n=A.n_rows, nnz=A.nnz, bandwidth=bandwidth(A))
        if condest_iters:
            from gmres_tpu_torch.solver.condest import condest

            cond, smax, smin, _ = condest(A, max_iters=condest_iters,
                                          verbose=lambda *a: None, device=device)
            entry.update(cond2=cond, sigma_max=smax, sigma_min=smin)
        rows.append(entry)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Analyze gmres_tpu_torch benchmark history")
    p.add_argument("--in-dir", default=".")
    p.add_argument("--mode", default="mp", choices=[c for c, _ in MODES])
    p.add_argument("--plot", default=None, help="write a speedup chart PNG")
    p.add_argument("--latex", action="store_true")
    p.add_argument("tol")
    p.add_argument("orth")
    p.add_argument("device")
    p.add_argument("prec")
    p.add_argument("mats", nargs="+")
    args = p.parse_args(argv)

    t = best_timings(args.mats, args.tol, args.orth, args.device, args.prec,
                     args.in_dir)
    per_mat, geo = speedups(t, args.mode)
    for mat in sorted(per_mat):
        s_med, s_min, s_max = per_mat[mat]
        print(f"{mat}: {s_med:.3f}x  [{s_min:.3f}, {s_max:.3f}]")
    print(f"geometric mean ({args.mode} vs baseline): {geo:.4f}x")
    if args.latex:
        print(latex_timing_table(t))
    if args.plot:
        plot_speedups(t, args.mode, args.plot)
        print(f"wrote {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
