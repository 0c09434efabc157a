"""Experiment results store (``gmres_tpu/experiments/history.py``, carried
so that the port imports nothing of the JAX package).

Two formats are written side by side:

- ``history-<mat>.csv`` — the reference's exact append-only CSV schema
  (``utils.py:10``): mat, type, orth, rlen, rtol, rorth, tol, device, prec,
  i, total_iters, res, err, ilu, gmres.  Mode codes: b / mp / p / s.
  Failed/diverged runs record ``'-'`` fields (``automated.py:89-98``) —
  divergence is data, not an error.
- ``history-<mat>.jsonl`` — structured records (no stdout scraping).
"""

from __future__ import annotations

import csv
import json
import os
from statistics import median

FIELDS = [
    "mat", "type", "orth", "rlen", "rtol", "rorth", "tol", "device", "prec",
    "i", "total_iters", "res", "err", "ilu", "gmres",
]

MODE_CODES = {
    "baseline": "b",
    "mixed": "mp",
    "single-prec": "p",
    "single": "s",
}


def append_rows(mat: str, rows: list[dict], out_dir: str = "."):
    csv_path = os.path.join(out_dir, f"history-{mat}.csv")
    jsonl_path = os.path.join(out_dir, f"history-{mat}.jsonl")
    with open(csv_path, "a", newline="") as f:
        w = csv.writer(f, delimiter=",")
        for row in rows:
            w.writerow([row.get(k, "-") for k in FIELDS])
    with open(jsonl_path, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def read_history(mat: str, in_dir: str = "."):
    """Rows as dicts (the reference's open_history_file, utils.py:3-16)."""
    path = os.path.join(in_dir, f"history-{mat}.csv")
    with open(path, "r") as f:
        reader = csv.DictReader(f, delimiter=",", fieldnames=FIELDS)
        return [row for row in reader if row]


def _filter_match(want, got) -> bool:
    """Filter comparison: exact match first (the reference's semantics,
    utils.py:19-37), then numeric equality (so ``1e-8`` matches the CSV's
    ``1e-08``) and case-insensitive fallback (``cgsr`` vs ``CGSR``) — a
    mismatched spelling must not silently select zero rows."""
    if want is None or want == got:
        return True
    try:
        return float(want) == float(got)
    except (TypeError, ValueError):
        return str(want).lower() == str(got).lower()


def process_rows(mat, handlers: dict, in_dir: str = ".", **filters):
    """Dispatch rows by mode code with optional filters (utils.py:19-37)."""
    for row in read_history(mat, in_dir):
        if all(_filter_match(filters[k], row[k]) for k in filters):
            fn = handlers.get(row["type"])
            if fn:
                fn(row)


def min_median_config(rows: list[dict]):
    """Group by (rlen, rtol, rorth); median gmres time per group; return the
    argmin group (find-min.py:9-19)."""
    gmres_times, ilu_times, restarts, iters = {}, {}, {}, {}
    for row in rows:
        if row["gmres"] == "-":
            continue
        loc = (row["rlen"], row["rtol"], row["rorth"])
        gmres_times.setdefault(loc, []).append(float(row["gmres"]))
        ilu_times.setdefault(loc, []).append(float(row["ilu"]))
        restarts[loc] = int(row["i"])
        iters[loc] = int(row["total_iters"])
    best, best_time = None, float("inf")
    for loc, times in gmres_times.items():
        med = median(times)
        if med < best_time:
            best_time, best = med, loc
    if best is None:
        return None
    return {
        "loc": best,
        "gmres_median": best_time,
        "ilu_median": median(ilu_times[best]),
        "restarts": restarts[best],
        "total_iters": iters[best],
        "totals": [g + i for g, i in zip(gmres_times[best], ilu_times[best])],
    }
