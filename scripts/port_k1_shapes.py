#!/usr/bin/env python3
"""Launch shapes of K1's plain mode (``csrc/dia_spmv.cu``) on one CUDA
device, each timed in turns with the parent checkout's kernel.

    python3 scripts/port_k1_shapes.py --parent DIR [--rounds 5] [--jobs 8]

A shape is (R rows a thread, B bands whose loads a thread issues together,
M blocks an SM its registers are capped for): ``dia_rows_per_thread``,
``dia_bands`` and ``dia_min_blocks`` of the kernel.  For each shape of the
grid R in {1, 2, 4} (chunks of at most 16 bytes), B in {1, 2, 3, 5}, M in
{1, 2, 3, 4, 6, 8}, and of R = 2 with x read one value at a time at every
band offset (``sx_``: B in {3, 5}, M in {1, 2, 4}), the script writes a
copy of ``dia_spmv.cu`` with explicit specializations of those three
functions for the plain mode at 1, 2, 4 and 8 lanes in fp32 and fp64 (at
one lane R stays the 16-byte chunk that ``spmv_kernel.rows_per_thread``
gives it, so only B and M vary there),
builds it alone with this checkout's nvcc flags under
``build/k1_shapes/<shape>/`` (``--jobs`` nvcc at once), and calls its
``gmres_dia_spmv_*`` entry points through ctypes with the plan that
``spmv_kernel.dia_plan`` makes for that R.  The copy of this checkout's
source as it stands (no specialization) is timed too, as ``cur`` on its
default grids and as ``cur_g<k>`` on persistent grids of k = 2, 3, 4, 5, 6
and 8 blocks an SM.

The forms are those of ``scripts/port_kernels.py``: K1 plain at convdiff@1M
on x of U(0, 1) entries, the plain lane form on the strided view V[:s, 1]
of an (8, 3, n) lane basis at s = 2, 4 and 8 (``k1_inputs``), and K12 plain
on the interior row block of convdiff@1M over 4 ranks (``halo_inputs``),
fp32 and fp64.  Each round times, for each form, the parent's wrapper and
then every shape's launch (median of 20 calls with L2 flushed, the timer of
``chip_smoke.py``); ``--rounds`` rounds.  Every shape's y is checked bit
for bit against the parent's first.  Prints the card's name and power
limit and one line a form: the parent's median of the rounds' medians, the
current source's and the five fastest shapes', each with the number of
rounds it beat the parent in; ``--json FILE`` writes every time and each
shape's registers and spill stores of the plain kernels (ptxas -v).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import itertools
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "gmres_tpu_torch" / "csrc"
OUT = ROOT / "build" / "k1_shapes"
LANES = (1, 2, 4, 8)
ROWS, BANDS, BLOCKS = (1, 2, 4), (1, 2, 3, 5), (1, 2, 3, 4, 6, 8)
# x read one value at a time at every band offset (as PR 9's K12 read it),
# on 16-byte chunks of rows (R = 2 in the lane forms)
SCALAR_X_BANDS, SCALAR_X_BLOCKS = (3, 5), (1, 2, 4)
# the source as it is on persistent grids of k blocks an SM
GRIDS = (2, 3, 4, 5, 6, 8)
_ANCHOR = "// The interior blocks [b0, b1)"
_WIDE = "if (R > 1 && a.x_wide && (off & (R - 1)) == 0) {"


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec_of(r, b, m) -> dict:
    """{(ctype, lanes): (R, B, M)} of the plain mode at every lane count (R
    the 16-byte chunk at one lane)."""
    spec = {}
    for ctype, size in (("float", 4), ("double", 8)):
        for lanes in LANES:
            rows = 16 // size if lanes == 1 else r
            if rows * size <= 16:
                spec[(ctype, lanes)] = (rows, b, m)
    return spec


def shapes():
    """tag -> ({(ctype, lanes): (R, B, M)}, scalar x); ``cur`` is the
    source as it is."""
    out = {"cur": ({}, False)}
    for r, b, m in itertools.product(ROWS, BANDS, BLOCKS):
        out[f"r{r}_b{b}_m{m}"] = (spec_of(r, b, m), False)
    for b, m in itertools.product(SCALAR_X_BANDS, SCALAR_X_BLOCKS):
        out[f"sx_r2_b{b}_m{m}"] = (spec_of(2, b, m), True)
    return out


def source_with(spec, scalar_x=False, text=None) -> str:
    """dia_spmv.cu (or ``text``) with ``spec``'s shapes as explicit
    specializations, and with x read one value at a time at every offset
    where ``scalar_x``."""
    text = (SRC / "dia_spmv.cu").read_text() if text is None else text
    for anchor in (_ANCHOR,) + ((_WIDE,) if scalar_x else ()):
        if text.count(anchor) != 1:
            raise RuntimeError(f"dia_spmv.cu: expected one '{anchor}'")
    lines = []
    for (ctype, lanes), (r, b, m) in sorted(spec.items()):
        for fn, v in (("dia_rows_per_thread", r), ("dia_bands", b), ("dia_min_blocks", m)):
            lines.append(f"template <>\n__host__ __device__ constexpr int "
                         f"{fn}<{ctype}, false, {lanes}>() {{ return {v}; }}\n")
    text = text.replace(_ANCHOR, "".join(lines) + "\n" + _ANCHOR)
    return text.replace(_WIDE, "if (false) {") if scalar_x else text


def build(tag, text, nvcc, flags):
    """Compile ``text`` alone into build/k1_shapes/<tag>/; return (tag,
    library path, ptxas lines of the plain kernels)."""
    d = OUT / tag
    d.mkdir(parents=True, exist_ok=True)
    src = d / "dia_spmv.cu"
    src.write_text(text)
    lib = d / "libdia.so"
    cmd = [nvcc, *flags, "-I", str(SRC), "-shared", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tag}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return tag, lib, plain_ptxas(proc.stdout + proc.stderr)


def plain_ptxas(log: str) -> dict:
    """'<dtype> L<lanes> aligned|general' -> 'registers/spill stores' of
    each plain-mode kernel in ptxas's -v lines."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"dia_spmv_kernelI([fd])Lb0ELb([01])ELi(\d)E", ln)
        if "Compiling entry function" in ln:
            name = (f"{'f32' if m.group(1) == 'f' else 'f64'} L{m.group(3)} "
                    f"{'aligned' if m.group(2) == '1' else 'general'}") if m else None
        elif name and "spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[name] = f"{regs}/{spill}"
            name, spill = None, 0
    return out


def bind(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for sfx in ("f32", "f64"):
        fn = getattr(lib, f"gmres_dia_spmv_{sfx}")
        fn.argtypes = (p, p, ll, p, p, i, i, p, ll, i, i, i, p, i, i, i, i, i, p)
        fn.restype = i
        fns[sfx] = fn
    return fns


def measure(torch, parent, variants, rounds, jobs):
    """variants: tag -> (source text, {(ctype, lanes): R} or None for this
    checkout's rows_per_thread[, blocks an SM of a persistent grid]).
    Builds each source once, checks each variant's y against the parent's
    and times both in turns; returns ({form: {tag: [ms a round]}}, {tag:
    ptxas of its plain kernels})."""
    pk = _module("port_kernels", ROOT / "scripts" / "port_kernels.py")
    cs = pk._timer_module()
    old = pk._wrappers(parent)
    sk = pk._wrappers(ROOT)[2]
    _build = sys.modules["gmres_tpu_torch.ops.cuda._build"]
    flags = list(_build.NVCC_FLAGS)
    first = {}  # source text -> the first tag that has it
    for tag, (text, *_) in variants.items():
        first.setdefault(text, tag)
    with ThreadPoolExecutor(jobs) as ex:
        built = list(ex.map(lambda kv: build(kv[1], kv[0], _build._nvcc(), flags),
                            first.items()))
    by_text = {text: (bind(path), lines) for text, (_, path, lines) in zip(first, built)}
    libs = {tag: by_text[v[0]][0] for tag, v in variants.items()}
    ptxas = {tag: by_text[v[0]][1] for tag, v in variants.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d64, offs, x_np, _, V_np, _, _ = pk.k1_inputs(torch)
    D, n = d64.shape
    h64, hoffs, hx64, hl64, hr64, _ = pk.halo_inputs(torch)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def launcher(fns, sfx, data, o, x, x_ld, y, lanes, rows, n_rows, per_sm, left=None,
                 right=None):
        plan = sk.dia_plan(o, n_rows, n_rows, data.element_size(), rows)
        c_offs = (ctypes.c_int * len(o))(*o)
        hl, hr = (0, 0) if left is None else (left.shape[0], right.shape[0])

        def call():
            code = fns[sfx](data.data_ptr(), x.data_ptr(), x_ld,
                            None if left is None else left.data_ptr(),
                            None if right is None else right.data_ptr(), hl, hr, y.data_ptr(),
                            n_rows, n_rows, n_rows, len(o), c_offs, lanes, plan.b0, plan.b1,
                            per_sm * sms, sms, stream())
            if code:
                raise RuntimeError(f"gmres_dia_spmv_{sfx}: CUDA error {code}")
        return call

    forms = {}  # key -> (parent call, {tag: call}, y of the shapes, y of the parent)
    for dt, sfx, ctype in ((torch.float32, "f32", "float"), (torch.float64, "f64", "double")):
        data, x = d64.to(dt), torch.tensor(x_np, dtype=dt, device="cuda")
        V = torch.tensor(V_np, dtype=dt, device="cuda")
        hd, hx, hl, hr = (t.to(dt) for t in (h64, hx64, hl64, hr64))
        cases = [(f"k1_spmv {dt}".replace("torch.", ""), 1,
                  lambda data=data, x=x: old[2].dia_spmv_cuda(data, offs, x),
                  dict(data=data, o=offs, x=x, x_ld=n, n_rows=n))]
        for s in LANES[1:]:
            X = V[:s, 1]
            cases.append((f"k1_lanes {dt} s{s}".replace("torch.", ""), s,
                          lambda data=data, X=X: old[2].dia_spmv_lanes_cuda(data, offs, X),
                          dict(data=data, o=offs, x=X, x_ld=X.stride(0), n_rows=n)))
        cases.append((f"halo_spmv {dt} interior".replace("torch.", ""), 1,
                      lambda hd=hd, hx=hx, hl=hl, hr=hr:
                      old[3].dia_spmv_halo_cuda(hd, hoffs, hx, hl, hr),
                      dict(data=hd, o=hoffs, x=hx, x_ld=hx.shape[0], n_rows=hx.shape[0],
                           left=hl, right=hr)))
        for key, s, parent_call, kw in cases:
            want = parent_call()
            width = next(w for w in LANES if w >= s)
            calls, ys = {}, {}
            for tag, (_, rows_of, *per_sm) in variants.items():
                if rows_of and (ctype, width) not in rows_of:
                    continue  # no such shape in this dtype
                rows = (rows_of[(ctype, width)] if rows_of else
                        sk.rows_per_thread(dt.itemsize, width))
                y = torch.empty(want.shape, dtype=dt, device="cuda")
                calls[tag] = launcher(libs[tag], sfx, y=y, lanes=s, rows=rows,
                                      per_sm=(per_sm or [0])[0], **kw)
                calls[tag]()
                ys[tag] = y
            torch.cuda.synchronize()
            moved = [t for t, y in ys.items() if not torch.equal(y, want)]
            if moved:
                raise RuntimeError(f"{key}: y moved in {moved}")
            forms[key] = (parent_call, calls)
            del ys

    timer = cs.Timer(torch)
    times = {key: {"parent": [], **{t: [] for t in calls}} for key, (_, calls) in forms.items()}
    for _ in range(rounds):
        for key, (parent_call, calls) in forms.items():
            times[key]["parent"].append(timer(parent_call))
            for tag, call in calls.items():
                times[key][tag].append(timer(call))
    return times, ptxas


def report(times, rounds):
    """One line a form: the parent's median of the rounds' medians, cur's
    and the five fastest variants', each with the rounds it beat the
    parent in."""
    for key, rec in times.items():
        par = rec["parent"]
        med = {t: statistics.median(v) for t, v in rec.items()}
        wins = {t: sum(a < b for a, b in zip(v, par)) for t, v in rec.items()}
        best = sorted((t for t in rec if t != "parent"), key=med.get)[:5]
        cur = f"cur {med['cur']:.4f} ({wins['cur']}/{rounds})" if "cur" in med else ""
        print(f"{key:28s} parent {med['parent']:.4f}  {cur}  " +
              "  ".join(f"{t} {med[t]:.4f} ({wins[t]}/{rounds})" for t in best), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--json", help="write every time and each shape's ptxas lines here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_k1_shapes: torch sees no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    variants = {tag: (source_with(spec, sx), {k: v[0] for k, v in spec.items()})
                for tag, (spec, sx) in shapes().items()}
    for k in GRIDS:
        variants[f"cur_g{k}"] = (variants["cur"][0], None, k)
    times, ptxas = measure(torch, args.parent, variants, args.rounds, args.jobs)
    report(times, args.rounds)
    if args.json:
        Path(args.json).write_text(json.dumps(dict(
            device=torch.cuda.get_device_name(0), rounds=args.rounds, times=times,
            ptxas=ptxas)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
