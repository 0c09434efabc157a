"""The condest command line, with the flags of the reference's ``condest``
(``condest.cpp:186-227``; ``gmres_tpu/cli/condest_cli.py``).

    python -m gmres_tpu_torch.cli.condest_cli --synth convdiff:1024 --max-iters 20000

``--device`` is ``cuda`` (the default; ``--gpu`` is the reference's spelling
of it) or ``cpu``.  ``main(argv)`` returns the exit code.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gmres-condest")
    p.add_argument("--Apath", default=None)
    p.add_argument("--rand", type=int, default=42)
    p.add_argument("--max-iters", type=int, default=100_000, dest="max_iters")
    p.add_argument("--gpu", action="store_true",
                   help="the reference's flag for the GPU: --device cuda")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--synth", default=None)
    args = p.parse_args(argv)

    if args.Apath is None and args.synth is None:
        print("No value suplied for A")
        return 1

    from gmres_tpu_torch.cli.solve import make_synth
    from gmres_tpu_torch.io.loader import load_matrix
    from gmres_tpu_torch.solver.condest import condest
    from gmres_tpu_torch.solver.gmres import resolve_device

    dev = resolve_device("cuda" if args.gpu else args.device)
    A = make_synth(args.synth) if args.synth else load_matrix(args.Apath)
    condest(A, rand_seed=args.rand, max_iters=args.max_iters, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
