"""precond_build_s (s; layer: host setup, ``precond/build.py``): the
harness's host clock around ``build_preconditioner`` and ``M.to(device)``
(the host factorization, the level schedule and the upload), ending in a
device sync.  Nothing to read in a cell without a preconditioner.  Moves
``setup_s``."""


def read(run):
    return run.spans.get("precond_build_s")
