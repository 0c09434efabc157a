"""stage_s (s; layer: host setup, ``solver/gmres.py:stage``): the harness's
host clock around ``stage()`` (CSR -> DIA on the host and the upload),
ending in a device sync.  Moves ``setup_s``."""


def read(run):
    return run.spans.get("stage_s")
