"""The benchmark of ``gmres_tpu_torch`` on one NVIDIA H100.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  The
harness finds each configuration (``configs/``), traffic mix (``traffic/``),
operator generator (``operators/``) and per-layer metric (``metrics/``) by
the name that ``BENCHMARK.json`` gives it.  Nothing here imports JAX or the
JAX package; ``reference.py`` imports nothing of the port either.
"""
