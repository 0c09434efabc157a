"""The reference's experiment tooling: the sweep runner (``sweep``), its
results store in the reference's CSV schema (``history``), the
best-configuration selector (``findmin``), the matrix suites and the
analysis of the results (``analysis``: speedups, LaTeX tables, plots)."""
