"""The reference's experiment tooling: the sweep runner (``sweep``), its
results store in the reference's CSV schema (``history``), the
best-configuration selector (``findmin``) and the matrix suites."""
