"""Host-side inputs: MatrixMarket I/O with the reference's loader semantics,
the reference's manufactured-solution RNG and the synthetic matrix builders
(numpy)."""
