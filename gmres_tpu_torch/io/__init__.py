"""Host-side inputs: the reference's manufactured-solution RNG and the
synthetic matrix builders (numpy)."""
