"""Deterministic manufactured-solution RNG with std::mt19937 parity.

The reference generates the manufactured solution x with ``std::mt19937`` +
``std::uniform_real_distribution<float>`` (``gmres_perf_test.cpp:39-51``) —
float distribution on purpose, so the vector is bit-identical regardless of
the solve precision.  To reproduce the reference's convergence histories on
the same (matrix, seed) inputs we re-implement the generator exactly:

- MT19937 with the single-seed Knuth initializer (``mt[0]=seed;
  mt[i] = 1812433253*(mt[i-1]^(mt[i-1]>>30))+i``), which is what
  ``std::mt19937(seed)`` uses;
- libstdc++'s ``generate_canonical<float, 24>``: one 32-bit draw per value,
  ``ret = float(draw) / float(2^32)`` evaluated in float32, clamped to
  ``1 - 2^-24`` when the rounded quotient reaches 1.0.

The twist/temper steps are vectorized over the 624-word state, so generating
multi-million-entry vectors costs milliseconds.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)


class MT19937:
    """Bit-exact std::mt19937 (single integer seed)."""

    def __init__(self, seed: int = 5489):
        mt = np.empty(_N, dtype=np.uint32)
        mt[0] = np.uint32(seed)
        prev = int(mt[0])
        for i in range(1, _N):
            prev = (1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF
            mt[i] = prev
        self._mt = mt
        self._idx = _N  # force a twist before the first draw

    def _twist(self):
        # The reference twist updates the state *in place*: entries past
        # N-M read already-updated earlier entries.  Vectorize in stages
        # whose inputs are fully available (dependence depth N/(N-M) ~ 3).
        old = self._mt
        new = np.empty(_N, dtype=np.uint32)

        def xa(y):
            mag = np.where((y & np.uint32(1)).astype(bool), _MATRIX_A, np.uint32(0))
            return (y >> np.uint32(1)) ^ mag

        # y[i] for i < N-1 depends only on the old state
        y_head = (old[:-1] & _UPPER) | (old[1:] & _LOWER)
        xa_head = xa(y_head)
        k = _N - _M  # 227
        new[:k] = old[_M:] ^ xa_head[:k]
        i = k
        while i < _N - 1:
            j = min(_N - 1, i + k)
            new[i:j] = new[i - k : j - k] ^ xa_head[i:j]
            i = j
        # last entry wraps around to the freshly updated new[0]
        y_last = (old[_N - 1] & _UPPER) | (new[0] & _LOWER)
        new[_N - 1] = new[_M - 1] ^ xa(np.uint32(y_last))
        self._mt = new
        self._idx = 0

    def random_raw(self, n: int) -> np.ndarray:
        """n tempered 32-bit outputs (uint32)."""
        out = np.empty(n, dtype=np.uint32)
        filled = 0
        while filled < n:
            if self._idx >= _N:
                self._twist()
            take = min(n - filled, _N - self._idx)
            out[filled : filled + take] = self._mt[self._idx : self._idx + take]
            self._idx += take
            filled += take
        # tempering (vectorized)
        y = out
        y = y ^ (y >> np.uint32(11))
        y = y ^ ((y << np.uint32(7)) & np.uint32(0x9D2C5680))
        y = y ^ ((y << np.uint32(15)) & np.uint32(0xEFC60000))
        y = y ^ (y >> np.uint32(18))
        return y


def uniform_float_canonical(draws: np.ndarray) -> np.ndarray:
    """libstdc++ generate_canonical<float, 24> applied to raw 32-bit draws."""
    vals = draws.astype(np.float32) / np.float32(2.0**32)
    # float32(draw) rounds up to 2^32 for draws >= 2^32 - 2^7, making the
    # quotient exactly 1.0; libstdc++ clamps to nextafter(1, 0).
    one_minus_ulp = np.float32(1.0) - np.float32(2.0**-24)
    return np.where(vals >= np.float32(1.0), one_minus_ulp, vals)


def rand_vect(n: int, seed: int = 0) -> np.ndarray:
    """The reference's ``rand_vect`` (``gmres_perf_test.cpp:39-51``): float
    uniforms in [0,1) from mt19937(seed), stored as float64."""
    draws = MT19937(seed).random_raw(n)
    return uniform_float_canonical(draws).astype(np.float64)
