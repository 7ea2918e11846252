"""The random-number generators of the IC generators (the
``rand_algorithm`` factory of ``gandalf_tpu/utils/rng.py``).

``XorshiftRand`` reproduces the reference generator bit for bit
(RandomNumber.h:64-131: the xorshift triple 21/35/4, the multiply by
4768777513237032717 mod 2^64 on output and a 10-step warm-up), as the
JAX package's does: ``floatrand``, ``fill`` and the numpy-style
``random`` and ``uniform`` that the N-body IC generators draw through.
The state is one 64-bit word kept as a Python int; ``fill`` is a plain
Python loop (no native helper), so the stream is the same on any host.
``random_sphere``, ``montecarlo_field``, ``gaussrand`` and
``standard_normal`` are not ported: no generator of the port calls them.
``rand_algorithm = default`` maps to numpy's Generator seeded with
``randseed``, as there.
"""

from __future__ import annotations

import numpy as np

_MASK = (1 << 64) - 1
_AMOD = 4768777513237032717
_INVRANDMAX = 1.0 / 1.84467440737095e19


class XorshiftRand:
    """Bit-exact reference xorshift (RandomNumber.h:64-131)."""

    def __init__(self, seed: int):
        self.x = int(seed) & _MASK
        for _ in range(10):
            self._step()

    def _step(self) -> int:
        x = self.x
        x ^= x >> 21
        x ^= (x << 35) & _MASK
        x ^= x >> 4
        self.x = x
        return (x * _AMOD) & _MASK

    def floatrand(self) -> float:
        # float() of an int below 2^64 rounds to nearest, as the C++
        # static_cast<double> of the uint64 does
        return float(self._step()) * _INVRANDMAX

    def fill(self, n: int) -> np.ndarray:
        """n sequential floatrand() draws, advancing the state by exactly
        n steps."""
        return np.array([self.floatrand() for _ in range(int(n))],
                        dtype=np.float64)

    # numpy-Generator-style adapters (the IC generators consume these)
    def random(self, size=None):
        if size is None:
            return self.floatrand()
        n = int(np.prod(size))
        return self.fill(n).reshape(size)

    def uniform(self, lo=0.0, hi=1.0, size=None):
        return lo + (hi - lo) * self.random(size)


def rng_from_params(params):
    """Generator selected by rand_algorithm/randseed
    (Simulation::ProcessParameters RNG factory, Simulation.cpp:1107-1117)."""
    seed = params.intparams["randseed"]
    if params.stringparams["rand_algorithm"] == "xorshift":
        return XorshiftRand(seed)
    return np.random.default_rng(seed)
