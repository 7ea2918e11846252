"""The random-number generator of the IC generators (the
``rand_algorithm`` factory of ``gandalf_tpu/utils/rng.py``).

`rand_algorithm = default` maps to numpy's Generator seeded with
`randseed`, as there.  The bit-exact reference xorshift generator is not
ported: no configuration of the port selects it.
"""

from __future__ import annotations

import numpy as np


def rng_from_params(params):
    """Generator selected by rand_algorithm/randseed
    (Simulation::ProcessParameters RNG factory, Simulation.cpp:1107-1117)."""
    if params.stringparams["rand_algorithm"] == "xorshift":
        raise NotImplementedError(
            "rand_algorithm = xorshift is not ported yet (ROADMAP queue 1, "
            "item 9)")
    return np.random.default_rng(params.intparams["randseed"])
