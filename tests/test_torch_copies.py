"""The port's copies of the JAX package's host modules agree with the
originals: the Parameters default table, the unit system, the IC
generators the port's configurations use (box, lattice and random
sphere; the xorshift generator is not ported and raises) and the C++
tree planner built from the port's own kdplan.cpp."""

import numpy as np
import pytest

from gandalf_tpu import params as jparams
from gandalf_tpu import units as junits
from gandalf_tpu.ops import tree as jtree
from gandalf_tpu.sim import ic as jic
from gandalf_tpu_torch import native, params, units
from gandalf_tpu_torch.check import mfv_params, sphere_block_params
from gandalf_tpu_torch.ops import tree as ttree
from gandalf_tpu_torch.sim import ic


def test_parameter_defaults_are_equal():
    mine, theirs = params.Parameters(), jparams.Parameters()
    for table in ("intparams", "floatparams", "stringparams"):
        assert getattr(mine, table) == getattr(theirs, table), table
    line = "Courant factor : courant_mult = 0.25"
    mine.parse_line(line)
    theirs.parse_line(line)
    assert mine.floatparams == theirs.floatparams


def test_units_scale_parameters_alike():
    """A dimensional run's unit set-up and input scaling."""
    out = []
    for P, U in ((params.Parameters, units), (jparams.Parameters, junits)):
        p = P()
        p.set("dimensionless", 0)
        p.set("rhofluid1", 2.5)
        u = U.SimUnits()
        u.setup_units(p)
        U.inscale_parameters(p, u)
        out.append((dict(p.floatparams), u.dimensionless))
    assert out[0] == out[1]


def _ics(p_mine, p_theirs):
    return ic.generate_ic(p_mine, None), jic.generate_ic(p_theirs, None)


@pytest.mark.parametrize("case", ["box", "sphere_lattice", "sphere_random"])
def test_generate_ic_is_identical(case):
    def make(P):
        if case == "box":
            p = mfv_params(6)
        else:
            p = sphere_block_params(700)
            if case == "sphere_random":
                p.set("particle_distribution", "random")
                p.set("rand_algorithm", "default")
        # the same settings in the JAX package's own table
        q = P()
        for table in ("intparams", "floatparams", "stringparams"):
            getattr(q, table).update(getattr(p, table))
        return q

    mine, theirs = _ics(make(params.Parameters), make(jparams.Parameters))
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert np.array_equal(mine[k], theirs[k]), k


def test_other_ics_raise():
    p = params.Parameters()
    p.set("ic", "sedov")
    with pytest.raises(NotImplementedError, match="item 9"):
        ic.generate_ic(p, None)


def test_xorshift_sphere_raises():
    p = sphere_block_params(700)
    p.set("particle_distribution", "random")
    p.set("rand_algorithm", "xorshift")
    with pytest.raises(NotImplementedError, match="item 9"):
        ic.generate_ic(p, None)


def test_copied_planner_gives_the_same_buckets():
    """kd_plan_buckets and the walk statistics from the port's library
    (built from gandalf_tpu_torch/native/kdplan.cpp) and the JAX
    package's."""
    assert native.library_path().parent.name == "_build"
    r = np.random.default_rng(11).random((5000, 3))
    gmap = ttree.plan_buckets_kd(r, 32)
    assert np.array_equal(gmap, jtree.plan_buckets_kd(r, 32))
    h = 0.02 + 0.01 * np.random.default_rng(12).random(5000)
    got = ttree.walk_stats_levels_native(r, gmap, 0.1, h=h, sample=1024)
    want = jtree.walk_stats_levels_native(r, gmap, 0.1, h=h, sample=1024)
    assert got[:3] == want[:3]
    assert np.array_equal(got[3], want[3])
