"""The port's copies of the JAX package's host modules agree with the
originals: the Parameters default table, the unit system, the IC
generators the port's configurations use (box, lattice and random
sphere; the xorshift generator's sphere sampler is not ported and
raises), the bit-exact xorshift generator and the N-body ICs drawn
through it, the N-body sub-system tree, and the C++ tree planner built
from the port's own kdplan.cpp."""

import numpy as np
import pytest

from gandalf_tpu import params as jparams
from gandalf_tpu import units as junits
from gandalf_tpu.ops import systemtree as jsys
from gandalf_tpu.ops import tree as jtree
from gandalf_tpu.sim import ic as jic
from gandalf_tpu.utils import rng as jrng
from gandalf_tpu_torch import native, params, units
from gandalf_tpu_torch.check import (mfv_params, nbody_params,
                                     sphere_block_params)
from gandalf_tpu_torch.ops import systemtree as tsys
from gandalf_tpu_torch.ops import tree as ttree
from gandalf_tpu_torch.sim import ic
from gandalf_tpu_torch.utils import rng as trng


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


def _ewald_ic_params(case):
    """The periodic self-gravity tests' ICs (EwaldIc.cpp): the Jeans box,
    the mass-weighted sine, the slab (open along z) and the cylinder
    (periodic along z only), on a 6^3 lattice in a box centred on the
    origin, adiabatic or isothermal."""
    from gandalf_tpu_torch.check import jeans_params

    p = jeans_params(6)
    ic, per = {"jeans": ("jeans", "xyz"), "ewaldsine": ("ewaldsine", "xyz"),
               "ewaldsine2": ("ewaldsine2", "xyz"),
               "ewaldslab": ("ewaldslab", "xy"),
               "ewaldcylinder_isothermal": ("ewaldcylinder", "z")}[case]
    p.set("ic", ic)
    if case.endswith("isothermal"):
        p.set("gas_eos", "isothermal")
    for k, axis in enumerate("xyz"):
        p.set(f"boxmin[{k}]", -0.5)
        p.set(f"boxmax[{k}]", 0.5)
        side = "periodic" if axis in per else "open"
        p.set(f"boundary_lhs[{k}]", side)
        p.set(f"boundary_rhs[{k}]", side)
    return p


@pytest.mark.parametrize("case", ["jeans", "ewaldsine", "ewaldsine2",
                                  "ewaldslab", "ewaldcylinder_isothermal"])
def test_ewald_ics_are_identical(case):
    def make(P):
        q = P()
        p = _ewald_ic_params(case)
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


@pytest.mark.parametrize("seed", [1, 12345, 2 ** 63 + 17])
def test_xorshift_is_bit_exact(seed):
    """10^4 draws of the port's XorshiftRand through each entry point
    (floatrand, fill, random, uniform) equal the JAX package's bit for
    bit, and the state word after them too."""
    mine, theirs = trng.XorshiftRand(seed), jrng.XorshiftRand(seed)
    got = np.concatenate([[mine.floatrand() for _ in range(1000)],
                          mine.fill(5000), mine.random((1000, 3)).ravel(),
                          mine.uniform(-2.0, 3.0, size=1000),
                          [mine.random() for _ in range(10)]])
    want = np.concatenate([[theirs.floatrand() for _ in range(1000)],
                           theirs.fill(5000),
                           theirs.random((1000, 3)).ravel(),
                           theirs.uniform(-2.0, 3.0, size=1000),
                           [theirs.random() for _ in range(10)]])
    assert len(got) == 10010
    assert np.array_equal(got, want)
    assert mine.x == int(theirs.x)


def _nbody_case(case):
    over = {"plummer": {},
            "plummer_2d": {"ndim": 2},
            "binary": {"ic": "binary", "ndim": 2, "ebin": 0.5},
            "triple": {"ic": "triple", "abin": 4.0, "ebin": 0.2,
                       "abin2": 0.5, "m3": 1.0},
            "quadruple": {"ic": "quadruple", "abin": 6.0, "ebin": 0.1,
                          "abin2": 0.5, "randseed": 9}}[case]
    p = nbody_params(500, **over)
    q = jparams.Parameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(q, table).update(getattr(p, table))
    return p, q


@pytest.mark.parametrize("case", ["plummer", "plummer_2d", "binary",
                                  "triple", "quadruple"])
def test_nbody_ics_are_identical(case):
    """plummer_stars_ic (500 stars, xorshift) and the binary, triple and
    quadruple ICs equal the JAX package's bit for bit."""
    p, q = _nbody_case(case)
    mine, theirs = ic.generate_nbody_ic(p), jic.generate_nbody_ic(q)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype
        assert np.array_equal(mine[k], theirs[k]), k


def test_other_nbody_ics_raise():
    with pytest.raises(NotImplementedError, match="item 9"):
        ic.generate_nbody_ic(nbody_params(8, ic="file"))


def test_systemtree_copy_finds_the_same_subsystems():
    """Three tight binaries and a triple planted in a 40-star cluster:
    the port's create_system_tree, build_subsystems and
    integrate_internal_motion give what the JAX package's give."""
    rng = np.random.default_rng(3)
    r = 3.0 * rng.standard_normal((40, 3))
    v = 0.3 * rng.standard_normal((40, 3))
    m = 0.5 + rng.random(40)
    for i, j in ((0, 1), (2, 3), (4, 5), (6, 7), (6, 8)):
        r[j] = r[i] + 1e-3 * rng.standard_normal(3)
    d = np.sqrt(((r[:, None] - r[None]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    gpot = (m[None, :] / d).sum(1)
    assert tsys.create_system_tree(r) == jsys.create_system_tree(r)
    mine = tsys.build_subsystems(r, v, m, gpot, gpefrac=0.05)
    theirs = jsys.build_subsystems(r, v, m, gpot, gpefrac=0.05)
    assert [s.members for s in mine] == [s.members for s in theirs]
    assert len(mine) >= 3
    for a, b in zip(mine, theirs):
        for f in ("r_com", "v_com", "m", "gpe_internal", "ketot", "tcross"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    idx = list(mine[0].members)
    # about one orbit of the tight pair
    args = (r[idx] - mine[0].r_com, v[idx] - mine[0].v_com, m[idx], 2e-4)
    kw = {"r_com": mine[0].r_com, "r_pert": r[20:], "m_pert": m[20:]}
    for x, y in zip(tsys.integrate_internal_motion(*args, **kw),
                    jsys.integrate_internal_motion(*args, **kw)):
        assert np.array_equal(x, y)
