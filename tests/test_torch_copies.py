"""The port's copies of the JAX package's host modules agree with the
originals: the Parameters default table, the unit system, the IC
generators the port's configurations use (box, lattice and random
sphere; the xorshift generator's sphere sampler is not ported and
raises; the Boss-Bodenheimer cloud and the hybrid Plummer sphere; the
binaryacc stream with its stars in 2D and 3D; the dusty box and the
Evrard cloud with its dust), the
isothermal, barotropic and polytropic EOS, the RadWS constant and
synthetic opacity table, the bit-exact xorshift
generator and the N-body ICs drawn through it, the N-body sub-system
tree, the C++ tree planner built from the port's own kdplan.cpp, and the
radiation's host copies (the Spitzer sphere, the HEALPix directions, the
stellar table), and the snapshot I/O and diagnostics modules."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from gandalf_tpu import params as jparams
from gandalf_tpu import units as junits
from gandalf_tpu.ops import systemtree as jsys
from gandalf_tpu.ops import tree as jtree
from gandalf_tpu.sim import ic as jic
from gandalf_tpu.utils import rng as jrng
from gandalf_tpu_torch import native, params, units
from gandalf_tpu_torch.check import (binaryacc_params, mfv_params,
                                     nbody_params, sphere_block_params)
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


def _sink_ic_params(case):
    """The sink slice's ICs at a small size: the Boss-Bodenheimer cloud
    (examples/bossbodenheimer.dat, physical units) on its lattice and
    drawn at random, and the hybrid gas-and-star Plummer sphere with the
    default (numpy) and the xorshift generator."""
    from gandalf_tpu_torch.check import bb_params

    if case.startswith("bb"):
        p = bb_params(600)
        if case == "bb_random":
            p.set("particle_distribution", "random")
            p.set("rand_algorithm", "default")
        return p
    p = params.Parameters()
    for k, v in dict(ic="plummer", ndim=3, Nhydro=300, Nstar=12,
                     gasfrac=0.7, starfrac=0.3, dimensionless=1).items():
        p.set(k, v)
    if case == "plummer_xorshift":
        p.set("rand_algorithm", "xorshift")
    return p


@pytest.mark.parametrize("case", ["bb_lattice", "bb_random",
                                  "plummer_default", "plummer_xorshift"])
def test_sink_ics_are_identical(case):
    """bossbodenheimer_ic and plummer_hybrid_ic (with its stars) equal the
    JAX package's bit for bit."""
    p = _sink_ic_params(case)
    q = jparams.Parameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(q, table).update(getattr(p, table))
    mine, theirs = _ics(p, q)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        if k == "star":
            assert sorted(mine[k]) == sorted(theirs[k])
            for f in mine[k]:
                assert np.array_equal(mine[k][f], theirs[k][f]), f
        else:
            assert np.array_equal(mine[k], theirs[k]), k


@pytest.mark.parametrize("ndim", [2, 3])
def test_binaryacc_ic_is_identical(ndim):
    """binaryacc_ic (two lattices split along x, a binary of 0.4 and 0.6
    moving at Mach 1, tests/test_ic_longtail.py:57-64's values) equals
    the JAX package's bit for bit, its stars included."""
    p = binaryacc_params(8, ndim=ndim)
    q = jparams.Parameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(q, table).update(getattr(p, table))
    mine, theirs = _ics(p, q)
    assert sorted(mine) == sorted(theirs)
    assert mine["r"].shape == (2 * 8 * 16 ** (ndim - 1), ndim)
    for k in mine:
        if k == "star":
            assert sorted(mine[k]) == sorted(theirs[k])
            for f in mine[k]:
                assert np.array_equal(mine[k][f], theirs[k][f]), f
        else:
            assert np.array_equal(mine[k], theirs[k]), k


@pytest.mark.parametrize("name", ["isothermal", "barotropic", "polytropic"])
def test_eos_classes_are_identical(name):
    """The isothermal, barotropic and polytropic EOS from each package's
    eos_factory: the same class and fields bit for bit, and u, pressure
    and sound speed of thermal_update over densities either side of
    rho_bary the same formula term by term: equal where no power is
    taken, within 2e-15 relative where one is (torch's and XLA's
    x ** y differ in the last bits for about 1.6% of arguments; the
    barotropic u reads up to 4 ulp apart after its sum and divisions)."""
    import jax.numpy as jnp
    import torch

    from gandalf_tpu.ops import eos as jeos
    from gandalf_tpu_torch.ops import eos as teos

    p = params.Parameters()
    for k, v in dict(gas_eos=name, gamma_eos=5.0 / 3.0, mu_bar=2.35,
                     temp0=10.0, rho_bary=1.0e-2, Kpoly=0.7,
                     eta_eos=1.4).items():
        p.set(k, v)
    q = jparams.Parameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(q, table).update(getattr(p, table))
    mine, theirs = teos.eos_factory(p), jeos.eos_factory(q)
    assert type(mine).__name__ == type(theirs).__name__
    fields = dataclasses.asdict(theirs)
    fields.pop("needs_ionfrac")
    assert dataclasses.asdict(mine) == fields
    rng = np.random.default_rng(7)
    rho = 10.0 ** rng.uniform(-5.0, 1.0, 500)
    u = rng.random(500) + 0.1
    got = mine.thermal_update(torch.tensor(rho), torch.tensor(u))
    want = theirs.thermal_update(jnp.asarray(rho), jnp.asarray(u))
    for tag, x, y in zip(("u", "pressure", "sound"), got, want):
        x, y = x.numpy(), np.asarray(y)
        if name == "isothermal":
            assert np.array_equal(x, y), tag
        else:
            assert np.all(np.abs(x - y) <= 2e-15 * np.abs(y)), tag


@pytest.mark.parametrize("kw", [{}, dict(ndens=5, ntemp=33, gamma=1.4,
                                         mu_bar=2.35, kappa0=0.3,
                                         rad_const=7.0, temp_ambient=20.0,
                                         temp_min=2.0, fcol=0.5,
                                         logrho_range=(-3.0, 1.0),
                                         logtemp_range=(0.5, 4.0))])
def test_radws_ideal_table_is_identical(kw):
    """RAD_CONST_CGS and make_ideal_table (the defaults, and every
    argument set) equal the JAX package's bit for bit."""
    from gandalf_tpu.ops import radws as jrw
    from gandalf_tpu_torch.ops import radws as trw

    assert trw.RAD_CONST_CGS == jrw.RAD_CONST_CGS
    mine, theirs = trw.make_ideal_table(**kw), jrw.make_ideal_table(**kw)
    for k in trw.OpacityTable.ARRAYS:
        assert np.array_equal(getattr(mine, k).numpy(),
                              np.asarray(getattr(theirs, k))), k
    for k in ("fcol2", "rad_const", "temp_min", "temp_ambient"):
        assert getattr(mine, k) == float(getattr(theirs, k)), k


def _hydro_test_ic_params(case):
    """The hydro tests' ICs at a small size: the Sod tube, the contact
    discontinuity (its velocities set and its pressures equalised by the
    generator) and the sound wave (1D), the KHI (2D), the Sedov blast (2D lattice, smoothed and
    not, with some kinetic energy) and the Noh implosion (3D)."""
    from gandalf_tpu_torch.check import khi_params, sod_params

    if case == "shocktube":
        return sod_params(64, 16)
    if case == "cdiscontinuity":
        p = sod_params(32, 64)
        p.set("ic", "cdiscontinuity")
        p.set("rhofluid2", 4.0)
        return p
    if case == "khi":
        return khi_params(1)
    p = params.Parameters()
    ndim = {"soundwave": 1, "sedov_smooth": 2, "sedov": 2, "noh": 3}[case]
    base = dict(ic=case.split("_")[0], ndim=ndim, dimensionless=1,
                gamma_eos=1.4, rhofluid1=1.0, press1=1.0, amp=0.05,
                kefrac=0.3, smooth_ic=int(case == "sedov_smooth"))
    for k, v in base.items():
        p.set(k, v)
    for k in range(ndim):
        p.set(f"Nlattice1[{k}]", 24 if ndim < 3 else 8)
        p.set(f"boxmin[{k}]", -1.0)
        p.set(f"boxmax[{k}]", 1.0)
    return p


@pytest.mark.parametrize("case", ["shocktube", "cdiscontinuity",
                                  "soundwave", "khi", "sedov",
                                  "sedov_smooth", "noh"])
def test_hydro_test_ics_are_identical(case):
    """shocktube_ic, cdiscontinuity_ic, soundwave_ic, khi_ic, sedov_ic
    (with the port's own M4 kernel for the smoothed injection) and noh_ic
    equal the JAX package's bit for bit."""
    p = _hydro_test_ic_params(case)
    q = jparams.Parameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(q, table).update(getattr(p, table))
    mine, theirs = _ics(p, q)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert np.array_equal(mine[k], theirs[k]), k


@pytest.mark.parametrize("case", ["dustybox_1d", "dustybox_3d",
                                  "evrard_dust", "evrard_gas"])
def test_dust_ics_are_identical(case):
    """dustybox_ic and evrard_ic (with and without its dust copy) equal
    the JAX package's bit for bit, ptype included."""
    from gandalf_tpu_torch.check import dust_params, dustybox_params

    if case.startswith("dustybox"):
        p = dustybox_params(8 if case.endswith("3d") else 32,
                            3 if case.endswith("3d") else 1,
                            dust_mass_factor=0.25)
    else:
        p = dust_params(500, "full_twofluid" if case == "evrard_dust"
                        else "none")
    q = jparams.Parameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(q, table).update(getattr(p, table))
    mine, theirs = _ics(p, q)
    assert sorted(mine) == sorted(theirs)
    assert ("ptype" in mine) == (case != "evrard_gas")
    for k in mine:
        assert np.array_equal(mine[k], theirs[k]), k


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5])
def test_riemann_copy_is_identical(t):
    """analysis/riemann.py's shocktube solution equals the JAX package's
    (both numpy) bit for bit, for the Sod tube and a two-shock case."""
    from gandalf_tpu.analysis import riemann as jr
    from gandalf_tpu_torch.analysis import riemann as tr

    for case in ((1.0, 0.0, 1.0, 0.25, 0.0, 0.1975, 1.4),
                 (1.0, 2.0, 0.4, 1.0, -2.0, 0.4, 5.0 / 3.0)):
        mine = tr.shocktube_solution(*case, -1.0, 0.0, 1.0, t, n=4096)
        theirs = jr.shocktube_solution(*case, -1.0, 0.0, 1.0, t, n=4096)
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            assert np.array_equal(mine[k], theirs[k]), k
    assert tr.star_region(1.0, 0.0, 1.0, 0.125, 0.0, 0.1, 1.4) \
        == jr.star_region(1.0, 0.0, 1.0, 0.125, 0.0, 0.1, 1.4)


def test_spitzer_ic_is_identical():
    """spitzer_ic equals the JAX package's bit for bit."""
    from gandalf_tpu_torch.check import spitzer_params

    p = spitzer_params(800)
    q = jparams.Parameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(q, table).update(getattr(p, table))
    mine, theirs = _ics(p, q)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert np.array_equal(mine[k], theirs[k]), k


@pytest.mark.parametrize("n, ndim", [(300, 1), (4096, 1), (300, 2),
                                     (20000, 2), (800, 3), (20000, 3)])
def test_lattice_sphere_is_identical(n, ndim):
    """add_lattice_sphere (which stops its search once the count has
    passed the target) equals the JAX package's, which tries every
    resolution."""
    assert np.array_equal(ic.add_lattice_sphere(n, 1.0, ndim),
                          jic.add_lattice_sphere(n, 1.0, ndim))


@pytest.mark.parametrize("nside", [1, 2, 4, 8])
def test_healpix_copy_is_identical(nside):
    """ops/treeray.py's HEALPix directions (host numpy) equal the JAX
    package's bit for bit."""
    from gandalf_tpu.ops.treeray import healpix_directions as theirs
    from gandalf_tpu_torch.ops.treeray import healpix_directions as mine

    assert np.array_equal(mine(nside), theirs(nside))


def test_stellar_table_copy_is_identical(tmp_path):
    """The built-in stellar table (scaled to a mass unit) and a
    stellar.dat file read by both packages."""
    from gandalf_tpu.ops import stellar as jst
    from gandalf_tpu_torch.ops import stellar as tst

    path = tmp_path / "stellar.dat"
    rows = np.column_stack([np.linspace(1.0, 90.0, 7), np.arange(7) * 0.5,
                            np.linspace(40.0, 49.0, 7), np.full(7, 3e4),
                            np.zeros(7), np.full(7, 1e3)])
    path.write_text("7\n" + "header\n" * 4 + "\n".join(
        " ".join(f"{x:.6g}" for x in row) for row in rows) + "\n")
    for mine, theirs in ((tst.default_stellar_table(2.0),
                          jst.default_stellar_table(2.0)),
                         (tst.load_stellar_table(str(path), 0.5),
                          jst.load_stellar_table(str(path), 0.5))):
        for f in dataclasses.fields(theirs):
            assert np.array_equal(getattr(mine, f.name),
                                  getattr(theirs, f.name)), f.name


@pytest.mark.parametrize("path", ["sim/io.py", "utils/diagnostics.py"])
def test_io_and_diagnostics_copies_are_identical(path):
    """The snapshot I/O and the diagnostics are host numpy: the port's
    files hold the JAX package's code statement for statement, their
    module docstrings aside (tests/test_torch_io.py runs them)."""
    root = Path(__file__).resolve().parents[1]

    def body(pkg):
        tree = ast.parse((root / pkg / path).read_text())
        return [ast.dump(node) for node in tree.body[1:]]

    assert body("gandalf_tpu_torch") == body("gandalf_tpu")


def test_other_ics_raise():
    p = params.Parameters()
    p.set("ic", "rti")
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
