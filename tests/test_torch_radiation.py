"""Port parity: the radiation modules of gandalf_tpu_torch on the CPU
against gandalf_tpu's, float64.

- ``ops/stellar.py``: the default table and stellar_nlyc;
- ``ops/eos.py``: IonisingRadiationEOS and MCRadiationEOS over every
  wrapped base EOS and fractional ionfrac;
- ``ops/treeray.py``: the plain K34 (cell_field) and K35 (column_density_map, treeray_ionisation with its
  shadowing clump) on tests/test_treeray.py's uniform grids;
- ``ops/mcrt.py``: the plain K36 (propagate_packets) on a 16^3 grid, open
  and periodic, and monochromatic_ionisation_mc with the JAX package's
  own draws;
- ``ops/ionisation.py``: the plain K37 (multi_source_ionisation) on
  tests/test_ionisation.py's single, coincident and overlapping sources,
  an inactive and a sub-Ndotmin source, and a source at the centre of a
  lattice sphere, whose shells of equal distance tie exactly.

Every field to 1e-12 relative to its largest value, every flag equal.
The host copies (healpix_directions, the stellar table, spitzer_ic) are
held bit for bit in tests/test_torch_copies.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gandalf_tpu.ops import eos as jeos
from gandalf_tpu.ops import ionisation as jion
from gandalf_tpu.ops import mcrt as jmc
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.ops import stellar as jst
from gandalf_tpu.ops import treeray as jtr
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.ic import add_lattice_sphere
from gandalf_tpu.state import OPEN, DomainBox
from gandalf_tpu_torch.convert import (grid_spec_from_jax,
                                       mc_draws_from_numpy,
                                       stellar_table_from_jax)
from gandalf_tpu_torch.ops import eos as teos
from gandalf_tpu_torch.ops import ionisation as tion
from gandalf_tpu_torch.ops import mcrt as tmc
from gandalf_tpu_torch.ops import sph_grid27 as tg
from gandalf_tpu_torch.ops import stellar as tst
from gandalf_tpu_torch.ops import treeray as ttr
from gandalf_tpu_torch.params import Parameters

torch.set_num_threads(1)

TOL = 1e-12


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _close(got, want, where=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, where
    scale = max(float(np.max(np.abs(want))), 1e-300)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= TOL, (where, err)


# ---------------------------------------------------------------------------
# stellar table, EOS wrappers
# ---------------------------------------------------------------------------

def test_stellar_nlyc():
    """The default table's N_LyC at masses across, between and beyond its
    rows."""
    jt = jst.default_stellar_table()
    tt = stellar_table_from_jax(jt)
    m = np.concatenate([np.random.default_rng(1).uniform(0.0, 130.0, 200),
                        jt.mass, [-1.0, 200.0]])
    _close(tst.stellar_nlyc(tt, _t(m)), jst.stellar_nlyc(jt, jnp.asarray(m)))


@pytest.mark.parametrize("scheme", ["ionisation", "monoionisation"])
@pytest.mark.parametrize("base", ["energy_eqn", "isothermal", "polytropic",
                                  "barotropic"])
def test_eos_wrappers(scheme, base):
    """The factory wraps each base EOS as the JAX package's does, and the
    wrapper's (u, P, c) agree with ionfrac None and fractional."""
    tp = Parameters()
    for k, v in dict(gas_eos=base, radiation=scheme, gamma_eos=5.0 / 3.0,
                     mu_bar=1.3, temp0=0.02, temp_ion=0.5, mu_ion=0.7,
                     Kpoly=0.8, eta_eos=1.4, rho_bary=0.5).items():
        tp.set(k, v)
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(tp, table))
    je, te = jeos.eos_factory(jp), teos.eos_factory(tp)
    assert type(te).__name__ == type(je).__name__
    assert te.needs_ionfrac
    rng = np.random.default_rng(2)
    rho, u = rng.uniform(0.1, 2.0, 50), rng.uniform(0.001, 2.0, 50)
    f = np.tile([0.0, 0.25, 0.5, 0.75, 1.0], 10)
    for frac in (None, f):
        kw_j = {} if frac is None else {"ionfrac": jnp.asarray(frac)}
        kw_t = {} if frac is None else {"ionfrac": _t(frac)}
        want = je.thermal_update(jnp.asarray(rho), jnp.asarray(u), **kw_j)
        got = te.thermal_update(_t(rho), _t(u), **kw_t)
        for g, w, name in zip(got, want, "upc"):
            _close(g, w, (scheme, base, name))


def test_apply_ionisation():
    cfg_j = jion.IonisationConfig(temp_ion=0.05, temp_neutral=1e-6,
                                  mu_ion=0.7, mu_bar=1.2)
    cfg_t = tion.IonisationConfig(**vars(cfg_j))
    rng = np.random.default_rng(3)
    ion = rng.random(64) < 0.5
    u = rng.uniform(0.0, 0.2, 64)
    want = jion.apply_ionisation(cfg_j, 2.0 / 3.0, jnp.asarray(ion),
                                 jnp.asarray(u))
    got = tion.apply_ionisation(cfg_t, 2.0 / 3.0, torch.as_tensor(ion),
                                _t(u))
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# treeray: HEALPix, K34, K35
# ---------------------------------------------------------------------------

def _jit(fn, *static):
    """fn jitted with its leading arguments `static` bound (one compile
    instead of many eager ones)."""
    return jax.jit(lambda *a: fn(*static, *a))


def _grids(r, h_max):
    """The JAX plan of tests/test_treeray.py's open box [-1, 1]^3, its
    binning, and the port's copy of both."""
    box = DomainBox(ndim=3, boxmin=(-1.0,) * 3, boxmax=(1.0,) * 3,
                    lhs=(OPEN,) * 3, rhs=(OPEN,) * 3)
    jspec = jg.plan_grid27(box, r, h_max, 2.0)
    tspec = grid_spec_from_jax(jspec)
    jb = jg.bin_particles(jspec, jnp.asarray(r))
    tb = tg.bin_particles(tspec, _t(r))
    np.testing.assert_array_equal(tb.cell_of.numpy(), np.asarray(jb.cell_of))
    return jspec, jb, tspec, tb


def _uniform(N=3000, seed=3):
    r = np.random.default_rng(seed).uniform(-1.0, 1.0, (N, 3))
    return r, np.full(N, 8.0 / N), np.ones(N)


def _clump():
    """tests/test_treeray.py's shadowing set-up: a uniform background and
    a 100x dense clump at x = 0.3."""
    rng = np.random.default_rng(5)
    r_bg = rng.uniform(-1.0, 1.0, (3000, 3))
    r_cl = np.array([0.3, 0.0, 0.0]) \
        + 0.1 * rng.standard_normal((1000, 3)) * 0.5
    r = np.concatenate([r_bg, r_cl])
    rho = np.concatenate([np.ones(3000), np.full(1000, 100.0)])
    m = np.concatenate([np.full(3000, 8.0 / 3000), np.full(1000, 1.0 / 1000)])
    return r, m, rho


def test_cell_field_and_columns():
    """The plain K34 per-cell fields and K35 columns: two targets along
    +x and +z (64 samples) and 300 particles along the 12 HEALPix
    directions of nside 1 (32 samples)."""
    r, m, rho = _uniform()
    rho[::7] = 1.5          # a non-uniform field
    jspec, jb, tspec, tb = _grids(r, 0.1)
    jrho, jnh2 = _jit(jtr.cell_field, jspec)(jb, jnp.asarray(m),
                                             jnp.asarray(rho), 1.3)
    trho, tnh2 = ttr.cell_field(tspec, tb, _t(m), _t(rho), 1.3)
    _close(trho, jrho, "rho")
    _close(tnh2, jnh2, "nh2")
    targets = np.array([[0.0, 0.0, 0.0], [-0.5, 0.0, 0.0]])
    dirs = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    _close(ttr.column_density_map(tspec, trho, _t(targets), dirs, 64),
           jax.jit(lambda f, x: jtr.column_density_map(jspec, f, x, dirs,
                                                       64))(
               jrho, jnp.asarray(targets)), "targets")
    hp = jtr.healpix_directions(1)
    _close(ttr.column_density_map(tspec, trho, _t(r[:300]), hp),
           jax.jit(lambda f, x: jtr.column_density_map(jspec, f, x, hp))(
               jrho, jnp.asarray(r[:300])), "healpix")


@pytest.mark.parametrize("case", ["uniform", "shadow"])
def test_treeray_ionisation(case):
    """The OnTheSpot flags with the plain K35: the uniform medium's front
    and the clump's shadow (tests/test_treeray.py:63-130), with a second,
    inactive source; the rays' integrals too."""
    if case == "uniform":
        r, m, rho = _uniform()
        h_max, d_front = 0.1, 0.45
    else:
        r, m, rho = _clump()
        h_max, d_front = 0.08, 0.9
    jspec, jb, tspec, tb = _grids(r, h_max)
    _, jnh2 = _jit(jtr.cell_field, jspec)(jb, jnp.asarray(m),
                                          jnp.asarray(rho))
    _, tnh2 = ttr.cell_field(tspec, tb, _t(m), _t(rho))
    src = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    ndot = np.array([4.0 * np.pi * d_front ** 3, 1.0])
    act = np.array([True, False])
    want = np.asarray(jax.jit(lambda *a: jtr.treeray_ionisation(
        jspec, *a, 1.0))(jnh2, jnp.asarray(r), jnp.asarray(src),
                         jnp.asarray(ndot), jnp.asarray(act)))
    got = ttr.treeray_ionisation(tspec, tnh2, _t(r), _t(src), _t(ndot),
                                 torch.as_tensor(act), 1.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    # the integrals themselves, along the rays toward the first source
    dr = -r
    d = np.sqrt((dr * dr).sum(-1))
    dirs = dr / np.maximum(d, 1e-30)[:, None]
    _close(ttr.march(tspec, tnh2, _t(r), _t(dirs[:, None]), _t(d[:, None]),
                     48),
           jax.jit(lambda *a: jtr._march(jspec, *a, 48))(
               jnh2, jnp.asarray(r), jnp.asarray(dirs[:, None]),
               jnp.asarray(d[:, None])))


# ---------------------------------------------------------------------------
# mcrt: K36 and the ionisation balance
# ---------------------------------------------------------------------------

def _mc_spec(periodic=False):
    return SimpleNamespace(ndim=3, lo=(-0.5,) * 3, extents=(1.0,) * 3,
                           ncells=(16, 16, 16), periodic=(periodic,) * 3)


@pytest.mark.parametrize("periodic", [False, True])
def test_propagate_packets(periodic):
    """The plain K36 on a random opacity field, 4,096 packets from two
    sources, 48 steps at half a cell."""
    spec = _mc_spec(periodic)
    rng = np.random.default_rng(7)
    op = rng.uniform(0.0, 30.0, spec.ncells)
    op[rng.random(spec.ncells) < 0.2] = 0.0      # transparent cells
    src = np.array([[0.0, 0.0, 0.0], [0.21, -0.13, 0.05]])
    r0 = src[rng.integers(0, 2, 4096)]
    dirs = np.asarray(jmc.isotropic_directions(jax.random.PRNGKey(3), 4096))
    want = jmc.propagate_packets(spec, jnp.asarray(op), jnp.asarray(r0),
                                 jnp.asarray(dirs), 48)
    got = tmc.propagate_packets(spec, _t(op), _t(r0), _t(dirs), 48)
    for g, w, name in zip(got, want, ("path", "absorbed", "escaped")):
        _close(g, w, name)


def test_monochromatic_ionisation_mc():
    """tests/test_mcrt.py's Stromgren sphere on a 16^3 grid (n_H 10,
    sigma 200, Rs 0.3) with 4,096 packets, 48 steps and 4 iterations,
    the port handed the JAX package's draws of each iteration."""
    spec = _mc_spec()
    nH = np.full(spec.ncells, 10.0)
    ndot = np.array([4.0 * np.pi / 3.0 * 100.0 * 0.3 ** 3])
    key = jax.random.PRNGKey(4)
    want = jmc.monochromatic_ionisation_mc(
        spec, jnp.asarray(nH), jnp.zeros((1, 3)), jnp.asarray(ndot), key,
        n_packets=4096, sigma=200.0, alphaB=1.0, n_steps=48, n_iter=4)
    draws = []
    for k in jax.random.split(key, 4):
        k1, k2 = jax.random.split(k)
        src = jax.random.choice(k1, 1, (4096,), p=jnp.asarray(ndot)
                                / jnp.maximum(jnp.sum(ndot), 1e-300))
        draws.append((np.asarray(src),
                      np.asarray(jmc.isotropic_directions(k2, 4096, 3))))
    got = tmc.monochromatic_ionisation_mc(
        spec, _t(nH), torch.zeros((1, 3), dtype=torch.float64), _t(ndot),
        mc_draws_from_numpy(draws), sigma=200.0, alphaB=1.0, n_steps=48)
    _close(got, want)
    x = got.numpy()
    assert x.min() < 0.5 < x.max()


def test_mc_draws_shapes():
    """The port's own draws: one (source, direction) set per iteration,
    sources in proportion to the luminosities, unit directions."""
    gen = torch.Generator().manual_seed(11)
    L = torch.tensor([3.0, 1.0], dtype=torch.float64)
    draws = list(tmc.mc_draws(gen, L, 20000, 3, 2))
    assert len(draws) == 2
    src, dirs = draws[0]
    assert abs(float((src == 0).double().mean()) - 0.75) < 0.02
    np.testing.assert_allclose(torch.linalg.norm(dirs, dim=1).numpy(), 1.0,
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# ionisation: K37
# ---------------------------------------------------------------------------

def _ion_case(case):
    rng = np.random.default_rng(5)
    cfg = dict(alphaB=1.0, mu_bar=1.0)
    if case == "lattice":
        r = add_lattice_sphere(2000, 1.0, 3)
        rho0 = 3.0 / (4.0 * np.pi)
        m = np.full(len(r), 1.0 / len(r))
        rho = np.full(len(r), rho0)
        return cfg, r, m, rho, np.zeros((1, 3)), \
            np.array([4.0 * np.pi / 3.0 * rho0 ** 2 * 0.35 ** 3]), \
            np.array([True])
    r = rng.uniform(-1.5, 1.5, (3000, 3))
    m = np.full(3000, 27.0 / 3000)
    rho = rng.uniform(0.8, 1.2, 3000)
    ndot = 4.0 * np.pi / 3.0 * 0.5 ** 3
    if case == "single":
        return cfg, r, m, rho, np.zeros((1, 3)), np.array([ndot]), \
            np.array([True])
    if case == "coincident":
        return cfg, r, m, rho, np.zeros((2, 3)), \
            np.array([ndot / 2, ndot / 2]), np.array([True, True])
    if case == "overlapping":
        return cfg, r, m, rho, np.array([[-0.3, 0.0, 0.0], [0.3, 0.0, 0.0]]),\
            np.array([ndot, ndot]), np.array([True, True])
    # an inactive source and one below Ndotmin beside an active one
    cfg["Ndotmin"] = 0.5 * ndot
    return cfg, r, m, rho, np.array([[-0.3, 0.0, 0.0], [0.3, 0.0, 0.0],
                                     [0.0, 0.4, 0.0]]), \
        np.array([ndot, ndot, 0.4 * ndot]), np.array([True, False, True])


@pytest.mark.parametrize("case", ["single", "coincident", "overlapping",
                                  "off_sources", "lattice"])
def test_multi_source_ionisation(case):
    cfg, r, m, rho, src, ndot, act = _ion_case(case)
    jc, tc = jion.IonisationConfig(**cfg), tion.IonisationConfig(**cfg)
    want = np.asarray(jion.multi_source_ionisation(
        jc, jnp.asarray(r), jnp.asarray(m), jnp.asarray(rho),
        jnp.asarray(src), jnp.asarray(ndot), jnp.asarray(act)))
    got = tion.multi_source_ionisation(
        tc, _t(r), _t(m), _t(rho), _t(src), _t(ndot),
        torch.as_tensor(act)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    if case in ("single", "lattice"):
        ind = tion.ionisation_fractions(tc, _t(r), _t(m), _t(rho), _t(src),
                                        _t(ndot), torch.as_tensor(act))
        np.testing.assert_array_equal(ind.numpy(), got)


# ---------------------------------------------------------------------------
# ionfrac through the active pass (the compacted block tick)
# ---------------------------------------------------------------------------

def test_active_pass_ionfrac():
    """The active-subset pass (plain K8, K9) hands a quarter of the
    particles' fractional ionfrac to MCRadiationEOS, as the JAX package's
    active_hydro_pass does (gandalf_tpu/ops/active_grid.py:122-123)."""
    import dataclasses

    from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
    from gandalf_tpu.ops import forces as jforces
    from gandalf_tpu.ops.active_grid import active_hydro_pass as jax_pass
    from gandalf_tpu.state import DomainBox as JaxBox
    from gandalf_tpu.state import make_sph_state as jax_state
    from gandalf_tpu_torch.check import jittered_box_ic, slice_params
    from gandalf_tpu_torch.ops.active_grid import active_hydro_pass
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    p = slice_params(6)
    p.set("Nlevels", 2)
    sim = GradhSphSimulation(p, device="cpu", dtype=torch.float64)
    sim.SetupSimulation(jittered_box_ic(p, 6))
    rng = np.random.default_rng(9)
    s = sim.state.replace(ionfrac=_t(rng.random(sim.state.N)))
    fields = {f.name: jnp.asarray(getattr(s, f.name).numpy())
              for f in dataclasses.fields(s) if getattr(s, f.name) is not None}
    js = dataclasses.replace(jax_state(*(np.asarray(fields[k]) for k in
                                         ("r", "v", "m", "h", "u"))),
                             **fields)
    box = sim.box
    jspec = jg.plan_grid27(JaxBox(box.ndim, box.boxmin, box.boxmax, box.lhs,
                                  box.rhs), s.r.numpy(),
                           float(s.h.max()) * 1.3, 2.0)
    v = sim.visc
    je = jeos.MCRadiationEOS(gamma=1.4, needs_ionfrac=True,
                             base=jeos.Adiabatic(gamma=1.4), temp_ion=2.0,
                             mu_ion=0.7)
    te = teos.MCRadiationEOS(gamma=1.4, base=teos.Adiabatic(gamma=1.4),
                             temp_ion=2.0, mu_ion=0.7)
    idx = np.sort(rng.choice(s.N, s.N // 4, replace=False)).astype(np.int32)
    jvisc = jforces.ArtificialViscosity(v.avisc, v.acond, v.alpha_visc,
                                        v.alpha_visc_min, v.beta_visc)
    js2, _ = jax.jit(lambda st, ids, mask: jax_pass(
        jax_kernel("m4", 3, 0), jvisc, jspec, je, sim.h_fac,
        sim.h_converge, st, ids, mask))(js, jnp.asarray(idx),
                                        jnp.ones(len(idx), bool))
    ts2, _ = active_hydro_pass(sim.kern, v, grid_spec_from_jax(jspec), te,
                               sim.h_fac, sim.h_converge, s,
                               torch.tensor(idx))
    for f in ("u", "pressure", "sound", "a", "dudt"):
        _close(getattr(ts2, f), getattr(js2, f), f)
    assert not np.allclose(ts2.u.numpy()[idx], s.u.numpy()[idx])
