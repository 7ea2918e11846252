"""Port parity: the radiation and radiative-feedback kernels' plain
versions at ndim 1 and 2 on the CPU against gandalf_tpu's functions,
float64.

- K30 (``ops/radiative_fb.py:combined_ambient_temperature``) with the
  sink sum alone and with disc heating about one or two central slots,
  and ``disc_ambient_t4``, whose midplane is the first min(2, ndim)
  components: the JAX function's ``r[:, :2]`` takes the one column of a
  1D position, where the port's plain version read a second column that
  a 1D position does not have;
- K34 (``cell_field``) and K35 (``_march`` through ``march`` and
  ``treeray_ionisation``) on a uniform disc and rod, open and periodic;
- K36 (``propagate_packets``) on a random opacity field, open and
  periodic, with the JAX package's isotropic draws in 1D and 2D;
- K37 (``multi_source_ionisation``) on one, two overlapping and three
  sources with an inactive one, and at the centre of a lattice disc and
  rod, whose shells of equal distance tie exactly (the rod's Ndot half a
  particle off a shell: at a shell the cumulative sum meets Ndot to the
  last bit, and the flag there is rounding).

Every field within 1e-12 of its largest value, every flag equal.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gandalf_tpu.ops import ionisation as jion
from gandalf_tpu.ops import mcrt as jmc
from gandalf_tpu.ops import radiative_fb as jfb
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.ops import treeray as jtr
from gandalf_tpu.sim.ic import add_lattice_sphere
from gandalf_tpu.state import OPEN, PERIODIC, DomainBox
from gandalf_tpu_torch.convert import grid_spec_from_jax
from gandalf_tpu_torch.ops import ionisation as tion
from gandalf_tpu_torch.ops import mcrt as tmc
from gandalf_tpu_torch.ops import radiative_fb as tfb
from gandalf_tpu_torch.ops import sph_grid27 as tg
from gandalf_tpu_torch.ops import treeray as ttr

torch.set_num_threads(1)

TOL = 1e-12
DIMS = [1, 2]


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
# K30: the ambient temperature
# ---------------------------------------------------------------------------

MJ = 9.546e-4
CFG = dict(rad_const=2.0, temp_inf=5.0, f_acc=0.75, lsun=1.0, msun=1.0,
           mjup=MJ, r_planet=0.002, r_bdwarf=0.005, r_star=0.01)


def _slots(ndim, n=400, ns=12, seed=3):
    """Particles in the unit box and slots of all three mass classes,
    the last two inactive; particle 0 on slot 1 (d = 0)."""
    rng = np.random.default_rng(seed)
    r = rng.random((n, ndim))
    rs = rng.random((ns, ndim))
    m = np.array([5.0 * MJ, 40.0 * MJ, 0.25])[np.arange(ns) % 3]
    mdot = 10.0 ** rng.uniform(-4.0, 0.0, ns)
    rad = np.full(ns, 0.02)
    active = np.arange(ns) < ns - 2
    r[0] = rs[1]
    return r, rs, m, mdot, rad, active


@pytest.mark.parametrize("ndim", DIMS)
@pytest.mark.parametrize("n_central", [0, 1, 2])
def test_ambient_temperature_dims(ndim, n_central):
    """The plain K30 against combined_ambient_temperature (and
    ambient_temperature without a disc) at ndim 1 and 2."""
    r, rs, m, mdot, rad, active = _slots(ndim)
    disc = dict(temp_au=250.0, temp_q=0.75, rsmooth=0.01,
                n_central=n_central) if n_central else None
    got = tfb.combined_ambient_temperature(
        tfb.SinkHeatingConfig(**CFG),
        None if disc is None else tfb.DiscHeatingConfig(**disc), _t(r),
        _t(rs), _t(m), _t(mdot), _t(rad), torch.tensor(active))
    want = jfb.combined_ambient_temperature(
        jfb.SinkHeatingConfig(**CFG),
        None if disc is None else jfb.DiscHeatingConfig(**disc),
        jnp.asarray(r), jnp.asarray(rs), jnp.asarray(m), jnp.asarray(mdot),
        jnp.asarray(rad), jnp.asarray(active))
    _close(got, want, "T_amb")
    if disc is None:
        _close(got, jfb.ambient_temperature(
            jfb.SinkHeatingConfig(**CFG), jnp.asarray(r), jnp.asarray(rs),
            jnp.asarray(m), jnp.asarray(mdot), jnp.asarray(rad),
            jnp.asarray(active)), "sinks alone")


@pytest.mark.parametrize("ndim", DIMS)
def test_disc_term_below_3d(ndim):
    """The repaired disc term: its midplane is min(2, ndim) components.
    In 1D the port's plain version took a second column that r does not
    have and raised; the JAX function's r[:, :2] takes the one there is."""
    r, rs, _, _, _, active = _slots(ndim)
    for nc in (1, 2):
        cfg = dict(temp_au=250.0, temp_q=0.75, rsmooth=0.01, n_central=nc)
        got = tfb.disc_ambient_t4(tfb.DiscHeatingConfig(**cfg), _t(r),
                                  _t(rs), torch.tensor(active))
        want = jfb.disc_ambient_t4(jfb.DiscHeatingConfig(**cfg),
                                   jnp.asarray(r), jnp.asarray(rs),
                                   jnp.asarray(active))
        _close(got, want, f"n_central {nc}")
        assert np.all(np.isfinite(got.numpy()))


# ---------------------------------------------------------------------------
# K34, K35: per-cell fields and the ray march
# ---------------------------------------------------------------------------

def _grids(ndim, r, h_max, periodic=False):
    """The JAX plan of [-1, 1]^ndim (open or periodic), its binning, and
    the port's copy of both."""
    bc = PERIODIC if periodic else OPEN
    box = DomainBox(ndim=ndim, boxmin=(-1.0,) * ndim, boxmax=(1.0,) * ndim,
                    lhs=(bc,) * ndim, rhs=(bc,) * ndim)
    jspec = jg.plan_grid27(box, r, h_max, 2.0)
    tspec = grid_spec_from_jax(jspec)
    jb = jg.bin_particles(jspec, jnp.asarray(r))
    tb = tg.bin_particles(tspec, _t(r))
    np.testing.assert_array_equal(tb.cell_of.numpy(), np.asarray(jb.cell_of))
    return jspec, jb, tspec, tb


def _uniform(ndim, n, seed=3):
    rng = np.random.default_rng(seed)
    r = rng.uniform(-1.0, 1.0, (n, ndim))
    rho = np.ones(n)
    rho[::7] = 1.5                    # a non-uniform field
    return r, np.full(n, 2.0 ** ndim / n), rho


@pytest.mark.parametrize("ndim", DIMS)
@pytest.mark.parametrize("periodic", [False, True])
def test_cell_field_and_march_dims(ndim, periodic):
    """The plain K34's per-cell rho and n_H^2 and the plain K35's
    integrals along the rays from every particle toward a source (48
    samples), then treeray_ionisation's flags with a second, inactive
    source."""
    n = {1: 300, 2: 1500}[ndim]
    r, m, rho = _uniform(ndim, n)
    jspec, jb, tspec, tb = _grids(ndim, r, {1: 0.02, 2: 0.1}[ndim],
                                  periodic)
    jrho, jnh2 = jax.jit(lambda *a: jtr.cell_field(jspec, *a))(
        jb, jnp.asarray(m), jnp.asarray(rho), 1.3)
    trho, tnh2 = ttr.cell_field(tspec, tb, _t(m), _t(rho), 1.3)
    _close(trho, jrho, "rho")
    _close(tnh2, jnh2, "nh2")
    src = np.zeros((1, ndim))
    src[0, 0] = 0.1
    dr = src - r
    d = np.sqrt((dr * dr).sum(-1))
    dirs = dr / np.maximum(d, 1e-30)[:, None]
    _close(ttr.march(tspec, tnh2, _t(r), _t(dirs[:, None]), _t(d[:, None]),
                     48),
           jax.jit(lambda *a: jtr._march(jspec, *a, 48))(
               jnh2, jnp.asarray(r), jnp.asarray(dirs[:, None]),
               jnp.asarray(d[:, None])), "march")
    srcs = np.concatenate([src, np.full((1, ndim), 0.5)])
    ndot = np.array([4.0 * np.pi * 0.4 ** 3, 1.0])
    act = np.array([True, False])
    want = np.asarray(jax.jit(lambda *a: jtr.treeray_ionisation(
        jspec, *a, 1.0))(jnh2, jnp.asarray(r), jnp.asarray(srcs),
                         jnp.asarray(ndot), jnp.asarray(act)))
    got = ttr.treeray_ionisation(tspec, tnh2, _t(r), _t(srcs), _t(ndot),
                                 torch.as_tensor(act), 1.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


# ---------------------------------------------------------------------------
# K36: the packet march
# ---------------------------------------------------------------------------

def _mc_spec(ndim, periodic):
    cells = {1: (64,), 2: (24, 24)}[ndim]
    return SimpleNamespace(ndim=ndim, lo=(-0.5,) * ndim,
                           extents=(1.0,) * ndim, ncells=cells,
                           periodic=(periodic,) * ndim)


@pytest.mark.parametrize("ndim", DIMS)
@pytest.mark.parametrize("periodic", [False, True])
def test_propagate_packets_dims(ndim, periodic):
    """The plain K36 on a random opacity field with transparent cells,
    2,048 packets from two sources along the JAX package's isotropic
    directions in ndim, 48 steps at half a cell."""
    spec = _mc_spec(ndim, periodic)
    rng = np.random.default_rng(7)
    op = rng.uniform(0.0, 30.0, spec.ncells)
    op[rng.random(spec.ncells) < 0.2] = 0.0
    src = np.array([[0.0] * ndim, [0.21, -0.13][:ndim]])
    r0 = src[rng.integers(0, 2, 2048)]
    dirs = np.asarray(jmc.isotropic_directions(jax.random.PRNGKey(3), 2048,
                                               ndim))
    want = jmc.propagate_packets(spec, jnp.asarray(op), jnp.asarray(r0),
                                 jnp.asarray(dirs), 48)
    got = tmc.propagate_packets(spec, _t(op), _t(r0), _t(dirs), 48)
    for g, w, name in zip(got, want, ("path", "absorbed", "escaped")):
        _close(g, w, name)


# ---------------------------------------------------------------------------
# K37: the Stromgren prefixes
# ---------------------------------------------------------------------------

def _ion_case(ndim, case):
    if case == "lattice":
        r = add_lattice_sphere({1: 400, 2: 1200}[ndim], 1.0, ndim)
        rho0 = {1: 0.5, 2: 1.0 / np.pi}[ndim]
        m = np.full(len(r), 1.0 / len(r))
        # in 1D every particle adds the same rec, so at Rs = 0.35 the
        # cumulative sum meets Ndot at a particle to the last bit, where
        # the two packages' sums round apart (numpy: Ndot + 1.4e-16);
        # Rs = 0.35125 puts Ndot half a particle beyond it
        ndot = {1: 2.0 * 0.35125, 2: np.pi * 0.35 ** 2}[ndim] * rho0 ** 2
        return (r, m, np.full(len(r), rho0), np.zeros((1, ndim)),
                np.array([ndot]), np.array([True]), {})
    rng = np.random.default_rng(5)
    n = {1: 600, 2: 2000}[ndim]
    r = rng.uniform(-1.5, 1.5, (n, ndim))
    m = np.full(n, 3.0 ** ndim / n)
    rho = rng.uniform(0.8, 1.2, n)
    ndot = {1: 1.0, 2: np.pi * 0.5 ** 2}[ndim]
    pos = np.array([[-0.3, 0.0], [0.3, 0.0], [0.0, 0.4]])[:, :ndim]
    if case == "single":
        return r, m, rho, pos[:1], np.array([ndot]), np.array([True]), {}
    if case == "overlapping":
        return r, m, rho, pos[:2], np.array([ndot, ndot]), \
            np.array([True, True]), {}
    return r, m, rho, pos, np.array([ndot, ndot, 0.4 * ndot]), \
        np.array([True, False, True]), {"Ndotmin": 0.5 * ndot}


@pytest.mark.parametrize("ndim", DIMS)
@pytest.mark.parametrize("case", ["single", "overlapping", "off_sources",
                                  "lattice"])
def test_multi_source_ionisation_dims(ndim, case):
    """The plain K37's flags equal the JAX package's."""
    r, m, rho, src, ndot, act, over = _ion_case(ndim, case)
    cfg = dict(alphaB=1.0, mu_bar=1.0, **over)
    jc, tc = jion.IonisationConfig(**cfg), tion.IonisationConfig(**cfg)
    want = np.asarray(jion.multi_source_ionisation(
        jc, jnp.asarray(r), jnp.asarray(m), jnp.asarray(rho),
        jnp.asarray(src), jnp.asarray(ndot), jnp.asarray(act)))
    got = tion.multi_source_ionisation(
        tc, _t(r), _t(m), _t(rho), _t(src), _t(ndot),
        torch.as_tensor(act)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
