"""Port parity of the Ewald sum (gandalf_tpu_torch/ops/ewald.py and the
Ewald modes of the tree walk, K6 and K7) against gandalf_tpu/ops/ewald.py
and gandalf_tpu/ops/tree.py, float64 on the CPU.

The port's copy of the host table builder gives the JAX package's
tables exactly, for a fully periodic box, a slab (one open axis) and a
cylinder (two); the plain ewald_correction matches on random min-image
vectors, past the table along open axes and at components of exactly
0; the plain K6 and K7 in Ewald mode match tree_gravity_grouped with the
same table at 2,048 particles (tests/test_ewald.py:269-326), in both
zeta modes, at the opening angle of the slices (where nothing is far at
this size) and at theta^2 = 1 (where the walk accepts cells through the
seam); and ewald_pair_gravity's twin matches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import ewald as je
from gandalf_tpu.ops import tree as jt
from gandalf_tpu.state import OPEN as JOPEN
from gandalf_tpu.state import PERIODIC as JPERIODIC
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu_torch.convert import ewald_table_from_jax, tree_spec_from_jax
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import ewald as te
from gandalf_tpu_torch.ops import tree as tt
from gandalf_tpu_torch.state import OPEN, PERIODIC, DomainBox

torch.set_num_threads(1)

TOL = 1e-10
# a fully periodic box, a slab open along z, a cylinder periodic along z
PERIODICITY = {"periodic": (True, True, True), "slab": (True, True, False),
               "cylinder": (False, False, True)}
NGRID = 9


@pytest.fixture(scope="module", params=list(PERIODICITY))
def tables(request):
    per = PERIODICITY[request.param]
    return (request.param, per,
            te.build_ewald_table([1.0] * 3, ngrid=NGRID, periodic=per),
            je.build_ewald_table([1.0] * 3, ngrid=NGRID, periodic=per))


def test_table_copy_equals_jax(tables):
    """The port's builder reproduces every array and every piece of
    metadata of the JAX package's table, bit for bit."""
    _, _, mine, theirs = tables
    for f in ("pot", "acc", "inv_dgrid", "nmax"):
        assert np.array_equal(getattr(mine, f), np.asarray(getattr(theirs,
                                                                   f))), f
    for f in ("far_kind", "open_axes", "per_axes", "L_per", "area",
              "pot_const", "far_thresh"):
        assert getattr(mine, f) == getattr(theirs, f), f
    # the conversion used by the tests carries the same table across
    conv = ewald_table_from_jax(theirs)
    assert np.array_equal(conv.acc, mine.acc)
    assert conv.far_thresh == mine.far_thresh


def test_correction_matches_jax(tables):
    """ewald_correction on random min-image vectors: periodic components
    in [-L/2, L/2], open ones out to 3 L (past the table, where the
    sheet or line far field takes over), with some components exactly 0
    (the sign is 0 there) and the zero vector."""
    name, per, mine, theirs = tables
    rng = np.random.default_rng(7)
    dr = rng.uniform(-0.5, 0.5, (4000, 3))
    for k in range(3):
        if not per[k]:
            dr[:, k] = rng.uniform(-3.0, 3.0, 4000)
    dr[::7, 0] = 0.0
    dr[::11, 2] = 0.0
    dr[0] = 0.0
    a_t, p_t = te.ewald_correction(mine, torch.tensor(dr))
    a_j, p_j = je.ewald_correction(theirs, jnp.asarray(dr))
    a_j, p_j = np.asarray(a_j), np.asarray(p_j)
    assert np.max(np.abs(a_t.numpy() - a_j)) <= 1e-13 * np.max(np.abs(a_j))
    assert np.max(np.abs(p_t.numpy() - p_j)) <= 1e-13 * np.max(np.abs(p_j))
    # sign symmetry: a zero component gets no correction along it
    assert not a_t.numpy()[::7, 0].any()
    if name != "periodic":
        # some vectors lie past the table along an open axis
        thresh = [mine.far_thresh[k] for k in mine.open_axes]
        past = np.zeros(len(dr), bool)
        for k, t in zip(mine.open_axes, thresh):
            past |= np.abs(dr[:, k]) > t
        assert past.any() and (~past).any()


def _inputs(per, seed=9, N=2048):
    """tests/test_ewald.py's 2,048 random particles in a unit box, with
    smoothing lengths of order the mean spacing (so some pairs are
    softened) and zeta*hfactor terms."""
    rng = np.random.default_rng(seed)
    r = rng.random((N, 3))
    m = np.full(N, 1.0 / N)
    h = 0.06 * (1.0 + 0.2 * rng.random(N))
    zh = -0.5 * rng.random(N) / h ** 4
    pext = [1.0 if p else 0.0 for p in per]
    return r, m, h, zh, pext


CASES = {
    # (periodicity, zeta scaling, theta^2)
    "periodic_sph_slice_theta": ("periodic", "sph", 0.1),
    "periodic_sph": ("periodic", "sph", 1.0),
    "periodic_mfv": ("periodic", "mfv", 1.0),
    "slab_sph": ("slab", "sph", 1.0),
    "cylinder_mfv": ("cylinder", "mfv", 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ewald_walk_matches_jax(case):
    """tree_gravity_grouped with the Ewald table: the port's plain K4-K7
    against the JAX package's walk on the same gather map, TreeSpec and
    table (caps wide enough for any walk)."""
    kind, zeta, theta_sqd = CASES[case]
    per = PERIODICITY[kind]
    r, m, h, zh, pext = _inputs(per)
    gmap = jt.plan_buckets_kd(r, 32)
    G = gmap.shape[0]
    jspec = jt.plan_tree_for_buckets(gmap, theta_sqd, near_cap=G,
                                     frontier=2 * G)
    spec = tree_spec_from_jax(jspec)
    jtab = je.build_ewald_table([1.0] * 3, ngrid=NGRID, periodic=per)
    tab = te.build_ewald_table([1.0] * 3, ngrid=NGRID, periodic=per)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    a, gpot, ovf = tt.tree_gravity_grouped(
        spec, t(gmap), t(r), t(m), t(h), kernel_factory("m4", 3), t(zh),
        pext, zeta_scaling=zeta, ewald_table=tab)
    ja, jg, jovf = jt.tree_gravity_grouped(
        jspec, jnp.asarray(gmap), jnp.asarray(r), jnp.asarray(m),
        jnp.asarray(h), jax_kernel("m4", 3), zh=jnp.asarray(zh),
        periodic_extent=pext, zeta_scaling=zeta, ewald_table=jtab)
    assert bool(ovf) == bool(jovf) is False
    ja, jg = np.asarray(ja), np.asarray(jg)
    assert np.max(np.abs(a.numpy() - ja)) <= TOL * np.max(np.abs(ja))
    assert np.max(np.abs(gpot.numpy() - jg)) <= TOL * np.max(np.abs(jg))
    # the wide opening angle accepts cells: the far field is exercised
    if theta_sqd > 0.5:
        ptab, alive = tt.gather_to_buckets(spec, t(gmap), t(r), t(m),
                                           t(h), t(zh), pext)
        ctab = tt.build_tree(spec, ptab, alive)
        stats = {}
        tt.tree_walk_plain(spec, ctab, ptab, alive, stats=stats,
                           ewald=(tab, pext))
        assert stats["far_terms"] > 0


def test_pair_gravity_twin_matches_jax():
    """ewald_pair_gravity, the dense oracle of the corrections."""
    rng = np.random.default_rng(11)
    N = 300
    r = rng.random((N, 3))
    m = rng.random(N) / N
    tab = te.build_ewald_table([1.0] * 3, ngrid=NGRID)
    jtab = je.build_ewald_table([1.0] * 3, ngrid=NGRID)
    box = DomainBox(3, (0.0,) * 3, (1.0,) * 3, (PERIODIC,) * 3,
                    (PERIODIC,) * 3)
    jbox = JaxBox(ndim=3, boxmin=(0.0,) * 3, boxmax=(1.0,) * 3,
                  lhs=(JPERIODIC,) * 3, rhs=(JPERIODIC,) * 3)
    a, g = te.ewald_pair_gravity(tab, box, torch.tensor(r), torch.tensor(m))
    ja, jg = je.ewald_pair_gravity(jtab, jbox, jnp.asarray(r),
                                   jnp.asarray(m))
    ja, jg = np.asarray(ja), np.asarray(jg)
    assert np.max(np.abs(a.numpy() - ja)) <= 1e-13 * np.max(np.abs(ja))
    assert np.max(np.abs(g.numpy() - jg)) <= 1e-13 * np.max(np.abs(jg))
    # the corrections conserve momentum
    assert np.abs((m[:, None] * a.numpy()).sum(0)).max() < 1e-12


def test_slab_box_is_open_along_z():
    """The port's DomainBox gives the slab's min-image period: the box
    length along x and y, none along z."""
    box = DomainBox(3, (0.0,) * 3, (1.0,) * 3, (PERIODIC, PERIODIC, OPEN),
                    (PERIODIC, PERIODIC, OPEN))
    assert box.periodic_dims() == (0, 1)
    assert JOPEN == OPEN
    assert te.period_of([1.0, 1.0, 0.0]) == (1.0, 1.0, te.OPEN_PERIOD)


def test_periodic_oracle_equals_an_all_open_walk():
    """check.periodic_gravity_accuracy's oracle (the min-imaged,
    kernel-softened direct sum plus each pair's correction) equals the
    port's walk when every cell is opened (the Jeans box at 8^3)."""
    import dataclasses

    from gandalf_tpu_torch.check import jeans_params, periodic_gravity_accuracy
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    sim = SimulationBase.factory(jeans_params(8), "cpu", torch.float64)
    sim.SetupSimulation()
    spec = sim.treespec
    G = spec.n_leaves
    everything = dataclasses.replace(
        spec, theta_sqd=1e-4, near_cap=G, frontier=2 * G,
        frontier_levels=tuple(min(1 << ell, 2 * G)
                              for ell in range(spec.depth + 1)))
    exact = periodic_gravity_accuracy(sim, 256, spec=everything)
    assert exact["rms_rel_err"] < 1e-12 and not exact["overflow"]
    # the same walk without the correction sees an isolated cube
    assert periodic_gravity_accuracy(sim, 256, spec=everything,
                                     ewald=False)["rms_rel_err"] > 1.0
