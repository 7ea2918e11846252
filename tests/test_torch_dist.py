"""Port parity: the distributed runtime's functions
(gandalf_tpu_torch/parallel/) against gandalf_tpu/parallel/ on the CPU,
float64, with the JAX package's plans handed to the port.

The JAX functions run inside shard_map over the virtual CPU devices that
tests/conftest.py makes; the port's run on a shard group of CPU devices.
The host planners are copies, held against the originals; the ghost
functions, the sharded hydro passes, the ring-LET and replicated gravity
and the device-side migration are held against theirs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8 moved shard_map out of experimental
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.parallel import dist as jdist
from gandalf_tpu.parallel import halo as jhalo
from gandalf_tpu.parallel import let as jlet
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu.state import make_sph_state as jax_state
from gandalf_tpu_torch.check import dist_box_params, dist_ic
from gandalf_tpu_torch.convert import (dist_plan_from_jax, grid_spec_from_jax,
                                       let_plan_from_jax, tree_spec_from_jax)
from gandalf_tpu_torch.ops.sph_grid27 import plan_grid27
from gandalf_tpu_torch.parallel import dist, halo, let
from gandalf_tpu_torch.parallel.comm import ShardGroup
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation
from gandalf_tpu_torch.state import make_sph_state

torch.set_num_threads(1)

TOL = 1e-9
HYDRO_FIELDS = ("h", "rho", "invomega", "zeta", "hfactor", "u", "pressure",
                "sound", "a", "dudt", "div_v")


def _mesh(S):
    return Mesh(np.array(jax.devices()[:S]), axis_names=("dp",))


def _smap(fn, S, in_specs, out_specs):
    try:
        sm = shard_map(fn, mesh=_mesh(S), in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    except TypeError:  # older jax spells it check_rep
        sm = shard_map(fn, mesh=_mesh(S), in_specs=in_specs,
                       out_specs=out_specs, check_rep=False)
    return jax.jit(sm)


def _state_specs(s):
    def rule(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == s.N:
            return P("dp", *([None] * (x.ndim - 1)))
        return P()

    return jax.tree_util.tree_map(rule, s)


def _rel(got, want, mask=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(np.max(np.abs(want)), 1e-300)
    return float(np.max(np.abs(got - want)) / scale)


class Case:
    """Both packages' controllers' physics objects, the IC and the
    plans (the JAX package's, copied into the port)."""

    def __init__(self, n_side, S, balance="never", grav=0, cluster=0.0,
                 z_len=1):
        p = dist_box_params(n_side, S, grav, z_len)
        self.ic = dist_ic(p, cluster=cluster)
        self.jsim = JaxSim(p)
        self.jsim.process_parameters()
        self.tsim = GradhSphSimulation(p, "cpu", torch.float64)
        self.tsim.process_parameters()
        r, h = self.ic["r"], self.ic["h"]
        kr = self.tsim.kern.kernrange
        self.jspec = jg.plan_grid27(self.jsim.box, r, h.max() * 1.3, kr,
                                    z_multiple=S)
        self.jplan = jdist.plan_decomposition(self.jspec, r, S,
                                              balance=balance)
        self.plan = dist_plan_from_jax(self.jplan)
        self.S = S
        self.group = ShardGroup(["cpu"] * S)
        ic = self.ic
        js = jax_state(ic["r"], ic["v"], ic["m"], ic["h"], ic["u"])
        self.js = jdist.shard_state(self.jplan, js)
        ts = make_sph_state(ic["r"], ic["v"], ic["m"], ic["h"], ic["u"],
                            device="cpu", dtype=torch.float64)
        self.ts = dist.shard_state(self.group, self.plan, ts)

    def alive(self):
        return np.concatenate([st.alive.numpy() for st in self.ts])


_CASES = {}


def case(name):
    """Module-wide cases, built once."""
    if name not in _CASES:
        # (n_side, S, balance, gravity, cluster, z_len): an 8^3 cube has
        # two rows of cells, so four shards take thin slabs (qz = 2); a
        # box four times as long has eight, qz = 1
        _CASES[name] = Case(*{
            "uniform4": (8, 4, "never", 0, 0.0, 4),
            "balanced4": (8, 4, "auto", 0, 0.5, 4),
            "thin4": (8, 4, "never", 0, 0.0, 1),
            "grav4": (12, 4, "never", 1, 0.0, 1),
            "grav2": (8, 2, "never", 1, 0.0, 1),
        }[name])
    return _CASES[name]


# ---------------------------------------------------------------------------
# Host planners: copies held against the originals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("cluster", [0.0, 0.5])
def test_planners_copy_the_jax_package(S, cluster):
    """plan_grid27(z_multiple), _balance_rows, plan_decomposition
    (uniform and balanced) and plan_let give the JAX package's plans."""
    p = dist_box_params(8, S, 1, z_len=4)
    ic = dist_ic(p, cluster=cluster)
    jsim = JaxSim(p)
    jsim.process_parameters()
    r, h = ic["r"], ic["h"]
    spec = plan_grid27(jsim.box, r, h.max() * 1.3, 2.0, z_multiple=S)
    jspec = jg.plan_grid27(jsim.box, r, h.max() * 1.3, 2.0, z_multiple=S)
    assert spec == grid_spec_from_jax(jspec)
    w = np.random.default_rng(S).random(16) ** 3
    for min_len in (1, 2):
        got = dist._balance_rows(w, S, min_len)
        want = jdist._balance_rows(w, S, min_len)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for balance in ("never", "auto"):
        jplan = jdist.plan_decomposition(jspec, r, S, balance=balance)
        plan = dist.plan_decomposition(spec, r, S, balance=balance)
        ref = dist_plan_from_jax(jplan)
        for f in dataclasses.fields(plan):
            a, b = getattr(plan, f.name), getattr(ref, f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
        if cluster and S == 4:
            assert plan.balanced == (balance == "auto")
        r_sh = dist.shard_array(plan, r, 0.5)
        kw = dict(z_lo=spec.lo[0], z_extent=spec.extents[0],
                  theta_sqd=0.1, h_support=2.0 * h.max())
        lp = let.plan_let(r_sh, plan.perm, S, plan.cap, **kw)
        jlp = jlet.plan_let(r_sh, jplan.perm, S, jplan.cap, **kw)
        assert dataclasses.replace(lp, gmap=None) == dataclasses.replace(
            let_plan_from_jax(jlp), gmap=None)
        np.testing.assert_array_equal(lp.gmap, np.asarray(jlp.gmap))
        grown = let.grow_let_caps(lp)
        assert grown.spec_comb == tree_spec_from_jax(
            jlet.grow_let_caps(jlp).spec_comb)


def test_unshard_round_trip():
    """shard_state then unshard_state gives the state back, and
    shard_array / unshard_array are inverse, as in the JAX package."""
    c = case("balanced4")
    back = dist.unshard_state(c.plan, c.ts, len(c.ic["r"]))
    np.testing.assert_array_equal(back.r.numpy(), c.ic["r"])
    x = np.arange(len(c.ic["r"]), dtype=np.float64)
    np.testing.assert_array_equal(
        dist.shard_array(c.plan, x, -1.0),
        jdist.shard_array(c.jplan, x, -1.0))
    np.testing.assert_array_equal(
        dist.unshard_array(c.plan, dist.shard_array(c.plan, x, -1.0),
                           len(x)), x)


# ---------------------------------------------------------------------------
# Ghost functions
# ---------------------------------------------------------------------------

def _ghost_both(S, spec, local, row_len, periodic):
    """The port's ghost of random per-shard slabs against the JAX
    package's (whose other dims' ghost layers are cut off)."""
    spec = dataclasses.replace(spec, periodic=(periodic,)
                               + tuple(spec.periodic[1:]))
    nz_loc = local.ncells[0]
    rng = np.random.default_rng(5)
    shape = (S * nz_loc,) + tuple(spec.ncells[1:]) + (spec.k_cell,)
    x = rng.random(shape + (3,))
    group = ShardGroup(["cpu"] * S)
    if row_len is None:
        tg = halo.make_halo_ghost_fn(group, spec, local)
        jfn = jhalo.make_halo_ghost_fn("dp", spec, local)
    else:
        tg = halo.make_halo_ghost_fn_balanced(group, spec, local, row_len)
        jfn = jhalo.make_halo_ghost_fn_balanced("dp", spec, local, row_len)
    blocks = [torch.tensor(x[k * nz_loc:(k + 1) * nz_loc])
              for k in range(S)]
    out = {}
    for shift in (False, True):
        got = tg(blocks, shift)
        want = np.asarray(_smap(
            lambda xl: jfn(local, xl, shift_vec=True if shift else None),
            S, (P("dp"),), P("dp"))(jnp.asarray(x)))
        n0 = got[0].shape[0]
        inner = (slice(None),) + (slice(1, -1),) * (spec.ndim - 1)
        for k in range(S):
            w = want[k * n0:(k + 1) * n0][inner]
            out[(shift, k)] = np.max(np.abs(got[k].numpy() - w))
    return out


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("kind", ["qz1", "multihop", "balanced"])
def test_ghost_functions_match(kind, periodic):
    """Both ghost functions against the JAX package's: qz = 1, qz > 1
    over several hops (slabs thinner than qz rows), the balanced
    layout's receive window; a periodic dim 0 (with the seam's +-Lz
    shift on positions) and an open one (zeros beyond the edge)."""
    S = 4
    base = jg.Grid27Spec(ndim=3, ncells=(8, 3, 2), lo=(0.0, 0.0, 0.0),
                         extents=(1.0, 1.0, 1.0), k_cell=3,
                         periodic=(True, True, True), qz=1)
    row_len = None
    if kind == "multihop":
        base = dataclasses.replace(base, ncells=(4, 3, 2), qz=3)
    if kind == "balanced":
        base = dataclasses.replace(base, ncells=(16, 3, 2), qz=2)
        row_len = np.array([3, 5, 4, 4])
    S_rows = base.ncells[0] // S
    nz_pad = S_rows if row_len is None else 2 * S_rows
    cell0 = base.extents[0] / base.ncells[0]
    local = dataclasses.replace(base, ncells=(nz_pad,) + base.ncells[1:],
                                extents=(nz_pad * cell0,)
                                + base.extents[1:])
    errs = _ghost_both(S, grid_spec_from_jax(base),
                       grid_spec_from_jax(local), row_len, periodic)
    assert max(errs.values()) == 0.0, errs


# ---------------------------------------------------------------------------
# The sharded hydro passes
# ---------------------------------------------------------------------------

def _jax_dist_hydro(c, hydro_forces=True):
    jsim = c.jsim

    def fn(s):
        return jdist.dist_hydro_pass(None, c.jplan, jsim.kern, jsim.visc,
                                     jsim.box, jsim.eos, jsim.h_fac,
                                     jsim.h_converge, hydro_forces, s,
                                     s.alive)

    specs = _state_specs(c.js)
    return _smap(fn, c.S, (specs,), specs)(c.js)


@pytest.mark.parametrize("name", ["uniform4", "balanced4", "thin4"])
def test_dist_hydro_pass_matches(name):
    """dist_hydro_pass (K1 with zrow_max, K2 and K3 on ghosted slabs)
    against the JAX package's, on its plan: uniform, work-balanced
    (clustered along z) and thin slabs (qz > 1, multi-hop halos)."""
    c = case(name)
    if name == "balanced4":
        assert c.plan.balanced
    if name == "thin4":
        assert c.plan.global_spec.qz > 1
    want = _jax_dist_hydro(c)
    t = c.tsim
    alives = [st.alive for st in c.ts]
    got = dist.dist_hydro_pass(c.group, c.plan, t.kern, t.visc, t.box,
                               t.eos, t.h_fac, t.h_converge, True, c.ts,
                               alives)
    live = c.alive()
    errs = {f: _rel(torch.cat([getattr(s, f) for s in got]).numpy(),
                    getattr(want, f), live) for f in HYDRO_FIELDS}
    assert max(errs.values()) <= TOL, errs
    assert bool(got[0].neib_overflow) == bool(want.neib_overflow)


def test_hydro_pass_grid27_sharded_matches():
    """hydro_pass_grid27_sharded (replicated binning, the dense tensors
    split along z) against the JAX package's, on thin slabs (qz 2)."""
    c = case("thin4")
    ic, jsim, t = c.ic, c.jsim, c.tsim
    js = jax_state(ic["r"], ic["v"], ic["m"], ic["h"], ic["u"])
    want = jax.jit(lambda s: jhalo.hydro_pass_grid27_sharded(
        _mesh(4), "dp", jsim.kern, jsim.visc, jsim.box, c.jspec, jsim.eos,
        jsim.h_fac, jsim.h_converge, True, s))(js)
    ts = make_sph_state(ic["r"], ic["v"], ic["m"], ic["h"], ic["u"],
                        device="cpu", dtype=torch.float64)
    got = halo.hydro_pass_grid27_sharded(
        c.group, t.kern, t.visc, t.box, c.plan.global_spec, t.eos, t.h_fac,
        t.h_converge, True, ts)
    errs = {f: _rel(getattr(got, f).numpy(), getattr(want, f))
            for f in HYDRO_FIELDS}
    assert max(errs.values()) <= TOL, errs


# ---------------------------------------------------------------------------
# Gravity
# ---------------------------------------------------------------------------

def _gravity_inputs(c):
    """The hydro pass's state (h, zeta, hfactor set), the JAX LET plan
    (ring radius 1 at S = 4, so one shard is far) and the port's."""
    t = c.tsim
    alives = [st.alive for st in c.ts]
    ts = dist.dist_hydro_pass(c.group, c.plan, t.kern, t.visc, t.box,
                              t.eos, t.h_fac, t.h_converge, False, c.ts,
                              alives)
    r_sh = torch.cat([s.r for s in ts]).numpy()
    jlp = jlet.plan_let(r_sh, c.jplan.perm, c.S, c.jplan.cap,
                        z_lo=c.jspec.lo[0], z_extent=c.jspec.extents[0],
                        theta_sqd=0.1, h_support=0.0)
    if c.S == 4:
        jlp = dataclasses.replace(jlp, ring_radius=1)
    return ts, jlp


def _mp_eval_f35_repaired(dr, m, q6, tri, ndim):
    """The JAX package's _mp_eval with the quadrupole of a zero-mass
    entry masked: far_group's sums over the accepted cells only, as the
    port's K38 takes them (F35)."""
    if q6 is not None:
        q6 = jnp.where((m > 0.0)[..., None], q6, 0.0)
    return _MP_EVAL(dr, m, q6, tri, ndim)


_MP_EVAL = jlet._mp_eval


def _jax_let(c, ts, jlp, quadrupole=True):
    jlp = dataclasses.replace(jlp, spec_comb=dataclasses.replace(
        jlp.spec_comb, quadrupole=quadrupole))
    cat = lambda f: jnp.asarray(torch.cat([getattr(s, f) for s in ts])
                                .numpy())
    r, m, h = cat("r"), cat("m"), cat("h")
    zh = cat("zeta") * cat("hfactor")
    alive = jnp.asarray(c.alive())
    gmap = jnp.asarray(jlp.gmap)

    def fn(gm, r, m, h, zh, al):
        return jlet.let_gravity(jlp, gm, r, m, h, zh, al, c.jsim.kern,
                                periodic_extent=[1.0, 1.0, 1.0])

    d = P("dp")
    jlet._mp_eval = _mp_eval_f35_repaired
    try:
        return _smap(fn, c.S, (d,) * 6, (d, d, P()))(gmap, r, m, h, zh,
                                                     alive)
    finally:
        jlet._mp_eval = _MP_EVAL


def _port_let(c, ts, lp, stats=None):
    G = lp.g_loc
    gm = torch.tensor(lp.gmap).reshape(c.S, G, -1)
    alives = [s.alive for s in ts]
    return let.let_gravity(
        c.group, lp, list(gm), [s.r for s in ts],
        [torch.where(al, s.m, 0.0) for s, al in zip(ts, alives)],
        [s.h for s in ts], [s.zeta * s.hfactor for s in ts], alives,
        c.tsim.kern, periodic_extent=[1.0, 1.0, 1.0], stats=stats)


@pytest.mark.parametrize("name,quadrupole", [("grav4", True),
                                             ("grav4", False),
                                             ("grav2", True)])
def test_let_gravity_matches(name, quadrupole):
    """let_gravity against the JAX package's on its plan: S = 4 with ring
    radius 1, so that K38 walks the far shard's published table (with
    the quadrupole and without), and S = 2, where the ring covers every
    shard and nothing is far.  The JAX package's far walk runs with F35
    repaired (_mp_eval_f35_repaired), as the port's does."""
    c = case(name)
    ts, jlp = _gravity_inputs(c)
    lp = let_plan_from_jax(jlp)
    lp = dataclasses.replace(lp, spec_comb=dataclasses.replace(
        lp.spec_comb, quadrupole=quadrupole))
    stats = {}
    a, gpot, ovf = _port_let(c, ts, lp, stats)
    ja, jpot, jovf = _jax_let(c, ts, jlp, quadrupole)
    assert stats["far_tables"] == (1 if c.S == 4 else 0)
    live = c.alive()
    errs = {"a": _rel(torch.cat(a).numpy(), ja, live),
            "gpot": _rel(torch.cat(gpot).numpy(), jpot, live)}
    assert max(errs.values()) <= TOL, errs
    assert bool(ovf) == bool(jovf)


def test_far_walk_overflow_flags_match():
    """A frontier capped below what the far walk opens raises the flag
    in both packages."""
    c = case("grav4")
    ts, jlp = _gravity_inputs(c)
    jlp = dataclasses.replace(jlp, remote_frontier=1)
    _, _, ovf = _port_let(c, ts, let_plan_from_jax(jlp))
    _, _, jovf = _jax_let(c, ts, jlp)
    assert bool(jovf) and bool(ovf)


def test_far_walk_counts_and_fills_live_targets_only():
    """K38's plain version on the far inputs of the grav4 case: a dead
    target gets zero and a live one the field of the all-live walk; a
    group without a live target is not walked; far_terms counts each
    group's accepted cells times its live targets, as K6's count does."""
    c = case("grav4")
    ts, jlp = _gravity_inputs(c)
    lp = let_plan_from_jax(jlp)
    G = lp.g_loc
    gm = torch.tensor(lp.gmap).reshape(c.S, G, -1)
    tabs, cen, half, rt, alive = let.far_walk_inputs(
        c.group, lp, list(gm), [s.r for s in ts], [s.m for s in ts],
        [s.h for s in ts], [s.zeta * s.hfactor for s in ts],
        [s.alive for s in ts], [1.0, 1.0, 1.0])[0]
    # group 0 loses every target, group 1 every other one
    alive = alive.clone().reshape(G, 32)
    alive[0] = False
    alive[1, ::2] = False
    n_live = alive.sum(1)
    assert int(n_live[2:].min()) > 0
    wargs = (32, lp.remote_frontier, 0.1, True)
    stats, full = {}, {}
    a, pot, flag = let.let_far_walk(tabs, cen, half, rt, alive.reshape(-1),
                                    *wargs)
    a1, pot1, _ = let.let_far_walk_plain(
        tabs, cen, half, rt, torch.ones_like(alive).reshape(-1), *wargs,
        stats=full)
    let.let_far_walk_plain(tabs, cen, half, rt, alive.reshape(-1), *wargs,
                           stats=stats)
    dead = ~alive.reshape(-1)
    assert not bool(flag[0])
    assert float(a[dead].abs().max()) == 0.0 == float(pot[dead].abs().max())
    assert torch.equal(a[~dead], a1[~dead])
    assert torch.equal(pot[~dead], pot1[~dead])
    # each group's accepted cells, from its all-live count alone
    acc = []
    for g in range(G):
        sg = {}
        sl = slice(g * 32, (g + 1) * 32)
        let.let_far_walk_plain(tabs, cen[g:g + 1], half[g:g + 1], rt[sl],
                               torch.ones(32, dtype=torch.bool), *wargs,
                               stats=sg)
        acc.append(sg["far_terms"] // 32)
        if g == 0:
            mac0 = sg["mac_tests"]
    assert sum(acc) * 32 == full["far_terms"]
    assert stats["far_terms"] == sum(
        n * k for n, k in zip(n_live.tolist(), acc))
    assert stats["mac_tests"] == full["mac_tests"] - mac0 > 0


def test_zero_mass_entries_carry_their_quadrupole_in_jax_f35():
    """F35 on the JAX package: _mp_eval adds a cell's quadrupole term at
    zero mass, which far_group hands it for every frontier entry it does
    not accept (opened cells, and the empty entries it reads as the
    level's first cell); the port's K38 adds the accepted cells' only."""
    dr = jnp.asarray([[0.3, -0.2, 0.5]])
    q6 = jnp.asarray([[0.01, 0.002, -0.003, 0.02, 0.001, -0.03]])
    tri = [(i, j) for i in range(3) for j in range(i, 3)]
    a, pot = jlet._mp_eval(dr, jnp.zeros((1,)), q6, tri, 3)
    assert float(jnp.max(jnp.abs(a))) > 0.0 and float(pot[0]) != 0.0


def test_dist_tree_gravity_matches():
    """dist_tree_gravity (replicated tree, each shard's group range, the
    partial sums added over shards) against the JAX package's."""
    from gandalf_tpu.ops.tree import plan_buckets_kd, plan_tree_for_buckets

    c = case("grav4")
    ts, _ = _gravity_inputs(c)
    r_sh = torch.cat([s.r for s in ts]).numpy()
    real = np.nonzero(c.plan.perm >= 0)[0]
    g_r = plan_buckets_kd(r_sh[real], leaf_size=32)
    gmap = np.where(g_r >= 0, real[np.maximum(g_r, 0)], -1).astype(np.int32)
    G2 = -(-gmap.shape[0] // c.S) * c.S
    gmap = np.concatenate([gmap, np.full((G2 - gmap.shape[0], 32), -1,
                                         np.int32)])
    jspec = plan_tree_for_buckets(gmap, theta_sqd=0.1, quadrupole=True)
    spec = tree_spec_from_jax(jspec)
    alive = c.alive()
    cat = lambda f: jnp.asarray(torch.cat([getattr(s, f) for s in ts])
                                .numpy())
    from gandalf_tpu.state import SphState as JState

    js = c.js.replace(r=cat("r"), m=cat("m"), h=cat("h"),
                      zeta=cat("zeta"), hfactor=cat("hfactor"))
    assert isinstance(js, JState)

    def fn(s, al):
        return jdist.dist_tree_gravity(jspec, jnp.asarray(gmap), s,
                                       c.jsim.kern, al, c.S,
                                       periodic_extent=[1.0, 1.0, 1.0])

    specs = _state_specs(js)
    ja, jpot, jovf = _smap(fn, c.S, (specs, P("dp")),
                           (P("dp"), P("dp"), P()))(js, jnp.asarray(alive))
    alives = [s.alive for s in ts]
    a, gpot, ovf = dist.dist_tree_gravity(
        c.group, spec, torch.tensor(gmap), ts, [s.m for s in ts], c.tsim.kern,
        alives, periodic_extent=[1.0, 1.0, 1.0])
    errs = {"a": _rel(torch.cat(a).numpy(), ja, alive),
            "gpot": _rel(torch.cat(gpot).numpy(), jpot, alive)}
    assert max(errs.values()) <= TOL, errs
    assert bool(ovf) == bool(jovf)


# ---------------------------------------------------------------------------
# Migration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mig_cap", [None, 2])
def test_migrate_particles_matches(mig_cap):
    """migrate_particles moves the particles that left their slab to the
    same slots as the JAX package's, with the same iorig and overflow
    flag; a capacity of 2 leavers a destination forces the overflow."""
    c = case("uniform4")
    rng = np.random.default_rng(3)
    spec = c.plan.global_spec
    dz = 0.1 * rng.standard_normal(len(c.plan.perm))
    r = torch.cat([s.r for s in c.ts]).numpy().copy()
    r[:, 0] = spec.lo[0] + np.mod(r[:, 0] + dz - spec.lo[0],
                                  spec.extents[0])
    cap = c.plan.cap
    ts = [s.replace(r=torch.tensor(r[k * cap:(k + 1) * cap]))
          for k, s in enumerate(c.ts)]
    js = c.js.replace(r=jnp.asarray(r))

    def fn(s):
        s2, _, over = jdist.migrate_particles(c.jplan, s, (),
                                              mig_cap=mig_cap)
        return s2, jax.lax.pmax(over.astype(jnp.int32), "dp") > 0

    specs = _state_specs(js)
    jout, jover = _smap(fn, c.S, (specs,), (specs, P()))(js)
    out, _, over = dist.migrate_particles(c.group, c.plan, ts,
                                          mig_cap=mig_cap)
    assert bool(over) == bool(jover)
    assert bool(over) == (mig_cap == 2)
    for f in ("iorig", "flags", "r", "v"):
        np.testing.assert_array_equal(
            torch.cat([getattr(s, f) for s in out]).numpy(),
            np.asarray(getattr(jout, f)), err_msg=f)
    perm = dist.perm_from_iorig(c.plan, [s.iorig for s in out]).perm
    np.testing.assert_array_equal(
        perm, jdist.perm_from_iorig(c.jplan, jout.iorig).perm)
