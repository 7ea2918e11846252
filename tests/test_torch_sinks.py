"""Port parity: the sink operators against gandalf_tpu/ops/sinks.py and
ops/sph_gravity.py, float64 on the CPU.

The plain versions of K16 (star_gas_forces), K17 (sink_candidate) and
K18 (accretion_sums), apply_sink_creation, create_sinks, apply_accretion,
accrete_to_sinks and the controller's _kill_eaten, and the tree walk with
dead particles (K4's alive input), on seeded numpy inputs with the edge
cases: inactive slots, gas exactly on a star, gas exactly at the
accretion radius, two sinks at equal distance, density ties, no eligible
particle and every slot full.  Sums within 1e-12 of each output's
largest value; indices, masks and slot fields exactly.  Also the JAX
package's tree plus star-gas accuracy on the Boss-Bodenheimer cloud,
which chip_smoke.py's accuracy gate refers to."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import sinks as js
from gandalf_tpu.ops import sph_gravity as jg
from gandalf_tpu.ops import tree as jt
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu.state import make_sph_state as jax_state
from gandalf_tpu_torch.check import FLOPS_PER, _star_gas_work, bb_params
from gandalf_tpu_torch.convert import sinks_from_jax, tree_spec_from_jax
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import sinks as ts
from gandalf_tpu_torch.ops import sph_gravity as tg
from gandalf_tpu_torch.ops import tree as tt
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation
from gandalf_tpu_torch.state import FLAG_DEAD, make_sph_state

torch.set_num_threads(1)

TOL = 1e-12
CFG = dict(rho_sink=1.0, sink_radius=2.0, create=True, accrete=True)


def _t(x):
    return torch.tensor(np.asarray(x))


def _scaled(got, want):
    want = np.asarray(want)
    scale = max(np.max(np.abs(want)), 1e-300)
    return np.max(np.abs(np.asarray(got) - want)) / scale


def _slots(rng, n_act=10, n_free=6, h=0.05):
    """Sink slots: n_act active ones in the unit cube, then n_free empty
    ones as empty_sinks leaves them (r = 0, h = 1)."""
    r = rng.random((n_act, 3))
    v = rng.standard_normal((n_act, 3))
    m = rng.random(n_act) + 0.5
    hh = h * (1.0 + rng.random(n_act))
    return js.make_sinks(r, v, m, hh, n_extra=n_free)


def _gas(rng, n=400):
    return (rng.random((n, 3)), rng.standard_normal((n, 3)),
            rng.random(n) * 1e-3 + 1e-3, 0.02 + 0.02 * rng.random(n))


def test_star_gas_forces_matches_jax():
    """K16 plain: both sides, with inactive slots carrying mass, one gas
    particle exactly on a star and one on an empty slot's position."""
    rng = np.random.default_rng(1)
    sinks = _slots(rng)
    r, _, m, h = _gas(rng)
    r[0] = np.asarray(sinks.r[2])       # on an active star
    r[1] = 0.0                          # on the empty slots
    ms = np.asarray(sinks.m).copy()
    ms[-3:] = 0.7                       # inactive slots with mass
    act = np.asarray(sinks.active)
    want = jg.star_gas_forces(jax_kernel("m4", 3), jnp.asarray(r),
                              jnp.asarray(m), jnp.asarray(h), sinks.r,
                              jnp.asarray(ms), sinks.h, sinks.active)
    got = tg.star_gas_forces(kernel_factory("m4", 3), _t(r), _t(m), _t(h),
                             _t(sinks.r), _t(ms), _t(sinks.h), _t(act))
    for name, g, w in zip(("a_gas", "gpot_gas", "a_star", "gpot_star"),
                          got, want):
        assert _scaled(g, w) <= TOL, name
    assert np.all(np.isfinite(got[0].numpy()))


def test_star_gas_work_counts_each_pair_once_by_branch():
    """check._star_gas_work, the operations K16's bound divides: one
    evaluation a pair beyond the M4 support, plus each inner branch's
    extra for the pairs at 1 <= s < 2 and s < 1 (s = |dr| / hbar)."""
    rng = np.random.default_rng(5)
    sinks = _slots(rng)
    r, _, _, h = _gas(rng)
    rs, hs = np.asarray(sinks.r), np.asarray(sinks.h)
    r[0] = rs[2]                                # s = 0
    r[1] = rs[3] + (0.06, 0.0, 0.0)             # 1 <= s < 2
    s = (np.linalg.norm(r[:, None, :] - rs[None], axis=-1)
         / (0.5 * (h[:, None] + hs[None])))
    near, mid = int((s < 1).sum()), int(((s >= 1) & (s < 2)).sum())
    assert near > 0 and mid > 0
    want = (FLOPS_PER["star_gas_forces"] * s.size
            + FLOPS_PER["star_gas_mid"] * mid
            + FLOPS_PER["star_gas_near"] * near)
    assert _star_gas_work(_t(r), _t(h), _t(rs), _t(hs)) == want


@pytest.mark.parametrize("case", ["plain", "ties", "none", "dead_max"])
def test_sink_candidate_matches_jax(case):
    """K17 plain: the densest alive particle above rho_sink, the lower
    index of equal densities, and index 0 with score -inf when none is
    eligible; then create_sinks' slots and alive mask."""
    rng = np.random.default_rng(2)
    r, v, m, h = _gas(rng, 300)
    rho = rng.random(300) * 2.0
    alive = rng.random(300) > 0.1
    if case == "ties":
        rho[[40, 200]] = 5.0
        alive[[40, 200]] = True
    elif case == "none":
        rho = np.minimum(rho, 0.9)
    elif case == "dead_max":
        rho[7] = 9.0
        alive[7] = False
    jcfg, tcfg = js.SinkConfig(**CFG), ts.SinkConfig(**CFG)
    jargs = [jnp.asarray(x) for x in (r, v, m, h, rho)]
    cand_w, gi_w = js.sink_candidate(jcfg, *jargs, jnp.asarray(alive))
    targs = [_t(x) for x in (r, v, m, h, rho)]
    cand, gi = ts.sink_candidate(tcfg, *targs, _t(alive))
    assert int(gi) == int(gi_w)
    assert np.array_equal(cand.numpy(), np.asarray(cand_w))
    if case == "ties":
        assert int(gi) == 40
    if case == "none":
        assert int(gi) == 0 and float(cand[-1]) == -np.inf
    sinks = _slots(rng, 3, 2)
    jsinks, jalive = js.create_sinks(jcfg, sinks, *jargs, None,
                                     jnp.asarray(alive))
    tsinks, talive = ts.create_sinks(tcfg, sinks_from_jax(sinks), *targs,
                                     _t(alive))
    assert np.array_equal(talive.numpy(), np.asarray(jalive))
    for f in ("r", "v", "a", "r0", "v0", "a0", "m", "h", "active"):
        assert np.array_equal(getattr(tsinks, f).numpy(),
                              np.asarray(getattr(jsinks, f))), f


def test_sink_creation_with_every_slot_full_is_a_no_op():
    rng = np.random.default_rng(3)
    sinks = _slots(rng, 4, 0)
    r, v, m, h = _gas(rng, 50)
    rho = np.full(50, 3.0)
    cfg = ts.SinkConfig(**CFG)
    new, created = ts.apply_sink_creation(
        sinks_from_jax(sinks),
        ts.sink_candidate(cfg, _t(r), _t(v), _t(m), _t(h), _t(rho),
                          torch.ones(50, dtype=torch.bool))[0], 3)
    jnew, jcreated = js.apply_sink_creation(
        sinks, js.sink_candidate(js.SinkConfig(**CFG), *(
            jnp.asarray(x) for x in (r, v, m, h, rho)),
            jnp.ones(50, bool))[0], 3)
    assert not bool(created) and not bool(jcreated)
    for f in ("r", "m", "h", "active"):
        assert np.array_equal(getattr(new, f).numpy(),
                              np.asarray(getattr(sinks, f))), f


def _accretion_case():
    """Gas around active and inactive slots: one particle exactly at a
    sink's accretion radius along x, one at equal distance from two
    sinks, dead particles inside a sink."""
    rng = np.random.default_rng(4)
    sinks = _slots(rng, 8, 4, h=0.06)
    sr = np.asarray(sinks.r).copy()
    sh = np.asarray(sinks.h).copy()
    # dyadic positions, so that the distances below are exact: slot 0 with
    # r_acc = 0.125, slots 1 and 2 0.125 apart
    sr[0], sh[0] = (0.75, 0.25, 0.25), 0.0625
    sr[1], sr[2] = (0.25, 0.5, 0.5), (0.375, 0.5, 0.5)
    sh[1] = sh[2] = 0.0625
    sinks = sinks._replace(r=jnp.asarray(sr), h=jnp.asarray(sh))
    r, v, m, _ = _gas(rng, 500)
    # cluster gas around the active sinks
    r[:200] = sr[rng.integers(0, 8, 200)] + 0.08 * (rng.random((200, 3))
                                                     - 0.5)
    r[200] = (0.875, 0.25, 0.25)     # exactly at slot 0's r_acc
    r[201] = (0.3125, 0.5, 0.5)      # 0.0625 from slots 1 and 2
    alive = np.ones(500, bool)
    alive[5:15] = False
    return sinks, r, v, m, alive


def test_accretion_sums_match_jax():
    """K18 plain: per-slot sums within 1e-12 and the eaten mask exactly;
    the particle at r_acc is not eaten, the one between two sinks goes to
    the lower slot, dead gas is never eaten and empty slots eat nothing."""
    sinks, r, v, m, alive = _accretion_case()
    jcfg, tcfg = js.SinkConfig(**CFG), ts.SinkConfig(**CFG)
    want = js.accretion_sums(jcfg, sinks, jnp.asarray(r), jnp.asarray(v),
                             jnp.asarray(m), jnp.asarray(alive))
    got = ts.accretion_sums(tcfg, sinks_from_jax(sinks), _t(r), _t(v),
                            _t(m), _t(alive))
    for name, g, w in zip(("dm", "dmom", "dmr"), got[:3], want[:3]):
        assert _scaled(g, w) <= TOL, name
    eaten = got[3].numpy()
    assert np.array_equal(eaten, np.asarray(want[3]))
    assert not eaten[200] and eaten[201] and not eaten[5:15].any()
    assert eaten.sum() > 20
    assert np.all(got[0].numpy()[8:] == 0.0)
    # the equidistant particle went to slot 1: its mass is in slot 1's sum
    only = np.zeros(500, bool)
    only[201] = True
    one = ts.accretion_sums(tcfg, sinks_from_jax(sinks), _t(r), _t(v),
                            _t(m), _t(only))
    assert float(one[0][1]) == m[201] and float(one[0][2]) == 0.0
    # the whole update
    jnew, jalive = js.accrete_to_sinks(jcfg, sinks, jnp.asarray(r),
                                       jnp.asarray(v), jnp.asarray(m),
                                       jnp.asarray(alive))
    tnew, talive = ts.accrete_to_sinks(tcfg, sinks_from_jax(sinks), _t(r),
                                       _t(v), _t(m), _t(alive))
    assert np.array_equal(talive.numpy(), np.asarray(jalive))
    for f in ("r", "v", "r0", "v0", "m"):
        assert _scaled(getattr(tnew, f), getattr(jnew, f)) <= TOL, f
    assert np.array_equal(tnew.active.numpy(), np.asarray(jnew.active))


def test_kill_eaten_matches_jax():
    rng = np.random.default_rng(6)
    n = 64
    r, v, m, h = _gas(rng, n)
    u = np.full(n, 1.0)
    jsim_state = jax_state(r, v, m, h, u)
    jsim_state = jsim_state.replace(a=jnp.asarray(rng.random((n, 3))),
                                    a0=jnp.asarray(rng.random((n, 3))),
                                    dudt=jnp.asarray(rng.random(n)))
    s = make_sph_state(r, v, m, h, u)
    s = s.replace(a=_t(jsim_state.a), a0=_t(jsim_state.a0),
                  dudt=_t(jsim_state.dudt))
    keep = rng.random(n) > 0.3
    want = JaxSim._kill_eaten(jsim_state, jnp.asarray(keep))
    got = GradhSphSimulation._kill_eaten(s, _t(keep))
    for f in ("flags", "m", "v", "v0", "a", "a0", "dudt", "dudt0", "r"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    assert np.array_equal(got.alive.numpy(), keep)
    assert int(got.flags[~_t(keep)][0]) & FLAG_DEAD


def test_tree_with_dead_particles_matches_jax():
    """tree_gravity_grouped with an alive mask (K4's alive input through
    K5-K7 plain): dead particles are no sources, and every particle's
    field, the dead's at their frozen positions included, matches the
    JAX package's within 1e-10 (ROADMAP fault F12)."""
    rng = np.random.default_rng(5)
    N = 1500
    r = rng.standard_normal((N, 3)) / 3.0
    m = rng.random(N) * (2.0 / N)
    h = 0.05 * (1.0 + rng.random(N))
    alive = rng.random(N) > 0.2
    m = np.where(alive, m, 0.0)
    h = np.where(alive, h, 1.0)          # the dead's benign h
    gmap = jt.plan_buckets_kd(r, 32)
    jspec = jt.plan_tree_for_buckets(gmap, 0.1)
    kern_j, kern_t = jax_kernel("m4", 3), kernel_factory("m4", 3)
    a_w, p_w, o_w = jt.tree_gravity_grouped(
        jspec, jnp.asarray(gmap), jnp.asarray(r), jnp.asarray(m),
        jnp.asarray(h), kern_j, alive=jnp.asarray(alive))
    spec = tree_spec_from_jax(jspec)
    a, gpot, ovf = tt.tree_gravity_grouped(spec, _t(gmap), _t(r), _t(m),
                                           _t(h), kern_t, alive=_t(alive))
    assert bool(ovf) == bool(o_w)
    assert _scaled(a.numpy(), np.asarray(a_w)) <= 1e-10
    assert _scaled(gpot.numpy(), np.asarray(p_w)) <= 1e-10
    assert gpot.numpy()[~alive].all()
    _, slot_alive = tt.gather_to_buckets(spec, _t(gmap), _t(r), _t(m),
                                         alive=_t(alive))
    flat = gmap.reshape(-1)
    assert np.array_equal(slot_alive.numpy(),
                          (flat >= 0) & alive[np.maximum(flat, 0)])


def test_tree_with_an_all_dead_bucket_matches_jax():
    """A bucket whose particles are all dead walks nothing in the port
    (K6/K7 skip a group without a live slot) and gets zero a and gpot;
    the JAX package gives them zero too, and every other particle's
    field matches within 1e-10 (ROADMAP fault F12)."""
    rng = np.random.default_rng(5)
    N = 1500
    r = rng.standard_normal((N, 3)) / 3.0
    m = rng.random(N) * (2.0 / N)
    h = 0.05 * (1.0 + rng.random(N))
    gmap = jt.plan_buckets_kd(r, 32)
    alive = rng.random(N) > 0.2
    bucket = gmap[3][gmap[3] >= 0]
    alive[bucket] = False
    m = np.where(alive, m, 0.0)
    h = np.where(alive, h, 1.0)
    jspec = jt.plan_tree_for_buckets(gmap, 0.1)
    a_w, p_w, o_w = jt.tree_gravity_grouped(
        jspec, jnp.asarray(gmap), jnp.asarray(r), jnp.asarray(m),
        jnp.asarray(h), jax_kernel("m4", 3), alive=jnp.asarray(alive))
    a, gpot, ovf = tt.tree_gravity_grouped(
        tree_spec_from_jax(jspec), _t(gmap), _t(r), _t(m), _t(h),
        kernel_factory("m4", 3), alive=_t(alive))
    assert bool(ovf) == bool(o_w)
    assert not np.asarray(p_w)[bucket].any()
    assert not gpot.numpy()[bucket].any() and not a.numpy()[bucket].any()
    assert _scaled(a.numpy(), np.asarray(a_w)) <= 1e-10
    assert _scaled(gpot.numpy(), np.asarray(p_w)) <= 1e-10


def test_jax_tree_and_star_gas_accuracy_on_bb():
    """The JAX package's monopole tree (theta^2 = 0.15, KD buckets) plus
    its star-gas pull against the all-pairs sum over the alive gas plus
    the star-gas sum, float64, on the lattice Boss-Bodenheimer cloud
    (rho_sink 2e-17 g cm^-3) at 2,176 particles after one step (a sink,
    its eaten gas dead): the reading chip_smoke.py's bb_sink_collapse
    accuracy gate refers to.  The port's plain path makes the state."""
    sim = GradhSphSimulation(bb_params(2000, rho_sink=2.0e-17),
                             device="cpu", dtype=torch.float64)
    sim.SetupSimulation()
    sim.main_loop_step()
    s, st = sim.state, sim.state.sinks
    alive = s.alive.numpy()
    assert int(st.active.sum()) == 1 and (~alive).sum() > 1
    idx = torch.as_tensor(np.flatnonzero(alive))
    ref, _ = tg.direct_sph_gravity(sim.kern, s.r, s.m, s.h, s.zeta,
                                   s.hfactor, targets=idx)
    m_star = torch.where(st.active, st.m, 0.0)
    ref = ref + tg.star_gas_forces_plain(sim.kern, s.r[idx], s.m[idx],
                                         s.h[idx], st.r, m_star, st.h,
                                         st.active)[0]
    kern = jax_kernel("m4", 3)
    j = {f: jnp.asarray(getattr(s, f).numpy()) for f in ("r", "m", "h")}
    a, _, ovf = jt.tree_gravity_grouped(
        jt.TreeSpec(**dataclasses.asdict(sim.treespec)),
        jnp.asarray(s.bucket_map.numpy()), j["r"], j["m"], j["h"], kern,
        zh=jnp.asarray((s.zeta * s.hfactor).numpy()),
        alive=jnp.asarray(alive))
    a_sg = jg.star_gas_forces(kern, j["r"], j["m"], j["h"],
                              jnp.asarray(st.r.numpy()),
                              jnp.asarray(m_star.numpy()),
                              jnp.asarray(st.h.numpy()),
                              jnp.asarray(st.active.numpy()))[0]
    assert not bool(ovf)
    da = (np.asarray(a) + np.asarray(a_sg))[alive] - ref.numpy()
    err = float(np.sqrt(np.sum(da * da) / np.sum(ref.numpy() ** 2)))
    print(f"gandalf_tpu bb_sink_collapse N={s.N} float64 after a step: "
          f"rms|da|/rms|a| {err:.3e}")
    assert s.N == 2176 and sim.treespec.quadrupole is False
    assert err <= 3e-3
