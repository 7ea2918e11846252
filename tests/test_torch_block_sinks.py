"""Port parity: block-stepped star formation and smooth accretion,
float64 on the CPU against gandalf_tpu.

- ``dt_extra`` (the sinks' and stars' timestep bound) in init_schedule
  and ladder_update: it caps the resync's dt_min and grows level_max by
  at most one level a tick between resyncs;
- K20's plain versions (smooth_accretion_sums, apply_smooth_accretion)
  against the JAX functions on check.smooth_accretion_inputs at 16 and
  64 slots, with a particle at equal distance from two sinks (the lower
  slot takes it), dead gas and empty slots (neither takes part), gas
  that goes whole (a slow orbit) and gas that keeps part of its mass;
- K22's plain version against the JAX package's _levelneib_pass
  formula, in a periodic and an open box with dead particles;
- 8 ticks of tests/test_sinks.py's hybrid Plummer sphere (128 gas, 16
  stars, accretion, Nlevels = 3, on the grid path: neib_search =
  kdtree) through both controllers: equal alive masks, levels, nlast
  and schedules on every tick, fields and sink slots within 1e-9;
- 10 steps of tests/test_sinks.py's test_smooth_accretion configuration
  (128 gas, 4 stars, smooth_accretion = 1, alpha_ss = 0.1) the same
  way, the gas masses and the sinks' spin ledger included;
- tests/test_sinks.py's gate of test_block_matches_global_sink_masses
  run through the port, and check.sink_ledger's balance over a burst of
  smooth accretion (port only).

The float64 tolerance is 1e-10 relative for the kernels' plain versions
and 1e-9 for the runs, as for the earlier slices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.integrate import block as jblock
from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import active_grid as jag
from gandalf_tpu.ops import sinks as jsinks
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu.state import make_sph_state as jax_state
from gandalf_tpu_torch.check import (ledger_errors, sink_ledger, smooth_args,
                                     smooth_accretion_inputs)
from gandalf_tpu_torch.convert import (grid_spec_from_jax, schedule_from_jax,
                                       sinks_from_jax, state_from_numpy)
from gandalf_tpu_torch.integrate import block as tblock
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import active_grid as tag
from gandalf_tpu_torch.ops import sinks as tsinks
from gandalf_tpu_torch.params import Parameters
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation
from gandalf_tpu_torch.state import OPEN, PERIODIC

torch.set_num_threads(1)

TOL = 1e-10
F64 = torch.float64
TOL_SIM = 1e-9
FIELDS = ("r", "v", "u", "h", "rho", "gpot")
SINK_FIELDS = ("r", "v", "a", "m", "mdot", "angmom")
N = 96
JCFG = jblock.BlockConfig(nlevels=4, level_diff_max=1)
TCFG = tblock.BlockConfig(nlevels=4, level_diff_max=1)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want), initial=0.0)
                 / max(np.max(np.abs(want), initial=0.0), 1e-300))


# ---------------------------------------------------------------------------
# dt_extra in the ladder
# ---------------------------------------------------------------------------

def _states(seed, level_max=3):
    rng = np.random.default_rng(seed)
    js = jax_state(rng.random((N, 3)), rng.standard_normal((N, 3)),
                   np.full(N, 1.0 / N), 0.1 + 0.05 * rng.random(N),
                   1.0 + rng.random(N))
    level = rng.integers(0, level_max + 1, N).astype(np.int32)
    js = js.replace(level=jnp.asarray(level),
                    levelneib=jnp.asarray(level), t=jnp.asarray(0.75),
                    tlast=jnp.asarray(0.5 * rng.random(N)))
    ts = state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                           for f in dataclasses.fields(js)
                           if getattr(js, f.name) is not None})
    return js, ts, level, rng


def _same_sched(tb, jb, what):
    for f in jblock.BlockSchedule._fields:
        got, want = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {f}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                       err_msg=f"{what} {f}")


def test_init_schedule_dt_extra_matches_jax():
    """A sink bound below every particle's dt deepens the ladder: dt_base
    is the bound over 2^level_max, and the gas sits on higher levels."""
    js, ts, _, rng = _states(1)
    dt_part = 1e-3 * (0.5 + rng.random(N))
    extra = 1e-4
    js2, jb = jblock.init_schedule(JCFG, js, jnp.asarray(dt_part),
                                   dt_extra=jnp.asarray(extra))
    ts2, tb = tblock.init_schedule(TCFG, ts, torch.tensor(dt_part),
                                   dt_extra=torch.tensor(extra, dtype=F64))
    _same_sched(tb, jb, "init")
    for f in ("level", "levelneib", "nlast"):
        np.testing.assert_array_equal(getattr(ts2, f).numpy(),
                                      np.asarray(getattr(js2, f)))
    assert float(tb.dt_base) == pytest.approx(extra, rel=1e-15)
    none = tblock.init_schedule(TCFG, ts, torch.tensor(dt_part))[1]
    assert float(none.dt_base) > float(tb.dt_base)


@pytest.mark.parametrize("n,extra,expect", [
    (7, 1e-5, "resync"),          # n + 1 == nresync: the bound caps dt_min
    (2, 1e-9, "grow_one"),        # far below: level_max grows by one only
    (2, 0.2, "no_change"),        # within level 3 of dt_max: no growth
])
def test_ladder_update_dt_extra_matches_jax(n, extra, expect):
    js, ts, level, rng = _states(2)
    lmax = 3
    nstep = (1 << (lmax - level)).astype(np.int32)
    nlast = ((n // nstep) * nstep).astype(np.int32)
    B = jblock.BlockSchedule(
        n=jnp.asarray(n, jnp.int32), level_max=jnp.asarray(lmax, jnp.int32),
        nresync=jnp.asarray(8, jnp.int32), dt_base=jnp.asarray(1.0 / 8),
        dt_max=jnp.asarray(1.0), nstep_part=jnp.asarray(nstep),
        dt_next=jnp.asarray(0.5 ** level))
    alive = rng.random(N) > 0.1
    active = (n + 1 - nlast) == nstep
    args = (alive, active, level, level, nstep, nlast,
            np.asarray(js.tlast), 0.5 ** level * (1 + 0.1 * rng.random(N)),
            np.int32(n + 1), np.float64(0.8))
    jl, jb = jblock.ladder_update(JCFG, B, *map(jnp.asarray, args),
                                  dt_extra=jnp.asarray(extra))
    tl, tb = tblock.ladder_update(TCFG, schedule_from_jax(B),
                                  *map(torch.tensor, args),
                                  dt_extra=torch.tensor(extra, dtype=F64))
    for k in jl:
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                   rtol=1e-12, atol=0, err_msg=k)
    _same_sched(tb, jb, expect)
    if expect == "resync":
        assert int(tb.n) == 0 and float(tb.dt_max) == pytest.approx(
            extra * 8, rel=1e-15)
    elif expect == "grow_one":
        assert int(tb.level_max) == lmax + 1
    else:
        assert int(tb.level_max) == lmax


# ---------------------------------------------------------------------------
# K20 and K22: plain versions against the JAX functions
# ---------------------------------------------------------------------------

def _jax_sinks(st):
    return jsinks.SinkState(**{f.name: jnp.asarray(getattr(st, f.name)
                                                   .numpy())
                               for f in dataclasses.fields(st)})


@pytest.mark.parametrize("n_slots", [16, 64])
def test_smooth_accretion_plain_matches_jax(n_slots):
    inp = smooth_accretion_inputs(2048, n_slots, "cpu", torch.float64)
    kern = kernel_factory("m4", 3)
    cfg, st = inp["cfg"], inp["sinks"]
    dm, sums = tsinks.smooth_accretion_sums(*smooth_args(kern, inp))
    J = lambda k: jnp.asarray(inp[k].numpy())  # noqa: E731
    jcfg = jsinks.SinkConfig(cfg.rho_sink, cfg.sink_radius, True, True)
    jkern = jax_kernel("m4", 3)

    # one jitted program each: eager JAX compiles each small op anew
    @jax.jit
    def jax_sums(sinks, r, v, m, rho, sound, alive, dt):
        return jsinks.smooth_accretion_sums(
            jcfg, sinks, r, v, m, rho, sound, m, alive, dt, jkern,
            inp["mmean"], alpha_ss=inp["alpha_ss"])

    jdm, jsums = jax_sums(_jax_sinks(st), J("r"), J("v"), J("m"), J("rho"),
                          J("sound"), J("alive"), J("dt"))
    jclaim = np.asarray(jsums["claim"])
    want_claim = np.where(jclaim.any(1), jclaim.argmax(1), -1)
    claim = sums["claim"].numpy()
    np.testing.assert_array_equal(claim, want_claim)
    assert _rel(dm, jdm) <= TOL
    for k in ("menc", "macc", "taccrete", "dmdt"):
        assert _rel(sums[k], jsums[k]) <= TOL, k
    # the edge cases: the tie goes to the lower slot, the dead and the
    # empty slots take no part, gas goes whole and in part
    alive, m = inp["alive"].numpy(), inp["m"].numpy()
    active = st.active.numpy()
    assert claim[4] == 2
    assert (claim[~alive] == -1).all()
    assert active[claim[claim >= 0]].all()
    got = claim >= 0
    assert int((dm.numpy()[got] == m[got]).sum()) > 0
    assert int(((dm.numpy() > 0) & (dm.numpy() < m)).sum()) > 0
    new, m_gas, alive_new = tsinks.apply_smooth_accretion(
        st, inp["r"], inp["v"], inp["m"], dm, sums["claim"], inp["alive"])
    jnew, jm, jalive = jax.jit(jsinks.apply_smooth_accretion)(
        _jax_sinks(st), J("r"), J("v"), J("m"), jdm, jsums["claim"],
        J("alive"))
    for f in ("r", "v", "r0", "v0", "m", "angmom"):
        assert _rel(getattr(new, f), getattr(jnew, f)) <= TOL, f
    assert _rel(m_gas, jm) <= TOL
    np.testing.assert_array_equal(alive_new.numpy(), np.asarray(jalive))
    assert float(new.angmom.abs().max()) > 0


def test_sinks_from_jax_carries_the_ledger():
    """convert.sinks_from_jax copies the spin ledger and the accretion
    rate, and gives zeros where the JAX state leaves them None."""
    inp = smooth_accretion_inputs(256, 16, "cpu", torch.float64)
    st = inp["sinks"]
    rng = np.random.default_rng(8)
    st = st.replace(angmom=torch.tensor(rng.standard_normal((st.N, 3))),
                    mdot=torch.tensor(rng.random(st.N)))
    back = sinks_from_jax(_jax_sinks(st))
    assert torch.equal(back.angmom, st.angmom)
    assert torch.equal(back.mdot, st.mdot)
    bare = sinks_from_jax(_jax_sinks(st)._replace(angmom=None, mdot=None))
    assert not bool(bare.angmom.any()) and not bool(bare.mdot.any())
    assert bare.angmom.shape == (st.N, 3)


@pytest.mark.parametrize("periodic", [True, False])
def test_levelneib_plain_matches_jax(periodic):
    rng = np.random.default_rng(5)
    n = 1500
    code = PERIODIC if periodic else OPEN
    args = (3, (0.0,) * 3, (1.0,) * 3, (code,) * 3, (code,) * 3)
    r = rng.random((n, 3))
    h = 0.06 * (0.7 + 0.6 * rng.random(n))
    level = rng.integers(0, 5, n).astype(np.int32)
    alive = rng.random(n) > 0.05
    jspec = jg.plan_grid27(JaxBox(*args), r, h.max() * 1.3, 2.0)
    J = jnp.asarray

    # _levelneib_pass's formula, as one jitted program
    @jax.jit
    def jax_pass(r, h, level, alive):
        b = jg.bin_particles(jspec, r, discard=~alive)
        ag = jag.gather_active_candidates(jspec, b, r,
                                          jnp.arange(n, dtype=jnp.int32),
                                          alive)
        cid = jnp.maximum(ag.ids, 0)
        d2 = jnp.sum(ag.dr * ag.dr, axis=-1)
        hm = jnp.maximum(h[:, None], h[cid])
        near = ag.mask & (d2 <= (2.0 * hm) ** 2)
        return jnp.max(jnp.where(near, level[cid], 0), axis=-1)

    want = np.asarray(jax_pass(J(r), J(h), J(level), J(alive)))
    got = tag.levelneib_grid27(kernel_factory("m4", 3),
                               grid_spec_from_jax(jspec), torch.tensor(r),
                               torch.tensor(h), torch.tensor(level),
                               torch.tensor(alive))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~alive] == 0).all()
    assert (got.numpy()[alive] >= level[alive]).all()
    assert (got.numpy()[alive] > level[alive]).any()


# ---------------------------------------------------------------------------
# Controller runs
# ---------------------------------------------------------------------------

def _plummer(n_gas, n_star, **over):
    p = Parameters()
    for k, v in dict(run_id="", sim="sph", ndim=3, ic="plummer",
                     Nhydro=n_gas, Nstar=n_star, gasfrac=0.5, starfrac=0.5,
                     self_gravity=1, hydro_forces=1, dimensionless=1,
                     gas_eos="energy_eqn", neib_search="kdtree",
                     sink_particles=1, create_sinks=0, tsnapfirst=1e30,
                     tend=1e30).items():
        p.set(k, v)
    for k, v in over.items():
        p.set(k, v)
    return p


def _setup(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    jsim = JaxSim(jp)
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(params.copy(), device="cpu",
                              dtype=torch.float64)
    tsim.SetupSimulation()
    return jsim, tsim


def _compare(jsim, tsim, where):
    js, ts = jsim.state, tsim.state
    alive = np.asarray(js.alive)
    np.testing.assert_array_equal(ts.alive.numpy(), alive, err_msg=where)
    errs = {}
    for f in FIELDS:
        rows = slice(None) if f == "gpot" else alive
        errs[f] = _rel(getattr(ts, f).numpy()[rows],
                       np.asarray(getattr(js, f))[rows])
    errs["m"] = _rel(ts.m, js.m)
    errs["alpha"] = _rel(ts.alpha, js.alpha)
    for f in ("t", "dt"):
        errs[f] = _rel(getattr(ts, f), getattr(js, f))
    jk, tk = jsim.sinks, ts.sinks
    np.testing.assert_array_equal(tk.active.numpy(), np.asarray(jk.active),
                                  err_msg=where)
    for f in SINK_FIELDS:
        errs[f"sink_{f}"] = _rel(getattr(tk, f), getattr(jk, f))
    if tsim.use_block:
        for f in ("level", "nlast", "levelneib"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f"{where}: {f}")
        jb, tb = jsim._blocksched, tsim._blocksched
        for f in ("n", "level_max", "nresync", "nstep_part"):
            np.testing.assert_array_equal(
                getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                err_msg=f"{where}: {f}")
        errs["dt_base"] = _rel(tb.dt_base, jb.dt_base)
    bad = {k: e for k, e in errs.items() if not e <= TOL_SIM}
    assert not bad, f"{where}: {bad}"
    assert grid_spec_from_jax(jsim.gridspec) == tsim.gridspec, where


def test_hybrid_plummer_block_matches_jax():
    """8 dense ticks with sinks: the stars drift and kick at dt_base,
    the ladder takes their bound, gas is eaten on equal ticks."""
    jsim, tsim = _setup(_plummer(128, 16, Nlevels=3, level_diff_max=1))
    assert tsim.use_block and tsim.has_sinks
    _compare(jsim, tsim, "bootstrap")
    for i in range(8):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _compare(jsim, tsim, f"tick {i + 1}")
    assert tsim.last_tick_rows == [tsim.state.N]
    assert len(np.unique(tsim.state.level.numpy())) >= 2
    assert int((~tsim.state.alive).sum()) > 0


def test_smooth_accretion_matches_jax():
    """10 global steps of smooth accretion: fractional mass removal,
    the spin ledger and the accretion rate as in the JAX package; mass
    conserved."""
    jsim, tsim = _setup(_plummer(128, 4, smooth_accretion=1, alpha_ss=0.1))
    assert tsim.smooth_accretion
    _compare(jsim, tsim, "bootstrap")
    s = tsim.state
    m0 = float(s.m.sum() + s.sinks.m[s.sinks.active].sum())
    for i in range(10):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _compare(jsim, tsim, f"step {i + 1}")
    s = tsim.state
    m1 = float(s.m[s.alive].sum() + s.sinks.m[s.sinks.active].sum())
    assert m1 == pytest.approx(m0, rel=1e-12)
    m = s.m[s.alive]
    assert bool(((m > 0) & (m < 0.99 * m.max())).any())


def test_block_matches_global_sink_masses():
    """tests/test_sinks.py's gate through the port: the hybrid Plummer
    with accretion, block-stepped (Nlevels = 3) to the time of 12 global
    steps: mass conserved, and the sinks' total mass within 15% of the
    global-timestep run's."""
    ref = GradhSphSimulation(_plummer(128, 16), device="cpu",
                             dtype=torch.float64)
    ref.SetupSimulation()
    for _ in range(12):
        ref.main_loop_step()
    sim = GradhSphSimulation(_plummer(128, 16, Nlevels=3, level_diff_max=1),
                             device="cpu", dtype=torch.float64)
    sim.SetupSimulation()
    assert sim.use_block

    def totals(x):
        s = x.state
        return (float(s.m[s.alive].sum()),
                float(s.sinks.m[s.sinks.active].sum()))

    m0 = sum(totals(sim))
    n = 0
    while sim.t < ref.t and n < 2000:
        sim.main_loop_step()
        n += 1
    assert sim.t >= ref.t
    assert sum(totals(sim)) == pytest.approx(m0, rel=1e-12)
    ms_ref, ms_blk = totals(ref)[1], totals(sim)[1]
    assert ms_blk > 0 and ms_ref > 0
    assert ms_blk == pytest.approx(ms_ref, rel=0.15)
    assert bool(torch.isfinite(sim.state.r).all())
    assert bool(torch.isfinite(sim.state.sinks.r).all())


def test_sink_ledger_counts_partial_accretion():
    """check.sink_ledger over a burst of smooth accretion: each call's
    sink gain in mass and momentum equals what the gas gave up, the gas
    that only lost part of its mass included."""
    sim = GradhSphSimulation(_plummer(128, 4, smooth_accretion=1,
                                      alpha_ss=0.1), device="cpu",
                             dtype=torch.float64)
    sim.SetupSimulation()
    rows = sink_ledger(sim)
    done = 0
    while done < 6:
        done += sim.main_loop_steps(6 - done)
    em, ep, m_given = ledger_errors(rows)
    assert len(em) == 6
    assert max(em) <= 1e-12 and max(ep) <= 1e-12
    assert sum(m_given) > 0
    s = sim.state
    m = s.m[s.alive]
    assert bool(((m > 0) & (m < 0.99 * m.max())).any())
