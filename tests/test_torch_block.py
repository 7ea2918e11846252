"""Port parity: each function of integrate/block.py against gandalf_tpu's
(float64, CPU) on states made from a numpy seed.

The schedules cover the resync tick (n == nresync), level_max growth,
its shrink at an even tick, Saitoh-Makino reductions and natural level
drops; each case also checks that its branch was taken.  Integers must
match exactly, floats within 1e-12."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.integrate import block as jblock
from gandalf_tpu.state import make_sph_state as jax_state
from gandalf_tpu_torch.convert import (schedule_from_jax, schedule_to_jax,
                                       state_from_numpy)
from gandalf_tpu_torch.integrate import block as tblock

torch.set_num_threads(1)

TOL = 1e-12
N = 96
JCFG = jblock.BlockConfig(nlevels=4, level_diff_max=1)
TCFG = tblock.BlockConfig(nlevels=4, level_diff_max=1)


def _states(seed=0, level_max=3):
    """A random mid-run state on a ladder of depth `level_max` (JAX and
    port): levels 0..level_max, levelneib at or above the level, nlast
    at the start of each particle's current step."""
    rng = np.random.default_rng(seed)
    js = jax_state(rng.random((N, 3)), rng.standard_normal((N, 3)),
                   np.full(N, 1.0 / N), 0.1 + 0.05 * rng.random(N),
                   1.0 + rng.random(N))
    level = rng.integers(0, level_max + 1, N).astype(np.int32)
    nstep = (1 << (level_max - level)).astype(np.int32)
    fields = {
        "a": rng.standard_normal((N, 3)), "a0": rng.standard_normal((N, 3)),
        "r0": rng.random((N, 3)), "v0": rng.standard_normal((N, 3)),
        "u0": 1.0 + rng.random(N), "dudt": rng.standard_normal(N),
        "dudt0": rng.standard_normal(N), "level": level,
        "levelneib": (level + rng.integers(0, 3, N)).astype(np.int32),
        "tlast": 0.5 * rng.random(N), "t": np.float64(0.75),
    }
    js = js.replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                           for f in dataclasses.fields(js)
                           if getattr(js, f.name) is not None})
    return js, ts, nstep, rng


def _schedule(nstep, n, level_max, rng, dt_max=1.0):
    """A JAX schedule at tick counter n; each particle's nlast is the
    start of its current step, so some end their step at n + 1."""
    nresync = 1 << level_max
    # a step in progress: n + 1 - nlast in 1..nstep, at multiples of nstep
    nlast = (n // nstep) * nstep
    B = jblock.BlockSchedule(
        n=jnp.asarray(n, jnp.int32), level_max=jnp.asarray(level_max,
                                                           jnp.int32),
        nresync=jnp.asarray(nresync, jnp.int32),
        dt_base=jnp.asarray(dt_max / nresync),
        dt_max=jnp.asarray(dt_max), nstep_part=jnp.asarray(nstep),
        dt_next=jnp.asarray(dt_max / 2.0 ** rng.integers(0, level_max + 1,
                                                         len(nstep))))
    return B, nlast.astype(np.int32)


def _with_nlast(js, ts, nlast):
    return (js.replace(nlast=jnp.asarray(nlast)),
            ts.replace(nlast=torch.tensor(nlast)))


def _same(got, want, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=what)


def _same_state(ts, js, fields, what):
    for f in fields:
        _same(getattr(ts, f), getattr(js, f), f"{what}: {f}")


def _same_sched(tb, jb, what):
    for f in jblock.BlockSchedule._fields:
        _same(getattr(tb, f), getattr(jb, f), f"{what}: {f}")


def test_compute_timestep_level_matches_jax():
    """Including ratios that are exact powers of two, where a log2 other
    than log(x)/ln 2 would flip the level."""
    rng = np.random.default_rng(3)
    dt_max = 1.0
    dt = np.concatenate([dt_max / 2.0 ** np.arange(0, 25),
                         dt_max * rng.random(200) ** 4, [0.0, 2.0, 1e-40]])
    got = tblock.compute_timestep_level(torch.tensor(dt),
                                        torch.tensor(dt_max))
    want = jblock.compute_timestep_level(jnp.asarray(dt),
                                         jnp.asarray(dt_max))
    _same(got, want, "level")
    assert got.dtype == torch.int32 and int(got.max()) == tblock.LEVEL_CAP


def test_init_schedule_matches_jax():
    js, ts, _, rng = _states(1)
    dt_part = 1e-3 * (0.5 + rng.random(N))
    js2, jb = jblock.init_schedule(JCFG, js, jnp.asarray(dt_part))
    ts2, tb = tblock.init_schedule(TCFG, ts, torch.tensor(dt_part))
    _same_state(ts2, js2, ("level", "levelneib", "nlast", "tlast"), "init")
    _same_sched(tb, jb, "init")
    assert len(np.unique(np.asarray(js2.level))) >= 2


def test_advance_matches_jax():
    js, ts, nstep, rng = _states(2)
    B, nlast = _schedule(nstep, 5, 3, rng)
    js, ts = _with_nlast(js, ts, nlast)
    for mode in ("energy", "none"):
        js2, ja, jt = jblock.advance(js, B, mode)
        ts2, ta, tt = tblock.advance(ts, schedule_from_jax(B), mode)
        _same_state(ts2, js2, ("r", "v", "u"), mode)
        _same(ta, ja, "active")
        _same(tt, jt, "t")
        assert 0 < int(ta.sum()) < N


def test_check_timesteps_saitoh_makino_matches_jax():
    js, ts, nstep, rng = _states(4)
    B, nlast = _schedule(nstep, 3, 3, rng)
    js, ts = _with_nlast(js, ts, nlast)
    _, ja, _ = jblock.advance(js, B, "energy")
    _, ta, _ = tblock.advance(ts, schedule_from_jax(B), "energy")
    jout = jblock.check_timesteps(JCFG, js, B, ja)
    tout = tblock.check_timesteps(TCFG, ts, schedule_from_jax(B), ta)
    for name, got, want in zip(("active", "nstep", "level"), tout, jout):
        _same(got, want, name)
    # some inactive particles end their step early
    assert int((tout[0] & ~ta).sum()) > 0


# (tick counter n, level_max, dt_crit scale against dt_max, branch)
CASES = {
    "resync": (7, 3, 0.1, lambda B0, B1, js0, js1, act: int(B1.n) == 0
               and int(B0.n) + 1 == int(B0.nresync)),
    "growth": (2, 3, 1.0 / 64, lambda B0, B1, js0, js1, act:
               int(B1.level_max) > int(B0.level_max)),
    "shrink_even_tick": (3, 3, 2.0, lambda B0, B1, js0, js1, act:
                         int(B1.level_max) == int(B0.level_max) - 1),
    "natural_drop": (7, 4, 4.0, lambda B0, B1, js0, js1, act: bool(np.any(
        np.asarray(js1.level)[act] < np.asarray(js0.level)[act]))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_end_timestep_matches_jax(case):
    """The closing kick, level moves and ladder update of each branch,
    with the Saitoh-Makino reductions of check_timesteps fed in."""
    n, level_max, scale, taken = CASES[case]
    js, ts, nstep, rng = _states(5, level_max=level_max)
    if case == "shrink_even_tick":
        # nothing on the deepest level: its step has to end on this tick
        lv = np.minimum(np.asarray(js.level), level_max - 1).astype(np.int32)
        nstep = (1 << (level_max - lv)).astype(np.int32)
        js = js.replace(level=jnp.asarray(lv), levelneib=jnp.asarray(lv))
        ts = ts.replace(level=torch.tensor(lv), levelneib=torch.tensor(lv))
    B, nlast = _schedule(nstep, n, level_max, rng)
    js, ts = _with_nlast(js, ts, nlast)
    tB = schedule_from_jax(B)
    js1, ja, jt = jblock.advance(js, B, "energy")
    ts1, ta, tt = tblock.advance(ts, tB, "energy")
    ja2, jn, jl = jblock.check_timesteps(JCFG, js1, B, ja)
    ta2, tn, tl = tblock.check_timesteps(TCFG, ts1, tB, ta)
    dt_crit = B.dt_max * scale * (1.0 + 0.5 * rng.random(N))
    js2, jB = jblock.end_timestep(JCFG, js1, B, ja2, jl, jn,
                                  jnp.asarray(dt_crit), jt, "energy")
    ts2, tB2 = tblock.end_timestep(TCFG, ts1, tB, ta2, tl, tn,
                                   torch.tensor(dt_crit), tt, "energy")
    _same_state(ts2, js2, ("v", "u", "r0", "v0", "a0", "u0", "dudt0",
                           "level", "levelneib", "nlast", "tlast", "t",
                           "dt"), case)
    _same_sched(tB2, jB, case)
    assert taken(B, jB, js1, js2, np.asarray(ja2)), case
    # round trip of the schedule through numpy
    back = schedule_to_jax(tB2)
    assert back["n"].dtype == np.int32
    _same_sched(schedule_from_jax(jblock.BlockSchedule(
        **{k: jnp.asarray(v) for k, v in back.items()})), jB, "round trip")


def test_ladder_update_resync_matches_jax():
    """The resync rebuild alone, dead particles left on level_max."""
    js, ts, nstep, rng = _states(6)
    B, nlast = _schedule(nstep, 7, 3, rng)
    alive = rng.random(N) > 0.1
    active = rng.random(N) > 0.5
    args = (alive, active, np.asarray(js.level), np.asarray(js.levelneib),
            nstep, nlast, np.asarray(js.tlast),
            1e-3 * (0.2 + rng.random(N)), np.int32(8), np.float64(1.0))
    jl, jB = jblock.ladder_update(JCFG, B, *map(jnp.asarray, args))
    tl, tB = tblock.ladder_update(TCFG, schedule_from_jax(B),
                                  *map(torch.tensor, args))
    for k in jl:
        _same(tl[k], jl[k], k)
    _same_sched(tB, jB, "resync")
    assert int(tB.n) == 0
