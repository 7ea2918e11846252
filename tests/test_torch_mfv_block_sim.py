"""Port parity: the block-timestep meshless finite-volume slice
(MfvMusclSimulation with Nlevels > 1) through the port's controller on
the CPU against gandalf_tpu's, float64, 8 ticks from one IC.

After the bootstrap and every tick: the state (r, v, u, m, h, rho,
Qcons0, dQ, dQdt, rdmdt, a, and gpot with gravity) within 1e-9 of each
field's largest value; level, levelneib, nlast and the schedule's
integers equal; dt_base and dt_max within 1e-12 (minima of per-particle
timesteps, each rounded once); the same grid and tree plans.  Cases: the
KHI at 32x16 + 32x16 under each time_step_limiter (none, simple,
conservative) from its jittered lattice (on an exact lattice a flux
term that is 0 by symmetry is rounding noise in one order of the sums
and 0 in another, ROADMAP fault F25), the 1D Sod tube (64 + 16) under
simple, a cold sphere of 280 particles with the quadrupole tree and
conservative, and the radws MFV box at 6^3 with gravity, whose commit
folds the implicit heating in over each particle's own step.  The
trees are replanned once, before tick 7.  Also: mass kept to rounding
(zero mass flux) and convert's round trip of the block fields and the
schedule."""

import numpy as np
import pytest
import torch

from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim import mfv_sim as jax_mfv
from gandalf_tpu.sim.ic import generate_ic as jax_generate_ic
from gandalf_tpu.sim.simulation import SimulationBase as JaxSim
from gandalf_tpu_torch.check import (jittered_box_ic, jittered_lattice_ic,
                                     mfv_khi_params, mfv_params,
                                     mfv_sod_params, radws_params,
                                     sphere_block_params)
from gandalf_tpu_torch.convert import (grid_spec_from_jax,
                                       mfv_state_from_jax,
                                       mfv_state_to_numpy, schedule_from_jax,
                                       tree_spec_from_jax)
from gandalf_tpu_torch.sim.simulation import SimulationBase

torch.set_num_threads(1)

TOL_SIM = 1e-9
TICKS = 8
NTB = 6
SIM_FIELDS = ("r", "v", "u", "m", "h", "rho", "Qcons0", "dQ", "dQdt",
              "rdmdt", "a")
SCHED_INTS = ("n", "level_max", "nresync", "nstep_part")


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _khi(limiter):
    p = mfv_khi_params(16, Nlevels=3, time_step_limiter=limiter)
    for k in (0, 1):
        p.set(f"Nlattice1[{k}]", 32 if k == 0 else 16)
        p.set(f"Nlattice2[{k}]", 32 if k == 0 else 16)
    return p, jittered_lattice_ic(p)


def _sphere():
    p = sphere_block_params(300, tend=1.0, ntreebuildstep=NTB)
    p.set("sim", "mfvmuscl")
    p.set("time_step_limiter", "conservative")
    jp = _jax_params(p)
    ic = jax_generate_ic(jp, None)
    return p, {k: np.asarray(ic[k]) for k in ("r", "v", "m", "h", "u")}


def _radws():
    p = radws_params(mfv_params(6, 1, 1.0))
    p.set("Nlevels", 3)
    p.set("ntreebuildstep", NTB)
    return p, jittered_box_ic(p, 6)


CASES = {
    "khi_none": lambda: _khi("none"),
    "khi_simple": lambda: _khi("simple"),
    "khi_conservative": lambda: _khi("conservative"),
    "tube_simple": lambda: (mfv_sod_params(64, 16, 1.0, Nlevels=3,
                                           time_step_limiter="simple"),
                            None),
    "sphere_gravity": _sphere,
    "radws_box": _radws,
}


def _errors(jsim, tsim):
    errs = {}
    for f in SIM_FIELDS + (("gpot",) if tsim.self_gravity else ()):
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        errs[f] = np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-300)
    errs["t"] = abs(float(tsim.state.t) - float(jsim.state.t)) / max(
        abs(float(jsim.state.t)), 1e-300)
    jb, tb = jsim._blocksched, tsim._blocksched
    for f in ("dt_base", "dt_max"):
        errs[f] = abs(float(getattr(tb, f)) - float(getattr(jb, f))) \
            / float(getattr(jb, f))
    return errs


def _exact(jsim, tsim):
    """Whether the levels, levelneib, nlast and the schedule's integers
    are equal."""
    same = all(np.array_equal(getattr(tsim.state, f).numpy(),
                              np.asarray(getattr(jsim.state, f)))
               for f in ("level", "levelneib", "nlast"))
    return same and all(
        np.array_equal(getattr(tsim._blocksched, f).numpy(),
                       np.asarray(getattr(jsim._blocksched, f)))
        for f in SCHED_INTS)


@pytest.fixture(scope="module", params=list(CASES))
def ticks(request):
    """Both controllers through their bootstrap and TICKS ticks from one
    IC: per tick the errors, whether the integers agree and whether the
    grid (and tree) plans agree; the mass before and after."""
    params, ic = CASES[request.param]()
    jsim = JaxSim.factory(_jax_params(params))
    with pytest.MonkeyPatch.context() as mp:
        if ic is not None:
            mp.setattr(jax_mfv, "generate_ic",
                       lambda p, eos: {k: v.copy() for k, v in ic.items()})
        jsim.SetupSimulation()
    tsim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
    tsim.SetupSimulation(None if ic is None
                         else {k: v.copy() for k, v in ic.items()})
    assert jsim.use_block and tsim.use_block and jsim.use_celllist
    out = {"case": request.param, "errors": [_errors(jsim, tsim)],
           "exact": [_exact(jsim, tsim)], "plans": [], "jsim": jsim,
           "tsim": tsim, "m0": float(tsim.state.m.sum())}
    for _ in range(TICKS):
        jsim.main_loop_step()
        tsim.main_loop_step()
        out["errors"].append(_errors(jsim, tsim))
        out["exact"].append(_exact(jsim, tsim))
        out["plans"].append(
            grid_spec_from_jax(jsim.gridspec) == tsim.gridspec
            and (tsim.treespec is None
                 or tree_spec_from_jax(jsim.treespec) == tsim.treespec))
    return out


def test_ticks_match_jax(ticks):
    """State within 1e-9 of each field's largest value after the
    bootstrap and every tick, levels, levelneib, nlast and the
    schedule's integers equal, dt_base and dt_max within 1e-12 (they are
    minima of per-particle timesteps, each rounded once), the same grid
    and tree plans."""
    for i, errs in enumerate(ticks["errors"]):
        state = {k: e for k, e in errs.items()
                 if k not in ("dt_base", "dt_max")}
        assert max(state.values()) <= TOL_SIM, (i, errs)
        assert max(errs["dt_base"], errs["dt_max"]) <= 1e-12, (i, errs)
    assert all(ticks["exact"]), ticks["exact"]
    assert all(ticks["plans"])
    tsim = ticks["tsim"]
    assert tsim.Nsteps == TICKS and int(tsim._blocksched.level_max) >= 1


def test_ladder_is_used_and_mass_conserved(ticks):
    """More than one occupied level during the run, and the total mass
    kept to rounding (zero mass flux: every pair's mass flux is 0)."""
    tsim = ticks["tsim"]
    assert len(np.unique(tsim.state.level.numpy())) >= 2 or int(
        tsim._blocksched.level_max) >= 1
    assert float(tsim.state.m.sum()) == pytest.approx(ticks["m0"],
                                                      rel=1e-13)


def test_schedule_and_state_round_trip(ticks):
    """convert: the JAX block fields and schedule carried across equal
    the port's after the same ticks (to the tick tolerance), and
    mfv_state_to_numpy gives every field back."""
    jsim, tsim = ticks["jsim"], ticks["tsim"]
    st = mfv_state_from_jax(jsim.state)
    back = mfv_state_to_numpy(st)
    for f in ("dQ", "dQdt", "rdmdt", "rdmdt0", "level", "levelneib",
              "nlast", "tlast"):
        assert np.array_equal(back[f], np.asarray(getattr(jsim.state, f)))
        want = back[f]
        err = np.max(np.abs(getattr(tsim.state, f).numpy() - want)) / max(
            np.max(np.abs(want)), 1e-300)
        assert err <= TOL_SIM, (f, err)
    sched = schedule_from_jax(jsim._blocksched)
    for f in SCHED_INTS:
        assert torch.equal(getattr(sched, f), getattr(tsim._blocksched, f))
