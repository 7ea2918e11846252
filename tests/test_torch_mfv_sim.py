"""Port parity: the meshless finite-volume box (mfv_box: the benchmark's
jittered lattice run through MfvMusclSimulation, HLLC, the Gizmo
limiter, zero mass flux, global timestep) through the port's controller
on the CPU against gandalf_tpu's MfvMusclSimulation, float64, at 8^3:
without self-gravity, and with the quadrupole tree rebuilt every 2
steps.  Also a forced neighbour overflow that both replan on the same
step to the same grid, and the JAX package's own energy drift, which
chip_smoke.py's MFV energy gate refers to.

The JAX controller takes no IC argument: the jittered IC is handed to it
by replacing gandalf_tpu.sim.mfv_sim.generate_ic for the duration of its
setup."""

import dataclasses

import numpy as np
import pytest
import torch

from gandalf_tpu.sim import mfv_sim as jax_mfv
from gandalf_tpu_torch.check import jittered_box_ic, mfv_params
from gandalf_tpu_torch.convert import (grid_spec_from_jax,
                                       mfv_state_from_jax,
                                       tree_spec_from_jax)
from gandalf_tpu_torch.sim.simulation import SimulationBase

torch.set_num_threads(1)

TOL = 1e-9
FIELDS = ("r", "v", "u", "m", "h", "rho", "Qcons0", "a")
STEPS = 5
N_SIDE = 8
# chip_smoke.py's MFV energy gate over its 32 timed steps at 64^3
MFV_ENERGY_GATE = 2e-3


def _params(self_gravity):
    p = mfv_params(N_SIDE, self_gravity)
    if self_gravity:
        p.set("ntreebuildstep", 2)
    return p


def _pair(self_gravity, k_cell=None):
    """The JAX and the port's controller after setup, from one IC; the
    JAX one counts its tree plans.  With `k_cell`, both then take a grid
    with that many slots per cell."""
    ic = jittered_box_ic(_params(self_gravity), N_SIDE)
    jsim = jax_mfv.MfvMusclSimulation(_params(self_gravity))
    plan = jsim._plan_tree_buckets
    jsim.n_plans = 0

    def counted(*args, **kw):
        jsim.n_plans += 1
        return plan(*args, **kw)

    jsim._plan_tree_buckets = counted
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mfv, "generate_ic",
                   lambda p, eos: {k: v.copy() for k, v in ic.items()})
        jsim.SetupSimulation()
    tsim = SimulationBase.factory(_params(self_gravity), "cpu", torch.float64)
    tsim.SetupSimulation({k: v.copy() for k, v in ic.items()})
    if k_cell is not None:
        small = dataclasses.replace(jsim.gridspec, k_cell=k_cell)
        jsim.gridspec = small
        jsim._compile()
        tsim.gridspec = grid_spec_from_jax(small)
    return jsim, tsim


def _errors(jsim, tsim):
    errs = {}
    for f in FIELDS + (("gpot",) if tsim.self_gravity else ()):
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        errs[f] = np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-300)
    for f in ("t", "dt"):
        want = float(getattr(jsim.state, f))
        got = float(getattr(tsim.state, f))
        errs[f] = abs(got - want) / max(abs(want), 1e-300)
    return errs


def _energy(s):
    return float(np.sum(np.asarray(s.Qcons0)[:, 4])
                 - 0.5 * np.sum(np.asarray(s.m) * np.asarray(s.gpot)))


def _run(self_gravity):
    jsim, tsim = _pair(self_gravity)
    out = {"errors": [_errors(jsim, tsim)], "plans": [], "specs": [],
           "energy": []}
    for _ in range(STEPS):
        jsim.main_loop_step()
        tsim.main_loop_step()
        out["errors"].append(_errors(jsim, tsim))
        out["plans"].append((jsim.n_plans, tsim._n_tree_plans))
        out["specs"].append(
            grid_spec_from_jax(jsim.gridspec) == tsim.gridspec
            and (tsim.treespec is None
                 or tree_spec_from_jax(jsim.treespec) == tsim.treespec))
        out["energy"].append(_energy(jsim.state))
    out["nsteps"] = (jsim.Nsteps, tsim.Nsteps)
    out["jax_state"] = jsim.state
    return out


@pytest.fixture(scope="module")
def hydro():
    return _run(0)


@pytest.fixture(scope="module")
def gravity():
    return _run(1)


@pytest.mark.parametrize("which", ["hydro", "gravity"])
def test_five_steps_match_jax(which, request):
    """r, v, u, m, h, rho, Qcons0, a (and gpot), t and dt within 1e-9
    after the bootstrap and every step; the same grid and tree plans on
    every step (with self-gravity a rebuild every 2 steps)."""
    out = request.getfixturevalue(which)
    for i, errs in enumerate(out["errors"]):
        assert max(errs.values()) <= TOL, (i, errs)
    assert all(out["specs"])
    for jp, tp in out["plans"]:
        assert jp == tp
    if which == "gravity":
        # the bootstrap plan, then rebuilds at steps 2 and 4
        assert out["plans"][-1][1] == 3
    assert out["nsteps"] == (STEPS, STEPS)


def test_state_converts_from_jax(gravity):
    """convert.mfv_state_from_jax carries the JAX MfvState across: the
    same fields, bad_grad as a float flag, the block fields as the JAX
    state holds them (zeros at a global timestep)."""
    js = gravity["jax_state"]
    s = mfv_state_from_jax(js)
    for f in FIELDS + ("gpot", "B", "grad", "alpha_slope", "ndens"):
        assert np.array_equal(getattr(s, f).numpy(),
                              np.asarray(getattr(js, f)))
    assert s.bad_grad.dtype == torch.float64
    for f in ("dQ", "dQdt", "rdmdt", "rdmdt0", "level", "levelneib",
              "nlast", "tlast"):
        assert np.array_equal(getattr(s, f).numpy(),
                              np.asarray(getattr(js, f))), f
    assert int(s.nstep) == STEPS
    assert torch.equal(s.Wprim, torch.tensor(np.asarray(js.Wprim)))


def test_jax_energy_drift(gravity):
    """The JAX package's own drift of sum Q_E - sum m gpot / 2 over steps
    1-5 at 8^3 (gpot is first set by step 1), which chip_smoke.py's gate
    (2e-3 over 32 steps at 64^3) refers to."""
    e = gravity["energy"]
    drift = abs(e[-1] - e[0]) / abs(e[0])
    print(f"gandalf_tpu mfv_box at 8^3, float64: energy drift over steps "
          f"1-{STEPS} = {drift:.3e}")
    assert 0.0 < drift < MFV_ENERGY_GATE


def test_overflow_replans_like_jax():
    """Starting from a slot count too small for the grid, both packages
    overflow on the same step, replan from the pre-step state to the same
    grid and redo the step."""
    jsim, tsim = _pair(0, k_cell=60)
    small_k = jsim.gridspec.k_cell
    for i in range(2):
        jsim.main_loop_step()
        tsim.main_loop_step()
        assert grid_spec_from_jax(jsim.gridspec) == tsim.gridspec, i
        errs = _errors(jsim, tsim)
        assert max(errs.values()) <= TOL, (i, errs)
    assert tsim._n_grid_overflows == 1
    assert tsim.gridspec.k_cell > small_k
    assert not bool(tsim.state.neib_overflow)


def _port(self_gravity=0, tend=1.0e30, k_cell=None):
    p = mfv_params(N_SIDE, self_gravity, tend)
    sim = SimulationBase.factory(p, "cpu", torch.float64)
    sim.SetupSimulation(jittered_box_ic(p, N_SIDE))
    if k_cell is not None:
        sim.gridspec = dataclasses.replace(sim.gridspec, k_cell=k_cell)
    return sim


PORT_FIELDS = FIELDS + ("B", "grad", "alpha_slope", "t", "dt")


def test_burst_matches_single_steps():
    """main_loop_steps queues a burst and reads back once; the result is
    that of the same number of single steps."""
    burst, single = _port(1), _port(1)
    assert burst.main_loop_steps(4) == 4
    for _ in range(4):
        single.main_loop_step()
    for f in PORT_FIELDS + ("gpot",):
        assert torch.equal(getattr(burst.state, f),
                           getattr(single.state, f)), f


def test_burst_stops_at_tend():
    """A burst across tend ends at tend, never past it: each step's dt is
    clamped on the device to tend - t (ROADMAP fault F3)."""
    probe = _port()
    dt_nat = float(probe.state.dt)
    tend = 2.5 * dt_nat
    sim = _port(tend=tend)
    sim.state = sim.state.replace(dt=sim.state.dt * 1e-3)
    times = []
    step = sim._step_fn

    def recorded(s):
        out = step(s)
        times.append(float(out.t))
        return out

    sim._step_fn = recorded
    assert sim.main_loop_steps(8) == 8
    assert max(times) <= tend
    assert sim.t == pytest.approx(tend, abs=1e-12 * tend)


def test_burst_overflow_replays_step_by_step():
    """An overflow inside a burst is sticky to its end; the burst rewinds
    and replans at the offending step, ending where single steps end."""
    burst, single = _port(k_cell=60), _port(k_cell=60)
    flagged = single.state.replace(neib_overflow=torch.tensor(True))
    assert bool(single._step_fn(flagged).neib_overflow)
    assert burst.main_loop_steps(3) == 3
    for _ in range(3):
        single.main_loop_step()
    assert burst._n_grid_overflows == single._n_grid_overflows == 1
    assert burst.gridspec == single.gridspec
    for f in PORT_FIELDS:
        assert torch.equal(getattr(burst.state, f),
                           getattr(single.state, f)), f


@pytest.mark.parametrize("settings,item", [
    ({"kernel": "quintic"}, "item 9"),
    ({"gas_eos": "locally_isothermal"}, "F20"),
    ({"ndim": 1, "ewald": 1}, "requires a 3D box"),
    ({"sink_particles": 1}, "F16"),
    ({"sim": "mfvrk", "Nlevels": 3}, "RK2 block coupling"),
    ({"rad_fb": 1}, "F21"),
    ({"boundary_lhs[0]": "mirror"}, "item 8")],
    ids=["quintic", "locally_isothermal", "gravity_1d", "sinks",
         "mfvrk_Nlevels", "rad_fb", "mirror"])
def test_options_outside_the_slice_raise(settings, item):
    """What the MFV controllers still refuse, each naming its ROADMAP
    item or fault: a kernel other than M4 (item 9), the locally
    isothermal EOS (F20), the Ewald sum of a periodic box below 3D (the
    JAX package's reason; self-gravity itself runs there), sinks (F16),
    RK2 with block timesteps (the JAX package refuses that too),
    radiative feedback (F21) and mirror walls."""
    p = mfv_params(N_SIDE, self_gravity=1)
    for key, value in settings.items():
        p.set(key, value)
    with pytest.raises(NotImplementedError, match=item):
        SimulationBase.factory(p, "cpu", torch.float64).process_parameters()
