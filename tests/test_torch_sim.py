"""Port parity: the hydro-only grad-h SPH slice (bench configuration
without self-gravity, jittered lattice) through the port's controller on
the CPU against gandalf_tpu's GradhSphSimulation, float64."""

import dataclasses

import numpy as np
import pytest
import torch

from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu_torch.check import jittered_box_ic, slice_params
from gandalf_tpu_torch.convert import grid_spec_from_jax
from gandalf_tpu_torch.sim.simulation import (GradhSphSimulation,
                                              SimulationBase)

torch.set_num_threads(1)

TOL = 1e-9
FIELDS = ("r", "v", "u", "h", "rho")


def _pair(n_side, tend=1.0):
    ic = jittered_box_ic(slice_params(n_side), n_side)
    jsim = JaxSim(slice_params(n_side, tend))
    # staged arrays take the generated IC's place (ImportArray's route)
    jsim.restart_data = {k: v.copy() for k, v in ic.items()}
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(slice_params(n_side, tend), device="cpu",
                              dtype=torch.float64)
    tsim.SetupSimulation({k: v.copy() for k, v in ic.items()})
    return jsim, tsim


def _assert_same(jsim, tsim, where):
    for f in FIELDS:
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err <= TOL, f"{where}: {f} differs by {err:.3e} of max"
    for f in ("t", "dt"):
        want = float(getattr(jsim.state, f))
        got = float(getattr(tsim.state, f))
        assert abs(got - want) <= TOL * abs(want), f"{where}: {f}"


@pytest.mark.parametrize("n_side", [8, 16])
def test_ten_steps_match_jax(n_side):
    jsim, tsim = _pair(n_side)
    assert grid_spec_from_jax(jsim.gridspec) == tsim.gridspec
    _assert_same(jsim, tsim, "bootstrap")
    for i in range(10):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _assert_same(jsim, tsim, f"step {i + 1}")
    assert tsim.Nsteps == jsim.Nsteps == 10
    assert tsim.t == pytest.approx(jsim.t, rel=TOL)


def test_overflow_replans_like_jax():
    """Starting from a slot count too small for the grid, both packages
    overflow on the same step and replan to the same grid."""
    jsim, tsim = _pair(8)
    small = dataclasses.replace(jsim.gridspec, k_cell=40)
    jsim.gridspec = small
    jsim._compile()
    tsim.gridspec = grid_spec_from_jax(small)
    n_j0 = getattr(jsim, "_n_grid_overflows", 0)
    n_t0 = tsim._n_grid_overflows
    for i in range(3):
        jsim.main_loop_step()
        tsim.main_loop_step()
        assert (tsim._n_grid_overflows - n_t0
                == getattr(jsim, "_n_grid_overflows", 0) - n_j0), i
        assert grid_spec_from_jax(jsim.gridspec) == tsim.gridspec, i
        _assert_same(jsim, tsim, f"step {i + 1}")
    assert tsim._n_grid_overflows - n_t0 == 1
    assert tsim.gridspec.k_cell > small.k_cell


def test_burst_matches_single_steps():
    """main_loop_steps queues a burst and reads back once; the result is
    that of the same number of single steps."""
    tsim = GradhSphSimulation(slice_params(8), device="cpu",
                              dtype=torch.float64)
    ic = jittered_box_ic(slice_params(8), 8)
    tsim.SetupSimulation(ic)
    ref = GradhSphSimulation(slice_params(8), device="cpu",
                             dtype=torch.float64)
    ref.SetupSimulation(ic)
    assert tsim.main_loop_steps(4) == 4
    for _ in range(4):
        ref.main_loop_step()
    assert tsim.Nsteps == ref.Nsteps == 4
    for f in FIELDS + ("t", "dt"):
        assert torch.equal(getattr(tsim.state, f), getattr(ref.state, f)), f


def test_run_lands_on_tend():
    tsim = GradhSphSimulation(slice_params(8, tend=2e-3), device="cpu",
                              dtype=torch.float64)
    tsim.Run()
    assert tsim.t == pytest.approx(2e-3, rel=1e-12)


@pytest.mark.parametrize("key,value", [("self_gravity", 1),
                                       ("kernel", "gaussian"),
                                       ("dust_forces", "full_twofluid"),
                                       ("ndim", 2),
                                       ("gas_eos", "locally_isothermal"),
                                       pytest.param(
                                           "gas_eos", "locally_isothermal",
                                           id="locally_isothermal-sinks"),
                                       ("neib_search", "bruteforce"),
                                       pytest.param(
                                           "boundary_lhs[0]", "mirror",
                                           id="sinks-mirror_walls"),
                                       ("sim", "mfvmuscl")])
def test_options_outside_the_slice_raise(key, value, request):
    """Options the port does not run raise: the gaussian kernel with
    sinks (its softened gravity is zero in the JAX package: fault F23),
    the
    locally isothermal EOS (also with sinks), dust with sinks (ROADMAP
    fault F14), sinks with mirror walls, sinks in the MFV controller
    (which the JAX package's ignores: fault F16), self-gravity (which runs every walk
    option, the Ewald sum of this periodic box included) with octtree
    buckets, and a 2D run (which the grid path now takes, with block
    timesteps, self-gravity, sinks and radiation too) with sinks and
    supernova feedback (item 9)."""
    p = slice_params(8)
    case = request.node.callspec.id
    if key == "ndim":
        p.set("sink_particles", 1)
        p.set("supernova_feedback", "single")
    if key in ("sim", "dust_forces", "kernel") or case in (
            "locally_isothermal-sinks", "sinks-mirror_walls"):
        p.set("sink_particles", 1)
    if case == "sinks-mirror_walls":
        p.set("boundary_rhs[0]", "mirror")
    if key == "self_gravity":
        p.set("neib_search", "octtree")
    p.set(key, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SimulationBase.factory(p).process_parameters()


def test_burst_stops_at_tend():
    """A burst across tend ends at tend, never past it (ROADMAP fault F3).
    The state's dt starts 1000 times below its natural value, so dt
    grows 1000-fold after the first step of the burst; the burst length
    bound from that first dt (8 steps) spans several natural steps past
    tend.  The JAX package overshoots tend here: it clamps no step of a
    burst, and its host bound assumes dt grows at most 2-fold.  The port
    clamps each step's dt to tend - t on the device."""
    ic = jittered_box_ic(slice_params(8), 8)
    probe = GradhSphSimulation(slice_params(8), device="cpu",
                               dtype=torch.float64)
    probe.SetupSimulation(ic)
    dt_nat = float(probe.state.dt)
    tend = 2.5 * dt_nat
    sim = GradhSphSimulation(slice_params(8, tend=tend), device="cpu",
                             dtype=torch.float64)
    sim.SetupSimulation(ic)
    sim.state = sim.state.replace(dt=sim.state.dt * 1e-3)
    times = []
    step = sim._step_fn

    def recorded(s):
        out = step(s)
        times.append(float(out.t))
        return out

    sim._step_fn = recorded
    assert sim.main_loop_steps(8) == 8
    assert len(times) == 8
    assert max(times) <= tend
    assert sim.t == pytest.approx(tend, abs=1e-12 * tend)
    # dt grew: without the clamp the eighth step would be far past tend
    assert times[2] > times[1] * 1.5


def test_burst_overflow_replays_step_by_step():
    """An overflow inside a burst survives to its end (the flag is
    sticky); the burst then rewinds and replans at the offending step,
    ending where single steps end."""
    ic = jittered_box_ic(slice_params(8), 8)
    sims = []
    for _ in range(2):
        sim = GradhSphSimulation(slice_params(8), device="cpu",
                                 dtype=torch.float64)
        sim.SetupSimulation(ic)
        sim.gridspec = dataclasses.replace(sim.gridspec, k_cell=40)
        sims.append(sim)
    burst, single = sims
    # sticky: a step that does not overflow keeps an incoming overflow
    ok_sim = GradhSphSimulation(slice_params(8), device="cpu",
                                dtype=torch.float64)
    ok_sim.SetupSimulation(ic)
    flagged = ok_sim.state.replace(neib_overflow=torch.tensor(True))
    assert not bool(ok_sim._step_fn(ok_sim.state).neib_overflow)
    assert bool(ok_sim._step_fn(flagged).neib_overflow)
    assert burst.main_loop_steps(4) == 4
    for _ in range(4):
        single.main_loop_step()
    assert burst._n_grid_overflows == single._n_grid_overflows == 1
    assert burst.gridspec == single.gridspec
    for f in FIELDS + ("t", "dt"):
        assert torch.equal(getattr(burst.state, f),
                           getattr(single.state, f)), f
