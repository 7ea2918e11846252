"""Port parity: self-gravity below 3D through both controllers, float64
on the CPU, against gandalf_tpu's GradhSphSimulation and
MfvMusclSimulation.

- The 2D self-gravitating disc (the cold_sphere_block configuration,
  sphere_block_params, at ndim 2: a uniform disc of radius 1 and mass 1
  on a square lattice, 384 particles, quadrupole KD-tree gravity with
  the geometric MAC at theta^2 0.1, its buckets replanned every 4 steps)
  under a global timestep for 8 steps, and under Nlevels 4 for 8
  compacted ticks, the JAX package's pads pointed outside its active
  lists (tests/test_torch_block_sim.py:repoint_pads, ROADMAP fault F7).
- A 2D periodic box (16^2 jittered lattice, rho 1, p 1) with ewald = 0,
  where K4 unwraps each bucket along both axes.
- The 1D sphere (a rod of 64 particles) under a global timestep.
- The 2D disc through MUSCL MFV (K7's MFV zeta mode).

After every step both agree on every field to 1e-9 of its largest
value, on the tree plans and, under block steps, on the levels, nlast
and the rows each active pass lists.  Also: a periodic box below 3D with
ewald = 1 raises in both packages, with the JAX package's reason, and
sinks below 3D stay refused (ROADMAP queue 1, item 9)."""

import numpy as np
import pytest
import torch

from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim import mfv_sim as jax_mfv
from gandalf_tpu.sim.ic import generate_ic as jax_generate_ic
from gandalf_tpu.sim.simulation import SimulationBase as JaxSim
from gandalf_tpu_torch.check import disc_params as _disc_params
from gandalf_tpu_torch.check import jittered_box_ic, slice_params
from gandalf_tpu_torch.convert import tree_spec_from_jax
from gandalf_tpu_torch.sim.simulation import SimulationBase
from test_torch_block_sim import repoint_pads

torch.set_num_threads(1)

TOL = 1e-9
STEPS = 8
NTB = 4
FIELDS = ("r", "v", "u", "h", "rho", "gpot", "a")
MFV_FIELDS = ("r", "v", "u", "m", "h", "rho", "Qcons0", "gpot", "a")


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def disc_params(ndim=2, n_target=400, nlevels=1, sim="gradhsph"):
    return _disc_params(n_target, ndim, nlevels, NTB, sim, tend=1.0)


def _both(params, ic=None, block=False):
    """Both controllers after setup from one IC (each package's own
    generator when `ic` is None; with `block` the JAX package's pads
    pointed outside its active lists)."""
    jp = _jax_params(params)
    jsim = JaxSim.factory(jp)
    if block:
        repoint_pads(jsim)
    mfv = params.stringparams["sim"] in ("meshlessfv", "mfvmuscl")
    if ic is not None and not mfv:
        jsim.restart_data = {k: v.copy() for k, v in ic.items()}
    with pytest.MonkeyPatch.context() as mp:
        if ic is not None and mfv:
            mp.setattr(jax_mfv, "generate_ic",
                       lambda p, eos: {k: v.copy() for k, v in ic.items()})
        jsim.SetupSimulation()
    tsim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
    tsim.SetupSimulation(None if ic is None
                         else {k: v.copy() for k, v in ic.items()})
    assert tsim.self_gravity and tsim.ndim == params.intparams["ndim"]
    return jsim, tsim


def _compare(jsim, tsim, fields, where):
    if tsim.use_block:
        for f in ("level", "nlast"):
            np.testing.assert_array_equal(
                getattr(tsim.state, f).numpy(),
                np.asarray(getattr(jsim.state, f)), err_msg=f"{where}: {f}")
    assert tree_spec_from_jax(jsim.treespec) == tsim.treespec, where
    errs = {}
    for f in fields:
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        errs[f] = float(np.max(np.abs(got - want))
                        / max(np.max(np.abs(want)), 1e-300))
    errs["t"] = abs(float(tsim.state.t) - float(jsim.state.t)) / max(
        abs(float(jsim.state.t)), 1e-300)
    assert max(errs.values()) <= TOL, (where, errs)
    return errs


def _run(jsim, tsim, fields, steps=STEPS):
    _compare(jsim, tsim, fields, "setup")
    for i in range(steps):
        jsim.last_tick_rows = []
        tsim.last_tick_rows = []
        jsim.main_loop_step()
        tsim.main_loop_step()
        _compare(jsim, tsim, fields, f"step {i + 1}")
        if tsim.use_block and not hasattr(tsim.state, "Qcons0"):
            assert tsim.last_tick_rows == jsim.last_tick_rows, i + 1
    assert tsim.Nsteps == jsim.Nsteps == steps


def test_disc_2d_global_steps_match_jax():
    """8 global steps of the 2D disc, the tree replanned every 4."""
    jsim, tsim = _both(disc_params())
    assert tsim.state.N == 384 and not tsim.use_block
    _run(jsim, tsim, FIELDS)
    assert tsim._n_tree_plans == 2


def test_disc_2d_block_ticks_match_jax():
    """8 compacted ticks of the 2D disc under Nlevels 4 (K6 and K7 over
    the active buckets' list): equal levels, nlast and listed rows; some
    ticks list part of the particles."""
    jsim, tsim = _both(disc_params(nlevels=4), block=True)
    assert tsim.use_block
    rows = []
    orig = tsim.main_loop_step

    def step():
        orig()
        rows.append(tsim.last_tick_rows[0])

    tsim.main_loop_step = step
    _run(jsim, tsim, FIELDS)
    assert min(rows) < tsim.state.N
    print(f"2D disc block: rows {rows}, levels "
          f"{np.bincount(tsim.state.level.numpy()).tolist()}")


def test_periodic_box_2d_without_ewald_matches_jax():
    """8 global steps of the 16^2 periodic box with ewald = 0 (the tree
    over buckets unwrapped along both axes)."""
    p = slice_params(16, tend=1.0, self_gravity=1, ndim=2)
    p.set("ntreebuildstep", NTB)
    jsim, tsim = _both(p, jittered_box_ic(p, 16))
    assert not tsim.use_ewald and tuple(tsim.box.periodic_dims()) == (0, 1)
    _run(jsim, tsim, FIELDS)


def test_sphere_1d_matches_jax():
    """8 global steps of the 1D sphere, 64 particles."""
    jsim, tsim = _both(disc_params(ndim=1, n_target=64))
    assert tsim.state.N == 64
    _run(jsim, tsim, FIELDS)


def test_mfv_disc_2d_matches_jax():
    """8 global steps of the 2D disc through MUSCL MFV; the mass is
    kept."""
    p = disc_params(sim="mfvmuscl")
    ic = jax_generate_ic(_jax_params(p), None)
    ic = {k: np.asarray(ic[k]) for k in ("r", "v", "m", "h", "u")}
    jsim, tsim = _both(p, ic)
    m0 = float(tsim.state.m.sum())
    _run(jsim, tsim, MFV_FIELDS)
    assert float(tsim.state.m.sum()) == pytest.approx(m0, rel=1e-13)


@pytest.mark.parametrize("sim", ["gradhsph", "mfvmuscl"])
@pytest.mark.parametrize("ndim", [1, 2])
def test_ewald_below_3d_refused_like_jax(ndim, sim):
    """A periodic self-gravitating box below 3D with ewald = 1: both
    packages raise NotImplementedError with the same reason."""
    p = slice_params(8, self_gravity=1, ndim=ndim)
    p.set("ewald", 1)
    p.set("sim", sim)
    match = "Ewald periodic self-gravity requires a 3D box"
    with pytest.raises(NotImplementedError, match=match):
        JaxSim.factory(_jax_params(p)).SetupSimulation()
    with pytest.raises(NotImplementedError, match=match):
        SimulationBase.factory(p, "cpu", torch.float64).process_parameters()


@pytest.mark.parametrize("ndim", [1, 2])
def test_sinks_below_3d_stay_refused(ndim):
    """Sinks with self-gravity below 3D name ROADMAP queue 1, item 9."""
    p = disc_params(ndim=ndim)
    p.set("create_sinks", 1)
    with pytest.raises(NotImplementedError, match="item 9"):
        SimulationBase.factory(p, "cpu", torch.float64).process_parameters()
