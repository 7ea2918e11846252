"""Port parity: external potentials in the hydro controllers against
gandalf_tpu's (float64, CPU), and the options that the JAX package's
controllers ignore or cannot run, which the port refuses.

- the vertical field of tests/test_extpot.py:18-42 on the grid path (a
  6^3 lattice box: every particle feels avert along kgrav), and the
  Plummer field on the same box, through both GradhSphSimulations with a
  global dt;
- (the Plummer field on the hybrid Plummer sphere with stars, which feel
  it too, is tests/test_torch_sm2012.py::test_sinks_match_jax);
- fault F19: the JAX package's compacted block tick and its MFV
  controller skip the external potential; fault F16: its MFV controller
  ignores sink_particles; fault F20: its grid pass cannot run the locally
  isothermal EOS.  Each is shown on the JAX package, and the port
  refuses it naming the fault.

Fields within 1e-9 of their largest value (the same formulas over the
same candidates; only the order of the sums differs)."""

import numpy as np
import pytest
import torch

from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.mfv_sim import MfvMusclSimulation as JaxMfv
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu_torch.check import (extpot_box_params, mfv_params,
                                     slice_params)
from gandalf_tpu_torch.sim.simulation import (GradhSphSimulation,
                                              SimulationBase)

torch.set_num_threads(1)

TOL = 1e-9
AVERT = -0.5


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _pair(params):
    jsim = JaxSim(_jax_params(params))
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(params.copy(), device="cpu",
                              dtype=torch.float64)
    tsim.SetupSimulation()
    return jsim, tsim


def _scaled(got, want):
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _compare(jsim, tsim, where):
    alive = np.asarray(jsim.state.alive)
    assert np.array_equal(tsim.state.alive.numpy(), alive), where
    errs = {f: _scaled(getattr(tsim.state, f).numpy()[alive],
                       np.asarray(getattr(jsim.state, f))[alive])
            for f in ("r", "v", "a", "u", "h", "rho", "gpot")}
    for f in ("t", "dt"):
        want = float(getattr(jsim.state, f))
        errs[f] = (abs(float(getattr(tsim.state, f)) - want)
                   / max(abs(want), 1e-300))
    if getattr(jsim, "has_sinks", False):
        js, ts = jsim.sinks, tsim.state.sinks
        for f in ("r", "v", "a", "m"):
            errs[f"sink_{f}"] = _scaled(getattr(ts, f).numpy(),
                                        np.asarray(getattr(js, f)))
    bad = {k: e for k, e in errs.items() if not e <= TOL}
    assert not bad, f"{where}: {bad}"


def _steps(jsim, tsim, n):
    _compare(jsim, tsim, "bootstrap")
    for i in range(n):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _compare(jsim, tsim, f"step {i + 1}")


def test_vertical_potential_on_the_grid_matches_jax():
    """The vertical field: at the bootstrap every particle feels exactly
    avert along kgrav (tests/test_extpot.py:18-42's gate, here on the
    grid path, to 1e-10), and its potential (r_k - boxmin_k) avert joins
    gpot; then 3 steps through both packages."""
    jsim, tsim = _pair(extpot_box_params("vertical", AVERT))
    a = tsim.state.a.numpy()
    assert np.allclose(a[:, 2], AVERT, atol=1e-10)
    assert np.allclose(a[:, :2], 0.0, atol=1e-10)
    z = tsim.state.r.numpy()[:, 2]
    assert np.allclose(tsim.state.gpot.numpy(), z * AVERT, atol=1e-12)
    _steps(jsim, tsim, 3)


def test_plummer_potential_on_the_grid_matches_jax():
    """The Plummer field on the same box: 3 steps through both packages."""
    jsim, tsim = _pair(extpot_box_params("plummer", AVERT))
    assert float(torch.abs(tsim.state.a).max()) > 0.1
    _steps(jsim, tsim, 3)


def test_unknown_potential_raises():
    p = extpot_box_params("kepler", AVERT)
    with pytest.raises(ValueError, match="external_potential"):
        GradhSphSimulation(p, "cpu", torch.float64).process_parameters()


def test_compacted_tick_refused_f19():
    """Fault F19: under block timesteps without sinks or dust the JAX
    package's compacted tick adds no external potential (f_active and
    f_active_grav, gandalf_tpu/sim/simulation.py:1135-1160), while its
    bootstrap does (:1480-1487): after one tick the particles it updated
    have lost the field.  The port refuses the case."""
    p = extpot_box_params("vertical", AVERT)
    p.set("Nlevels", 3)
    jsim = JaxSim(_jax_params(p))
    jsim.SetupSimulation()
    assert np.allclose(np.asarray(jsim.state.a)[:, 2], AVERT, atol=1e-10)
    jsim.main_loop_step()
    assert np.any(np.abs(np.asarray(jsim.state.a)[:, 2]) < 1e-10)
    sim = SimulationBase.factory(p, "cpu", torch.float64)
    with pytest.raises(NotImplementedError, match="F19"):
        sim.SetupSimulation()


def test_mfv_refusals_f16_f19():
    """The JAX MFV controller (gandalf_tpu/sim/mfv_sim.py) never reads
    sink_particles, create_sinks or external_potential: a run with all
    three sets up and bootstraps with no sinks (fault F16) and no field
    (fault F19).  The port refuses each, naming its fault."""
    p = mfv_params(6, self_gravity=0)
    for k, v in (("external_potential", "vertical"), ("kgrav", 2),
                 ("avert", AVERT), ("sink_particles", 1),
                 ("create_sinks", 1)):
        p.set(k, v)
    jsim = JaxMfv(_jax_params(p))
    jsim.SetupSimulation()
    assert getattr(jsim, "sinks", None) is None
    assert np.asarray(jsim.state.r).shape[0] == 6 ** 3
    assert float(np.abs(np.asarray(jsim.state.a)).max()) == 0.0
    for key, fault in (("sink_particles", "F16"),
                       ("external_potential", "F19")):
        q = mfv_params(6, self_gravity=0)
        q.set(key, p.get(key))
        sim = SimulationBase.factory(q, "cpu", torch.float64)
        with pytest.raises(NotImplementedError, match=fault):
            sim.process_parameters()


@pytest.mark.parametrize("eos", ["locally_isothermal",
                                 "disc_locally_isothermal"])
def test_locally_isothermal_refused_f20(eos):
    """Fault F20: the JAX package's grid passes call thermal_update
    without positions (gandalf_tpu/ops/sph_grid27.py:777-778, :836;
    ops/active_grid.py:124-125), and the locally isothermal family's
    temperature needs them (ops/eos.py:143-145), so its grid path raises;
    it runs this family only on its all-pairs path.  The port refuses it
    naming F20."""
    p = slice_params(6)
    p.set("gas_eos", eos)
    with pytest.raises(ValueError, match="needs positions"):
        JaxSim(_jax_params(p)).SetupSimulation()
    with pytest.raises(NotImplementedError, match="F20"):
        GradhSphSimulation(p, "cpu", torch.float64).process_parameters()
