"""Port parity: RadWS and radiative feedback through the controllers,
against gandalf_tpu's on its grid path (float64, CPU, the plain versions
of K27-K30).

Five steps (ticks) of each configuration through both packages' controllers
from the same IC, every field within 1e-9 of its largest value after
each (ueq and dt_therm included; both sides evaluate the same formulas,
only the order of some sums differs): the hot radws box of
tests/test_radws.py:18-37 at 6^3 with self-gravity, with a global dt and
with Nlevels 3 (the compacted tick); the hybrid Plummer sphere (256 gas,
4 stars) with radiative feedback, with a global dt and under the dense
block tick; the MFV box at 6^3; the box without gravity on an opacity
table this file writes (kappa, mu and gamma varying, so the relaxation
takes several steps), and radws without the radws relaxation (u
integrated explicitly); and check.radws_dense_inputs against the dense
slots a step's grid pass gives the EOS.  Then the refusal that stays,
shown first on the JAX package: rad_fb in MFV, which the JAX MFV
controller never reads (fault F21).  Radws MFV under block timesteps is
held to the JAX package in tests/test_torch_mfv_block_sim.py."""

import numpy as np
import pytest
import torch

from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim import mfv_sim as jax_mfv
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu_torch.check import (jittered_box_ic, mfv_params,
                                     plummer_stars_params, radfb_params,
                                     radws_dense_inputs, radws_params,
                                     slice_params)
from gandalf_tpu_torch.sim.simulation import SimulationBase

from test_torch_radws import write_table

torch.set_num_threads(1)

TOL = 1e-9
N_SIDE = 6
STEPS = 5
FIELDS = ("r", "v", "u", "h", "rho", "ueq", "dt_therm")


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _pair(params, ic=None, mfv=False):
    """Both controllers after setup, from the same parameters (and the
    same IC where one is given)."""
    if mfv:
        jsim = jax_mfv.MfvMusclSimulation(_jax_params(params))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_mfv, "generate_ic",
                       lambda p, eos: {k: v.copy() for k, v in ic.items()})
            jsim.SetupSimulation()
    else:
        jsim = JaxSim(_jax_params(params))
        if ic is not None:
            jsim.restart_data = {k: v.copy() for k, v in ic.items()}
        jsim.SetupSimulation()
    tsim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
    tsim.SetupSimulation(None if ic is None
                         else {k: v.copy() for k, v in ic.items()})
    return jsim, tsim


def _scaled(got, want, rows):
    got, want = np.asarray(got)[rows], np.asarray(want)[rows]
    err = np.max(np.abs(got - want)) if got.size else 0.0
    return err / max(np.max(np.abs(want)), 1e-300) if err else 0.0


def _compare(jsim, tsim, where, fields):
    alive = np.asarray(getattr(jsim.state, "alive",
                               np.ones(tsim.state.N, bool)))
    if hasattr(tsim.state, "alive"):
        assert np.array_equal(tsim.state.alive.numpy(), alive), where
    errs = {f: _scaled(getattr(tsim.state, f).numpy(),
                       getattr(jsim.state, f), alive) for f in fields}
    for f in ("t", "dt"):
        want = float(getattr(jsim.state, f))
        errs[f] = abs(float(getattr(tsim.state, f)) - want) / abs(want) \
            if want else abs(float(getattr(tsim.state, f)))
    if getattr(jsim, "has_sinks", False):
        js, ts = jsim.sinks, tsim.state.sinks
        assert np.array_equal(ts.active.numpy(), np.asarray(js.active))
        for f in ("r", "v", "m", "mdot"):
            errs[f"sink_{f}"] = _scaled(getattr(ts, f).numpy(),
                                        getattr(js, f), np.ones(ts.N, bool))
    bad = {k: e for k, e in errs.items() if not e <= TOL}
    assert not bad, f"{where}: {bad}"


def _steps(jsim, tsim, fields=FIELDS, levels=False):
    _compare(jsim, tsim, "bootstrap", fields)
    for i in range(STEPS):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _compare(jsim, tsim, f"step {i + 1}", fields)
        if levels:
            assert np.array_equal(tsim.state.level.numpy(),
                                  np.asarray(jsim.state.level))


def _box(nlevels=1, self_gravity=1, **over):
    p = radws_params(slice_params(N_SIDE, 1.0, self_gravity=self_gravity))
    if self_gravity:
        p.set("ntreebuildstep", 2)
    if nlevels > 1:
        p.set("Nlevels", nlevels)
        p.set("level_diff_max", 1)
    for k, v in over.items():
        p.set(k, v)
    return p


def test_dense_inputs_are_the_grid_pass_s():
    """check.radws_dense_inputs rebuilds, from the state after a step,
    the dense (cells, K) rho and u that the step's grid pass gave the
    EOS (empty slots included): the inputs on which the chip's radws box
    holds K27 against its plain version."""
    p = radws_params(slice_params(10, self_gravity=0))
    sim = SimulationBase.factory(p, "cpu", torch.float64)
    sim.SetupSimulation(jittered_box_ic(p, 10))
    sim.main_loop_step()
    calls = []
    update = type(sim.eos).thermal_update

    def record(eos, rho, u):
        calls.append((rho.clone(), u.clone()))
        return update(eos, rho, u)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(sim.eos), "thermal_update", record)
        sim.main_loop_step()
    rho_d, u_d = radws_dense_inputs(sim)
    assert len(calls) == 1 and rho_d.dim() == 4 and rho_d.shape[:3] != (
        1, 1, 1)
    assert int((u_d == 0).sum()) > 0
    assert torch.equal(calls[0][0], rho_d) and torch.equal(calls[0][1], u_d)


@pytest.mark.parametrize("nlevels", [1, 3])
def test_gravity_box_matches_jax(nlevels):
    """The hot box (T0 = 66.7) with tree gravity (gpot gives col2 a value):
    it cools to the table's entry nearest temp_ambient 10 within the
    first step (T = u (gamma-1) within 10%, tests/test_radws.py:96-104);
    with Nlevels 3 through the compacted tick, equal levels each tick."""
    p = _box(nlevels)
    jsim, tsim = _pair(p, jittered_box_ic(p, N_SIDE))
    assert tsim.use_radws_energy and not tsim.integ.energy_integration
    assert tsim.use_block == (nlevels > 1) and not tsim.has_sinks
    _steps(jsim, tsim, FIELDS + ("gpot",), levels=nlevels > 1)
    T = tsim.state.u.numpy() * (2.0 / 3.0)
    assert np.allclose(T, 10.0, rtol=0.1)
    assert bool((tsim.state.gpot > 0).all())


@pytest.mark.parametrize("nlevels", [1, 3])
def test_radiative_feedback_cluster_matches_jax(nlevels):
    """The hybrid Plummer sphere (256 gas, 4 accreting stars, tree
    gravity) with rad_fb, sink, ambient and disc heating: a global dt
    (one central slot) and the dense block tick (Nlevels 3, two central
    slots).  The stars heat the gas: its equilibrium lies far above
    temp_ambient."""
    p = radfb_params(plummer_stars_params(256, 4),
                     disc_heating=1 if nlevels == 1 else 2)
    if nlevels > 1:
        p.set("Nlevels", nlevels)
        p.set("level_diff_max", 1)
    jsim, tsim = _pair(p)
    assert tsim.rad_fb and tsim.radfb_disc_cfg.n_central == (
        1 if nlevels == 1 else 2)
    _steps(jsim, tsim, FIELDS + ("gpot",), levels=nlevels > 1)
    alive = tsim.state.alive
    assert float(tsim.state.ueq[alive].min()) > 1.5 * 1.0
    assert int((~alive).sum()) > 0


def test_mfv_box_matches_jax():
    """The hot MFV box at 6^3 with self-gravity: the implicit heating
    (K29's plain version) at the mid-step gpot folded into the energy
    column; T within 12% of temp_ambient after the steps
    (tests/test_radws.py:320-335) and the mass untouched."""
    p = radws_params(mfv_params(N_SIDE, 1, 1.0))
    p.set("ntreebuildstep", 2)
    ic = jittered_box_ic(p, N_SIDE)
    jsim, tsim = _pair(p, ic, mfv=True)
    m0 = tsim.state.m.clone()
    _steps(jsim, tsim, ("r", "v", "u", "h", "rho", "Qcons0", "gpot"))
    T = tsim.state.u.numpy() * (2.0 / 3.0)
    assert np.allclose(T, 10.0, rtol=0.12)
    assert torch.equal(tsim.state.m, m0)


def test_file_table_box_matches_jax(tmp_path):
    """The box without gravity on an opacity table written in the
    reference's format (Stefan-Boltzmann in cgs, kappa, mu and gamma
    varying): the relaxation is partial over the steps (dt_therm of the
    order of dt) and the EOS's gamma comes from the table."""
    p = _box(self_gravity=0, radws_table=write_table(tmp_path / "t.dat"))
    jsim, tsim = _pair(p, jittered_box_ic(p, N_SIDE))
    _steps(jsim, tsim)
    s = tsim.state
    assert float(s.dt_therm.min()) < 1e3 * float(s.dt)
    assert not np.allclose(s.pressure.numpy(),
                           (2.0 / 3.0) * (s.rho * s.u).numpy())


def test_radws_without_relaxation_integrates_u(tmp_path):
    """gas_eos = radws with energy_integration unset: the table EOS, and
    u integrated explicitly as for energy_eqn
    (gandalf_tpu/sim/simulation.py:891-893)."""
    p = _box(self_gravity=0, energy_integration="null")
    jsim, tsim = _pair(p, jittered_box_ic(p, N_SIDE))
    assert not tsim.use_radws_energy and tsim.integ.energy_integration
    _steps(jsim, tsim, ("r", "v", "u", "h", "rho"))
    assert not torch.equal(tsim.state.u, tsim.state.ueq)


def test_mfv_radiative_feedback_refused_f21():
    """rad_fb in MFV (fault F21): the JAX MFV controllers never read it
    (gandalf_tpu/sim/mfv_sim.py holds no rad_fb, and processing the
    parameters of a radws MFV run reads Nlevels, say, and not rad_fb), so
    a run with it makes no ambient field there; the port refuses it
    rather than ignore it."""
    import inspect

    assert "rad_fb" not in inspect.getsource(jax_mfv)
    reads = []

    class Recorded(dict):
        def __getitem__(self, key):
            reads.append(key)
            return super().__getitem__(key)

    p = radws_params(mfv_params(N_SIDE, 0, 1.0))
    p.set("rad_fb", 1)
    jp = _jax_params(p)
    jp.intparams = Recorded(jp.intparams)
    jax_mfv.MfvMusclSimulation(jp).process_parameters()
    assert "Nlevels" in reads and "rad_fb" not in reads
    with pytest.raises(NotImplementedError, match="F21"):
        SimulationBase.factory(p, "cpu", torch.float64).process_parameters()
