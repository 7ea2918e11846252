"""Port parity: sinks, stars and softened N-body with the quintic and
tabulated smoothing kernels through both packages' controllers on the
CPU, float64.

- tests/test_torch_sink_sim.py's random Boss-Bodenheimer cloud (500
  particles, rho_sink 2e-17 g cm^-3) with the tabulated M4, 4 steps: a
  sink forms each step and eats gas;
- that file's hybrid Plummer sphere (256 gas, 8 stars from the IC,
  accretion on) with the tabulated quintic, 4 steps;
- the 2D sink disc (check.sink_disc_params(384, 2, nlevels 3, smooth
  accretion)) with the quintic, 8 dense block ticks, each package's tree
  COMs clamped into their boxes (fault F30, clamp_jax_com);
- softened hermite4 plummer_cluster at 256 stars with the tabulated M4,
  10 steps (a, adot, gpot and dt too).

Each step holds every field and the sinks' r, v, m to 1e-9 of each one's
largest value, with equal sinks created at equal steps, equal eaten
masks, equal grid plans and, under block steps, equal levels.  Then, on
the port alone, every variant but the gaussians with slots at ndim 1-3
(the hybrid Plummer sphere in 3D, the sink disc in 2D, the sink rod in
1D) sets up, steps twice and stays finite.
"""

import numpy as np
import pytest
import torch

from gandalf_tpu.sim.simulation import SimulationBase as JaxSim
from gandalf_tpu_torch.check import (SINK_FAMILY_VARIANTS, family_params,
                                     sink_disc_params)
from gandalf_tpu_torch.convert import grid_spec_from_jax
from gandalf_tpu_torch.sim.simulation import SimulationBase

from test_torch_nbody_sim import _errors as _nbody_errors
from test_torch_nbody_sim import _run_pair as _nbody_pair
from test_torch_sink_dims_sim import _jax_params, _record, clamp_jax_com
from test_torch_sink_sim import _bb, _plummer, _run, _setup

torch.set_num_threads(1)

TOL = 1e-9


def _same_plans(jsim, tsim):
    assert grid_spec_from_jax(jsim.gridspec) == tsim.gridspec


def test_bb_random_with_the_tabulated_m4_matches_jax():
    """4 steps of the random Boss-Bodenheimer cloud with the tabulated
    M4: a sink forms each step in both packages (K14 between them, K16
    with the gas, K18's plain accretion)."""
    jsim, tsim = _setup(family_params("m4_tab", _bb()))
    assert tsim.kern.variant == "m4_tab"
    created = _run(jsim, tsim, 4)
    assert created == [1, 2, 3, 4]
    assert int((~tsim.state.alive).sum()) > 4
    _same_plans(jsim, tsim)


def test_hybrid_plummer_with_the_tabulated_quintic_matches_jax():
    """4 steps of the hybrid Plummer sphere (8 stars from the IC,
    accretion on) with the tabulated quintic: star-gas and star-star
    gravity through its table."""
    jsim, tsim = _setup(family_params("quintic_tab", _plummer()))
    assert tsim.kern.variant == "quintic_tab"
    assert bool(tsim.state.sinks.active.all())
    _run(jsim, tsim, 4)
    _same_plans(jsim, tsim)


def test_sink_disc_block_with_the_quintic_matches_jax():
    """8 dense block ticks of the 2D sink disc (Nlevels 3, smooth
    accretion, K20 with the quintic's W and wpot) through both
    controllers: every field and sink field within 1e-9, the same sinks,
    eaten gas and levels after every tick."""
    params = family_params("quintic", sink_disc_params(
        384, 2, nlevels=3, smooth_accretion=1, ntreebuildstep=4, tend=1.0))
    tsim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
    tsim.SetupSimulation()
    with pytest.MonkeyPatch.context() as mp:
        clamp_jax_com(mp)
        jsim = JaxSim.factory(_jax_params(params))
        jsim.SetupSimulation()
        records = [_record(jsim, tsim)]
        for _ in range(8):
            jsim.main_loop_step()
            tsim.main_loop_step()
            records.append(_record(jsim, tsim))
    assert tsim.kern.variant == "quintic" and tsim.use_block
    for i, rec in enumerate(records):
        bad = {k: e for k, e in rec["errs"].items() if not e <= TOL}
        assert not bad, (i, bad)
        assert rec["same_alive"] and rec["same_active"], i
        assert rec["same_levels"], i
    assert records[-1]["active"] > 0
    _same_plans(jsim, tsim)


def test_softened_nbody_with_the_tabulated_m4_matches_jax():
    """10 hermite4 steps of plummer_cluster at 256 stars, softened with
    the tabulated M4 (K14): r, v, a, adot, gpot, t and dt within 1e-9."""
    jsim, tsim = _nbody_pair(256, {"tabulated_kernel": 1})
    assert tsim.kern.variant == "m4_tab"
    errs = _nbody_errors(jsim, tsim)
    assert max(errs.values()) <= TOL, errs


def _port_case(variant, ndim):
    if ndim == 3:
        return family_params(variant, _plummer())
    if ndim == 2:
        return family_params(variant, sink_disc_params(384, 2))
    return family_params(variant, sink_disc_params(
        64, 1, 0.5, smooth_accretion=1))


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("variant", SINK_FAMILY_VARIANTS)
def test_every_variant_runs_with_slots(variant, ndim):
    """The port alone: a run with slots (the hybrid Plummer sphere's IC
    stars in 3D, the sink disc with creation in 2D, the sink rod with
    smooth accretion in 1D) sets up and steps twice with the variant; its
    fields and its active slots stay finite."""
    sim = SimulationBase.factory(_port_case(variant, ndim), "cpu",
                                 torch.float64)
    sim.SetupSimulation()
    for _ in range(2):
        sim.main_loop_step()
    assert sim.kern.variant == variant and sim.ndim == ndim
    s, sk = sim.state, sim.state.sinks
    for f in ("r", "v", "u", "h", "rho", "gpot"):
        assert bool(torch.isfinite(getattr(s, f)).all()), f
    for f in ("r", "v", "a", "m"):
        assert bool(torch.isfinite(getattr(sk, f)[sk.active]).all()), f
    assert np.isfinite(sim.t) and sim.Nsteps == 2
