"""Port parity: sinks and stars below 3D through the port's
GradhSphSimulation on the CPU against gandalf_tpu's, float64.

The runs (check.sink_disc_params, check.binaryacc_params):
- the 2D self-gravitating disc (384 particles, quadrupole tree replanned
  every 4 steps) with sink creation (rho_sink 0.3, just under the
  bootstrap's largest rho, 0.315) and plain accretion, 8 global steps;
- the same disc with Nlevels 4 and smooth accretion, 8 dense ticks;
- the 1D rod (64 particles, rho_sink 0.5 under 0.501) with creation and
  smooth accretion, 8 steps;
- binaryacc at 2 x 16 x 32 (two stars of 0.4 and 0.6 crossing a
  two-density stream, periodic, no self-gravity), 8 steps.

After every step both agree on every field to 1e-9 of its largest value
(the alive particles' fields; gpot and the dead's m, v, a over all), on
the sinks' r, v, a, m, mdot and angmom to 1e-9 with equal active slots,
on the gas eaten and, under block steps, on the levels.  The runs are
stepped once, in a module-scoped fixture, and each test reads their
records.  Eating gas leaves tree leaves with one live particle, whose
COM sum(m x) / m can round an ulp off x: the JAX package's walk then
takes the leaf as a far cell at ~1e-17 (fault F30, shown in
tests/test_torch_sinks_dims.py), which both discs meet within 8 steps.
The port clamps each COM into its cell's box; the JAX runs here clamp
theirs the same way (clamp_jax_com), as repoint_pads steers round F7.

Also the checks: a star-carrying IC reaches the same checks as the sink
parameters (the gaussian with slots is refused either way, naming fault
F23); radiation and radiative feedback with slots
below 3D set up (refused until K30 and K34-K37 took NDIM 1 and 2; their
runs are held to the JAX package in tests/test_torch_radiation_dims_sim.py);
binaryacc in 1D, refused by both packages' generators.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.ops import tree as jt
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.ic import generate_ic as jax_generate_ic
from gandalf_tpu.sim.simulation import SimulationBase as JaxSim
from gandalf_tpu_torch.check import (binaryacc_params, radfb_params,
                                     radws_params, sink_disc_params)
from gandalf_tpu_torch.sim.ic import generate_ic
from gandalf_tpu_torch.sim.simulation import SimulationBase

torch.set_num_threads(1)

TOL = 1e-9
STEPS = 8
NTB = 4
FIELDS = ("r", "v", "u", "h", "rho", "a")
SINK_FIELDS = ("r", "v", "a", "m", "mdot", "angmom")

CASES = {
    "disc_2d": lambda: sink_disc_params(400, 2, 0.3, ntreebuildstep=NTB,
                                        tend=1.0),
    "disc_block_2d": lambda: sink_disc_params(
        400, 2, 0.3, nlevels=4, smooth_accretion=1, ntreebuildstep=NTB,
        tend=1.0),
    "rod_1d": lambda: sink_disc_params(64, 1, 0.5, smooth_accretion=1,
                                       ntreebuildstep=NTB, tend=1.0),
    "binaryacc_2d": lambda: binaryacc_params(16, tend=1.0),
}


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want), initial=0.0)
                 / max(np.max(np.abs(want), initial=0.0), 1e-300))


def _record(jsim, tsim):
    """One step's comparison: the largest relative error of each field
    and sink field, and whether the alive masks, active slots and (block)
    levels are equal."""
    js, ts = jsim.state, tsim.state
    alive = np.asarray(js.alive)
    errs = {f: _rel(getattr(ts, f).numpy()[alive],
                    np.asarray(getattr(js, f))[alive]) for f in FIELDS}
    errs["gpot"] = _rel(ts.gpot, js.gpot)
    errs["m"] = _rel(ts.m, js.m)
    for f in ("t", "dt"):
        errs[f] = _rel(getattr(ts, f), getattr(js, f))
    jk, tk = jsim.sinks, ts.sinks
    for f in SINK_FIELDS:
        errs[f"sink_{f}"] = _rel(getattr(tk, f), getattr(jk, f))
    rec = {"errs": errs,
           "same_alive": bool(np.array_equal(ts.alive.numpy(), alive)),
           "same_active": bool(np.array_equal(tk.active.numpy(),
                                              np.asarray(jk.active))),
           "active": int(tk.active.sum()), "dead": int((~alive).sum()),
           "angmom_z": tk.angmom[:, 2].numpy().copy(),
           "angmom_xy": float(np.abs(tk.angmom[:, :2].numpy()).max())}
    if tsim.use_block:
        rec["same_levels"] = all(
            np.array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
            for f in ("level", "nlast"))
    return rec


def clamp_jax_com(mp):
    """Clamp the JAX package's tree COMs into their cells' boxes, [centre
    - half, centre + half], as the port's K5 does (fault F30)."""
    build = jt.build_tree

    def clamped(spec, r_s, m_s, alive):
        t = build(spec, r_s, m_s, alive)
        return t._replace(com=[
            jnp.minimum(jnp.maximum(c, ce - hf), ce + hf)
            for c, ce, hf in zip(t.com, t.centre, t.half)])

    mp.setattr(jt, "build_tree", clamped)


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    """Both controllers from one parameter set, each package's own IC,
    compared after setup and after each of STEPS steps (ticks)."""
    params = CASES[request.param]()
    tsim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
    tsim.SetupSimulation()
    with pytest.MonkeyPatch.context() as mp:
        clamp_jax_com(mp)
        jsim = JaxSim.factory(_jax_params(params))
        jsim.SetupSimulation()
        records = [_record(jsim, tsim)]
        for _ in range(STEPS):
            jsim.main_loop_step()
            tsim.main_loop_step()
            records.append(_record(jsim, tsim))
    return request.param, tsim, records


def test_fields_match_jax(run):
    """Every field within 1e-9 of its largest value after every step."""
    name, tsim, records = run
    for i, rec in enumerate(records):
        bad = {k: e for k, e in rec["errs"].items()
               if not k.startswith("sink_") and not e <= TOL}
        assert not bad, (name, i, bad)
    assert tsim.ndim == (1 if name == "rod_1d" else 2)
    assert tsim.Nsteps == STEPS


def test_sinks_match_jax(run):
    """The sinks' r, v, a, m, mdot and angmom within 1e-9 and equal
    active slots after every step; sinks form (or the stars stay); the
    spin ledger is (0, 0, z), and exactly zero in 1D."""
    name, tsim, records = run
    for i, rec in enumerate(records):
        bad = {k: e for k, e in rec["errs"].items()
               if k.startswith("sink_") and not e <= TOL}
        assert not bad and rec["same_active"], (name, i, bad)
        assert rec["angmom_xy"] == 0.0
    last = records[-1]
    if name == "binaryacc_2d":
        assert last["active"] == 2
    else:
        assert last["active"] >= 4
    if name == "rod_1d":
        assert not last["angmom_z"].any()
    if name == "disc_block_2d":
        assert np.abs(last["angmom_z"]).max() > 0


def test_eaten_gas_matches_jax(run):
    """Equal alive masks after every step, with gas eaten."""
    name, tsim, records = run
    assert all(rec["same_alive"] for rec in records), name
    assert records[-1]["dead"] > 0


def test_block_levels_match_jax(run):
    """Under block steps (the dense tick with sinks) equal levels and
    nlast after every tick, over at least two levels."""
    name, tsim, records = run
    if not tsim.use_block:
        assert all("same_levels" not in rec for rec in records)
        return
    assert all(rec["same_levels"] for rec in records), name
    assert len(np.unique(tsim.state.level.numpy())) >= 2


def test_binaryacc_ic_is_refused_in_1d_by_both():
    """binaryacc is 2D and 3D only, in the JAX package and the port."""
    p = binaryacc_params(8, ndim=2)
    p.set("ndim", 1)
    with pytest.raises(ValueError, match="2D/3D only"):
        jax_generate_ic(_jax_params(p), None)
    with pytest.raises(ValueError, match="2D/3D only"):
        generate_ic(p, None)


def _stars_only(ndim=2):
    """binaryacc's stars with no sink parameters: the IC alone gives the
    run its slots."""
    p = binaryacc_params(8, ndim=ndim)
    p.set("sink_particles", 0)
    p.set("create_sinks", 0)
    return p


@pytest.mark.parametrize("route", ["parameters", "star_ic"])
def test_slots_from_either_route_are_checked(route):
    """The repair: _check_sink_options runs wherever the run has slots,
    from the sink parameters (in process_parameters) or from the IC's
    stars (in SetupSimulation, before anything is allocated): the
    gaussian kernel with slots (its softened gravity in K14, K16 and K20
    is zero in the JAX package, fault F23; self-gravity off, so that only
    the sink check can refuse it) is refused either way, by name; without
    slots it is not."""
    if route == "parameters":
        p = sink_disc_params(100, 2)
    else:
        p = _stars_only()
    p.set("self_gravity", 0)
    p.set("kernel", "gaussian")
    sim = SimulationBase.factory(p, "cpu", torch.float64)
    if route == "parameters":
        with pytest.raises(NotImplementedError,
                           match="sinks or stars.*F23"):
            sim.process_parameters()
        return
    sim.process_parameters()
    with pytest.raises(NotImplementedError, match="sinks or stars.*F23"):
        sim.SetupSimulation()
    assert sim.state is None


@pytest.mark.parametrize("ndim", [1, 2])
def test_radiation_with_slots_below_3d_is_refused(ndim):
    """Radiation with sink slots at ndim 1 or 2 was refused while
    K34-K37's wrappers were 3D; it now passes the sink checks under each
    scheme (the runs: tests/test_torch_radiation_dims_sim.py)."""
    for scheme in ("ionisation", "treeray", "monoionisation"):
        p = sink_disc_params(64, ndim)
        p.set("radiation", scheme)
        sim = SimulationBase.factory(p, "cpu", torch.float64)
        sim.process_parameters()
        assert sim.radiation == scheme and sim.ndim == ndim


@pytest.mark.parametrize("ndim", [1, 2])
def test_radiative_feedback_with_slots_below_3d_is_refused(ndim):
    """Radiative feedback (rad_fb with the radws relaxation) with sink
    slots at ndim 1 or 2 was refused while K30 was 3D; it now sets up,
    with disc heating about the first slot."""
    p = radfb_params(radws_params(sink_disc_params(64, ndim)))
    sim = SimulationBase.factory(p, "cpu", torch.float64)
    sim.process_parameters()
    assert sim.rad_fb and sim.radfb_disc_cfg.n_central == 1
