"""Port parity: the distributed grad-h SPH controller (Nmpi > 1) on the
CPU, float64, against gandalf_tpu's DistributedGradhSphSimulation on the
virtual CPU devices of tests/conftest.py: the jittered 8^3 box, Nmpi 2
and 4, hydro and LET gravity, 3 steps with the decomposition rebuilt
every 2 (a device migration without gravity, a host replan with it).
Both packages plan alike: the plans are held equal at every step.

Also the port's 1-shard against 4-shard hydro at the JAX package's own
gates (tests/test_dist.py:102), its gravity against the direct sum at
the JAX package's (tests/test_dist.py:126-131), and the refusals."""

import dataclasses

import numpy as np
import pytest
import torch

import gandalf_tpu.sim.ic as jax_ic
from gandalf_tpu.sim.simulation import SimulationBase as JaxBase
from gandalf_tpu_torch.check import dist_box_params, dist_ic
from gandalf_tpu_torch.convert import dist_plan_from_jax, let_plan_from_jax
from gandalf_tpu_torch.ops.sph_gravity import direct_sph_gravity
from gandalf_tpu_torch.parallel.dist import unshard_state
from gandalf_tpu_torch.sim.dist_sim import DistributedGradhSphSimulation
from gandalf_tpu_torch.sim.simulation import (GradhSphSimulation,
                                              SimulationBase)

torch.set_num_threads(1)

TOL = 1e-9
STEPS = 3
NTB = 2
FIELDS = ("r", "v", "u", "h", "rho", "a")


def _params(nmpi, grav, n_side=8, **over):
    return dist_box_params(n_side, nmpi, grav, ntreebuildstep=NTB, **over)


def _port(nmpi, grav, ic, n_side=8, **over):
    sim = SimulationBase.factory(_params(nmpi, grav, n_side, **over), "cpu",
                                 torch.float64,
                                 shard_devices=["cpu"] * max(nmpi, 1))
    sim.SetupSimulation({k: v.copy() for k, v in ic.items()})
    return sim


def _jax(nmpi, grav, ic):
    """The JAX package's controller on the same IC (its generate_ic
    replaced, as tests/test_dist.py does)."""
    sim = JaxBase.factory(_params(nmpi, grav))
    orig = jax_ic.generate_ic
    jax_ic.generate_ic = lambda *a, **k: {k2: np.array(v)
                                          for k2, v in ic.items()}
    try:
        sim.SetupSimulation()
    finally:
        jax_ic.generate_ic = orig
    return sim


def _errors(jsim, tsim, fields):
    want, got = jsim._state_to_host(), tsim._state_to_host()
    return {f: float(np.max(np.abs(got[f] - want[f]))
                     / max(np.max(np.abs(want[f])), 1e-300))
            for f in fields}


def _plans_equal(jsim, tsim):
    jp = dist_plan_from_jax(jsim.distplan)
    tp = tsim.distplan
    assert tp.global_spec == jp.global_spec
    assert tp.cap == jp.cap and tp.balanced == jp.balanced
    np.testing.assert_array_equal(tp.row_len, jp.row_len)
    if jsim.letplan is not None:
        assert dataclasses.replace(tsim.letplan, gmap=None) == \
            dataclasses.replace(let_plan_from_jax(jsim.letplan), gmap=None)


_RUNS = {}


def _pair_run(nmpi, grav):
    """Setup and STEPS steps through both packages, the errors and the
    step's plan check after each (module-wide, computed once)."""
    key = (nmpi, grav)
    if key not in _RUNS:
        ic = dist_ic(_params(nmpi, grav))
        jsim, tsim = _jax(nmpi, grav, ic), _port(nmpi, grav, ic)
        fields = FIELDS + (("gpot",) if grav else ())
        errs = [_errors(jsim, tsim, fields)]
        _plans_equal(jsim, tsim)
        for _ in range(STEPS):
            jsim.main_loop_step()
            tsim.main_loop_step()
            errs.append(_errors(jsim, tsim, fields))
            _plans_equal(jsim, tsim)
        _RUNS[key] = (jsim, tsim, errs)
    return _RUNS[key]


@pytest.mark.parametrize("grav", [0, 1])
@pytest.mark.parametrize("nmpi", [2, 4])
def test_matches_the_jax_controller(nmpi, grav):
    """Setup and 3 steps within 1e-9 of the JAX package's controller,
    across the cadence at step 2 (migration without gravity, a replan
    with it)."""
    jsim, tsim, errs = _pair_run(nmpi, grav)
    worst = {f: max(e[f] for e in errs) for f in errs[0]}
    assert max(worst.values()) <= TOL, worst
    assert tsim.Nsteps == jsim.Nsteps == STEPS
    assert abs(tsim.t - jsim.t) <= TOL * abs(jsim.t)
    if grav:
        assert tsim.n_replans >= 1 and tsim.n_migrations == 0
    else:
        assert tsim.n_migrations + tsim.n_replans >= 1


def test_factory_and_devices():
    """The factory gives the distributed controller for Nmpi 2 and 4 on
    grad-h SPH; Nmpi above the shard devices is refused as the JAX
    package refuses it, and one shard is left to the single-device
    controller; the default shard devices are the visible cards."""
    for nmpi in (2, 4):
        sim = SimulationBase.factory(_params(nmpi, 0), "cpu", torch.float64,
                                     shard_devices=["cpu"] * 4)
        assert type(sim) is DistributedGradhSphSimulation
        assert sim.device.type == "cpu"
    sim = SimulationBase.factory(_params(4, 0), "cpu", torch.float64,
                                 shard_devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="Nmpi=4 > 2 devices"):
        sim.SetupSimulation()
    assert sim.shards is None and sim.gathered_state() is None
    with pytest.raises(ValueError, match="runs Nmpi > 1 shards, not 1"):
        DistributedGradhSphSimulation(_params(1, 0), "cpu", torch.float64,
                                      shard_devices=["cpu"]).SetupSimulation()
    sim = SimulationBase.factory(_params(2, 0), "cpu", torch.float64)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="> 0 devices"):
            sim.SetupSimulation()


def _sorted(sim):
    d = sim._state_to_host()
    order = np.lexsort((d["r"][:, 2], d["r"][:, 1], d["r"][:, 0]))
    return {k: v[order] for k, v in d.items()}


def test_one_shard_matches_four():
    """Hydro over 4 shards against the single-device controller, 3 steps,
    at the JAX package's gates (rtol 2e-11, atol 1e-12)."""
    ic = dist_ic(_params(4, 0))
    one = GradhSphSimulation(_params(1, 0), "cpu", torch.float64)
    one.SetupSimulation({k: v.copy() for k, v in ic.items()})
    four = _port(4, 0, ic)
    for _ in range(STEPS):
        one.main_loop_step()
        four.main_loop_step()
    s1, s4 = _sorted(one), _sorted(four)
    for k in ("r", "v", "rho", "u", "h"):
        np.testing.assert_allclose(s4[k], s1[k], rtol=2e-11, atol=1e-12,
                                   err_msg=k)


def test_gravity_matches_direct_oracle():
    """LET gravity over 4 shards at 12^3 after one step: gpot against
    the direct sum (isolated box) at the JAX package's gates, median
    < 2e-3, p99 < 3e-2."""
    p = _params(4, 1, n_side=12)
    sim = _port(4, 1, dist_ic(p), n_side=12)
    sim.main_loop_step()
    host = unshard_state(sim.distplan, sim.shards, sim._n_orig)
    _, gp_ref = direct_sph_gravity(sim.kern, host.r, host.m, host.h,
                                   host.zeta, host.hfactor)
    err = (torch.abs(host.gpot - gp_ref) / torch.abs(gp_ref)).numpy()
    assert np.median(err) < 2e-3, np.median(err)
    assert np.percentile(err, 99) < 3e-2, np.percentile(err, 99)


@pytest.mark.parametrize("over", [
    {"create_sinks": 1}, {"sink_particles": 1},
    {"dust_forces": "test_particle", "drag_law": "fixed"},
    {"time_dependent_avisc": "cd2010"},
    {"Nlevels": 3}, {"boundary_lhs[1]": "mirror", "boundary_rhs[1]": "mirror"},
    {"self_gravity": 1, "ewald": 1}, {"gas_eos": "radws"},
    {"external_potential": "plummer"},
    {"sim": "sm2012sph"}, {"sim": "meshlessfv"}, {"sim": "mfvrk"}],
    ids=lambda o: "-".join(str(v) for v in o.values()))
def test_refused_options(over):
    """Each option outside the slice raises NotImplementedError naming
    item 13, before any state is built."""
    p = _params(2, 0)
    for k, v in over.items():
        p.set(k, v)
    with pytest.raises(NotImplementedError, match="item 13"):
        sim = SimulationBase.factory(p, "cpu", torch.float64,
                                     shard_devices=["cpu"] * 2)
        sim.SetupSimulation()
    assert getattr(locals().get("sim"), "shards", None) is None


def test_stars_in_the_ic_refused():
    """Stars in the IC are refused before the state is built."""
    ic = dist_ic(_params(2, 0))
    ic["star"] = {"r": np.zeros((1, 3)), "v": np.zeros((1, 3)),
                  "m": np.ones(1), "h": np.ones(1)}
    sim = SimulationBase.factory(_params(2, 0), "cpu", torch.float64,
                                 shard_devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="item 13"):
        sim.SetupSimulation(ic)
    assert sim.shards is None
