"""Port parity: dust runs through both controllers, float64 on the CPU.

- The 1D dusty box (tests/test_dust.py:20-40 on the grid path, 32 gas +
  32 dust), 10 steps, periodic and between mirror walls: v, rho, u, h
  and t within 1e-9 of the JAX package's.
- The dusty Evrard cloud (check.dust_params at Nhydro 1000: 912 gas +
  912 dust, tree gravity), 3 steps two-fluid and 3 test-particle, and 6
  dense block ticks with Nlevels 3 and equal levels on every tick.
- The JAX package's tree accuracy on the same cloud with the dust's
  gravitating masses, the reading dusty_evrard's gate refers to.
- The gravitating mass (dust in two-fluid runs only), the timestep of
  the dust's u = 0 lanes, convert's carry-over of ptype and the dust's
  fields, and the refusals: dust with sinks or stars (fault F14) and
  dust with neib_search = bruteforce.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.integrate import leapfrog as jleap
from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import tree as jt
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu_torch.check import dust_params, dustybox_params
from gandalf_tpu_torch.convert import grid_spec_from_jax, state_from_numpy
from gandalf_tpu_torch.integrate import leapfrog as tleap
from gandalf_tpu_torch.ops import sph_gravity as tg
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation
from gandalf_tpu_torch.state import DUST_TYPE

torch.set_num_threads(1)

TOL_SIM = 1e-9
BOX_FIELDS = ("v", "rho", "u", "h")
CLOUD_FIELDS = ("r", "v", "u", "h", "rho", "gpot")


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _both(params):
    jsim = JaxSim(_jax_params(params))
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(params.copy(), device="cpu",
                              dtype=torch.float64)
    tsim.SetupSimulation()
    return jsim, tsim


def _same(jsim, tsim, fields, where):
    errs = {f: _rel(getattr(tsim.state, f), getattr(jsim.state, f))
            for f in fields}
    errs["t"] = _rel(tsim.state.t, jsim.state.t)
    bad = {k: e for k, e in errs.items() if not e <= TOL_SIM}
    assert not bad, f"{where}: {bad}"


def _steps(jsim, tsim, n, fields, levels=False):
    for i in range(n):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _same(jsim, tsim, fields, f"step {i + 1}")
        if levels:
            assert np.array_equal(tsim.state.level.numpy(),
                                  np.asarray(jsim.state.level)), i


@pytest.mark.parametrize("mirror", [False, True], ids=["periodic", "walls"])
def test_dustybox_steps_match_jax(mirror):
    jsim, tsim = _both(dustybox_params(32, 1,
                                       mirror_dim=0 if mirror else None))
    assert jsim.use_celllist and tsim.has_dust
    assert tsim.gridspec == grid_spec_from_jax(jsim.gridspec)
    _same(jsim, tsim, BOX_FIELDS, "bootstrap")
    _steps(jsim, tsim, 10, BOX_FIELDS)
    s = tsim.state
    dust = s.ptype == DUST_TYPE
    # the dust carries no thermal state and takes the drag's sound speed
    assert not s.u[dust].any() and not s.pressure[dust].any()
    assert (s.sound[dust] > 0).all()
    # the drag slowed the dust and dragged the gas
    assert float(s.v[dust, 0].mean()) < 0.995
    assert float(s.v[~dust, 0].mean()) > 0.005


@pytest.mark.parametrize("mode", ["full_twofluid", "test_particle"])
def test_dusty_evrard_steps_match_jax(mode):
    jsim, tsim = _both(dust_params(1000, mode))
    assert tsim.state.N == 1824 and tsim.self_gravity
    _same(jsim, tsim, CLOUD_FIELDS, "bootstrap")
    _steps(jsim, tsim, 3, CLOUD_FIELDS)


def test_dusty_evrard_block_ticks_match_jax():
    """The dense block tick with dust (gandalf_tpu/sim/simulation.py:
    1854-1880): every particle's pass each tick, the drag over each
    particle's own step nstep_part dt_base."""
    jsim, tsim = _both(dust_params(1000, nlevels=3))
    assert tsim.use_block
    _steps(jsim, tsim, 6, CLOUD_FIELDS, levels=True)
    assert len(np.unique(tsim.state.level.numpy())) > 1


def test_jax_tree_accuracy_on_the_dusty_cloud():
    """The JAX package's quadrupole tree (theta^2 = 0.1, KD buckets)
    against the all-pairs sum with the dust's gravitating masses, float64,
    on the 1,824-particle dusty Evrard cloud after setup: 1.5e-4, within
    the box's gate of 2e-4, which dusty_evrard therefore keeps.  The
    port's plain path makes the state."""
    sim = GradhSphSimulation(dust_params(1000), device="cpu",
                             dtype=torch.float64)
    sim.SetupSimulation()
    s = sim.state
    m = sim._gravity_mass(s)
    ref, _ = tg.direct_sph_gravity(sim.kern, s.r, m, s.h, s.zeta,
                                   s.hfactor)
    a, _, ovf = jt.tree_gravity_grouped(
        jt.TreeSpec(**dataclasses.asdict(sim.treespec)),
        jnp.asarray(s.bucket_map.numpy()), jnp.asarray(s.r.numpy()),
        jnp.asarray(m.numpy()), jnp.asarray(s.h.numpy()),
        jax_kernel("m4", 3), zh=jnp.asarray((s.zeta * s.hfactor).numpy()),
        alive=jnp.asarray(s.alive.numpy()))
    assert not bool(ovf)
    da = np.asarray(a) - ref.numpy()
    err = float(np.sqrt(np.sum(da * da) / np.sum(ref.numpy() ** 2)))
    print(f"gandalf_tpu dusty Evrard N={s.N} float64: rms|da|/rms|a| "
          f"{err:.3e}")
    assert err <= 2e-4


@pytest.mark.parametrize("mode", ["full_twofluid", "test_particle"])
def test_gravity_mass_counts_dust_in_two_fluid_runs(mode):
    """gandalf_tpu/sim/simulation.py:571-581: dust gravitates in full
    two-fluid runs only."""
    sim = GradhSphSimulation(dust_params(200, mode), device="cpu",
                             dtype=torch.float64)
    sim.process_parameters()
    N = 10
    ptype = torch.tensor([0, 3] * (N // 2), dtype=torch.int32)
    s = _tiny_state(N).replace(ptype=ptype)
    m = sim._gravity_mass(s)
    dust = ptype == DUST_TYPE
    assert torch.equal(m[~dust], s.m[~dust])
    if mode == "full_twofluid":
        assert torch.equal(m[dust], s.m[dust])
    else:
        assert not m[dust].any()


def _tiny_state(N):
    from gandalf_tpu_torch.state import make_sph_state

    rng = np.random.default_rng(0)
    return make_sph_state(rng.random((N, 3)), np.zeros((N, 3)),
                          1.0 + rng.random(N), np.full(N, 0.1), np.ones(N))


def test_timestep_and_carry_over_of_a_dust_state():
    """sph_timestep leaves out the energy criterion of the dust's u = 0
    lanes as the JAX package does, and convert carries ptype and the
    dust's h, rho and zeta from a JAX state."""
    jsim = JaxSim(_jax_params(dustybox_params(32, 1)))
    jsim.SetupSimulation()
    fields = {k: np.asarray(v) for k, v in vars(jsim.state).items()
              if hasattr(v, "shape")}
    ts = state_from_numpy(fields)
    dust = fields["ptype"] == DUST_TYPE
    assert dust.sum() == 32 and (fields["u"][dust] == 0).all()
    assert np.array_equal(ts.ptype.numpy(), fields["ptype"])
    for f in ("h", "rho", "zeta"):
        assert np.array_equal(getattr(ts, f).numpy(), fields[f]), f
    tcfg = tleap.IntegratorConfig.from_params(dustybox_params(32, 1), True)
    want = np.asarray(jleap.sph_timestep(jsim.integ, jsim.state, True))
    got = tleap.sph_timestep(tcfg, ts, True).numpy()
    assert np.array_equal(got, want)
    assert np.isfinite(got[dust]).all() and (got[dust] < 1e29).all()


@pytest.mark.parametrize("case", ["create_sinks", "sink_particles",
                                  "stars_in_ic", "bruteforce"])
def test_refusals(case):
    """Dust with sinks or stars raises naming ROADMAP item 9 and fault F14
    (the JAX package's sink paths apply no drag); bruteforce raises as it
    does for every configuration."""
    p = dust_params(200)
    if case == "bruteforce":
        p.set("neib_search", "bruteforce")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            GradhSphSimulation(p, device="cpu").process_parameters()
        return
    if case != "stars_in_ic":
        p.set(case, 1)
        with pytest.raises(NotImplementedError, match="F14.*item 9"):
            GradhSphSimulation(p, device="cpu").process_parameters()
        return
    sim = GradhSphSimulation(p, device="cpu", dtype=torch.float64)
    ic = {"r": np.zeros((2, 3)), "v": np.zeros((2, 3)), "m": np.ones(2),
          "h": np.ones(2), "u": np.ones(2),
          "star": {"r": np.zeros((1, 3)), "v": np.zeros((1, 3)),
                   "m": np.ones(1), "h": np.ones(1)}}
    with pytest.raises(NotImplementedError, match="F14.*item 9"):
        sim.SetupSimulation(ic)


@pytest.mark.parametrize("key", ["dust_forces", "drag_law"])
def test_unknown_dust_options_raise(key):
    """An unknown dust_forces or drag_law raises ValueError naming it."""
    p = dust_params(200)
    p.set(key, "stokes")
    with pytest.raises(ValueError, match=f"unknown {key} 'stokes'"):
        GradhSphSimulation(p, device="cpu").process_parameters()
