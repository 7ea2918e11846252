"""Port parity: the radiation schemes through the port's
GradhSphSimulation on the CPU against gandalf_tpu's, float64.

The Spitzer HII region of tests/test_spitzer.py at 280 particles
(the lattice sphere, one star of mass 1e-6 at the origin, the flat
stellar table with Ndot = 4 pi/3 rho0^2 Rs^3 at Rs = 0.35, 4 pi rho0^2
Rs^3 for treeray as tests/test_treeray.py sets it): three
main_loop_steps under ionisation, treeray and monoionisation (at 739
particles, the Monte-Carlo packets' draws made with jax.random as the
JAX package makes them and handed to the port, and the cross-section
raised so the front is optically thick), and 3 block ticks of ionisation with Nlevels = 2.
ionfrac must be equal and u, r, v and dt agree to 1e-10 of each field's
largest value after every step.  (The lattice sphere ties its shells of
equal distance exactly; after a step the ionisation scheme ranks a shell
by each package's rounding noise, so the flags inside the front's shell
may part from the second update on: the block run updates once.)  A run
without sinks makes no update in either package; MFV and N-body refuse radiation (fault F26), SM2012 and
dust with radiation are refused (ROADMAP item 12).
"""

import numpy as np
import pytest
import torch

import gandalf_tpu.sim.ic as jax_ic
import gandalf_tpu.sim.simulation as jax_sim_mod
import jax
import jax.numpy as jnp
from gandalf_tpu.ops.mcrt import isotropic_directions
from gandalf_tpu.ops.stellar import StellarTable
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu_torch.check import spitzer_ndot, spitzer_params, spitzer_star
from gandalf_tpu_torch.convert import (mc_draws_from_numpy,
                                       stellar_table_from_jax)
from gandalf_tpu_torch.sim.ic import spitzer_ic
from gandalf_tpu_torch.sim.simulation import (GradhSphSimulation,
                                              SimulationBase)

torch.set_num_threads(1)

TOL = 1e-10
FIELDS = ("u", "r", "v")
N_SPHERE = 300
# the Monte-Carlo scheme's sphere: at 700 particles the grid has 3^3
# cells, the source's cell ionised and the rest neutral at this
# cross-section (code length units); at 500 it has 2^3 about the source
N_MC = 700
MC_ACROSS = 50.0


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _jax_draws(seed, ndot, n_packets, n_iter):
    """The JAX package's draws of monochromatic_ionisation_mc
    (gandalf_tpu/ops/mcrt.py:151-198) as numpy arrays."""
    L = jnp.asarray(ndot)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_iter)
    out = []
    for k in keys:
        k1, k2 = jax.random.split(k)
        src = jax.random.choice(k1, L.shape[0], (n_packets,),
                                p=L / jnp.maximum(jnp.sum(L), 1e-300))
        out.append((np.asarray(src), np.asarray(
            isotropic_directions(k2, n_packets, 3))))
    return out


def _setup(params, star=True):
    """Both controllers on the same IC (the JAX package's spitzer IC
    with the star), the flat stellar table set after setup as
    tests/test_spitzer.py sets it."""
    orig = jax_ic.generate_ic
    ics = {}

    def with_star(p, eos):
        ic = orig(p, eos)
        if star:
            ic["star"] = spitzer_star()
        ics["ic"] = ic
        return ic

    jax_ic.generate_ic = jax_sim_mod.generate_ic = with_star
    try:
        jsim = JaxSim(_jax_params(params))
        jsim.SetupSimulation()
    finally:
        jax_ic.generate_ic = jax_sim_mod.generate_ic = orig
    tsim = GradhSphSimulation(params.copy(), device="cpu",
                              dtype=torch.float64)
    tsim.SetupSimulation({k: v for k, v in ics["ic"].items()})
    logn = np.log10(spitzer_ndot(params.stringparams["radiation"]))
    jsim.stellar_table = StellarTable(
        mass=np.asarray([0.0, 1e3]), log_lum=np.zeros(2),
        log_nlyc=np.asarray([logn, logn]), teff=np.full(2, 4e4),
        mdot=np.zeros(2), vwind=np.zeros(2))
    tsim.stellar_table = stellar_table_from_jax(jsim.stellar_table)
    if params.stringparams["radiation"] == "monoionisation":
        jsim.mc_across = tsim.mc_across = MC_ACROSS
        tsim.mc_draw_fn = lambda seed, ndot, n, it: mc_draws_from_numpy(
            _jax_draws(seed, ndot.numpy(), n, it))
    return jsim, tsim


def _compare(jsim, tsim, where):
    js, ts = jsim.state, tsim.state
    assert np.array_equal(ts.ionfrac.numpy(), np.asarray(js.ionfrac)), where
    for f in FIELDS:
        want = np.asarray(getattr(js, f))
        got = getattr(ts, f).numpy()
        err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)
        assert err <= TOL, (where, f, err)
    want = float(js.dt)
    assert abs(float(ts.dt) - want) <= TOL * abs(want), where


@pytest.mark.parametrize("scheme", ["ionisation", "treeray",
                                    "monoionisation"])
def test_spitzer_steps(scheme):
    """Three steps of the Spitzer sphere: the first update carves the
    Stromgren sphere, ionfrac equal and the fields within 1e-10 after
    every step."""
    over = {"radiation": scheme}
    if scheme == "monoionisation":
        # max(Nphotonratio N, 4096) = 4096 packets
        over.update(Nhydro=N_MC, Nphotonratio=1.0)
    jsim, tsim = _setup(spitzer_params(N_SPHERE, **over))
    for k in range(3):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _compare(jsim, tsim, (scheme, k))
    ion = tsim.state.ionfrac.numpy() > 0.5
    assert ion.any() and not ion.all()


def test_spitzer_block_ticks():
    """Three dense block ticks (Nlevels = 2) of the ionisation scheme, the
    field updated before the first (nradstep = 3).  A later update would
    rank the lattice's shells of equal distance by the rounding noise of
    the ticks, which differs between the packages, so the flags would
    part inside the front's shell."""
    jsim, tsim = _setup(spitzer_params(N_SPHERE, Nlevels=2, nradstep=3))
    for k in range(3):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _compare(jsim, tsim, ("block", k))
        assert np.array_equal(tsim.state.level.numpy(),
                              np.asarray(jsim.state.level))


def test_no_sinks_no_update():
    """Without sinks or stars neither package updates the field: ionfrac
    stays 0 and the wrapped EOS runs as its base."""
    jsim, tsim = _setup(spitzer_params(N_SPHERE), star=False)
    assert not tsim.has_sinks and not jsim.has_sinks
    for k in range(2):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _compare(jsim, tsim, ("no sinks", k))
    assert not tsim.state.ionfrac.any()


def test_bursts_stop_at_updates():
    """With nradstep = 3 a burst never crosses an update: the steps a
    call takes end where the next update is due."""
    tsim = GradhSphSimulation(spitzer_params(N_SPHERE, nradstep=3),
                              device="cpu", dtype=torch.float64)
    ic = spitzer_ic(tsim.params, None)
    ic["star"] = spitzer_star()
    tsim.SetupSimulation(ic)
    taken = [tsim.main_loop_steps(8) for _ in range(4)]
    assert taken == [1, 2, 1, 2]
    assert tsim.Nsteps == 6


@pytest.mark.parametrize("sim", ["meshlessfv", "nbody"])
def test_radiation_refused_f26(sim):
    """The JAX package's MFV and N-body controllers never read
    `radiation`: the port refuses it there (fault F26)."""
    p = spitzer_params(64, radiation="ionisation")
    p.set("sim", sim)
    # MFV refuses sinks first (fault F16)
    p.set("sink_particles", 0)
    controller = SimulationBase.factory(p, "cpu", torch.float64)
    with pytest.raises(NotImplementedError, match="F26"):
        controller.SetupSimulation()


@pytest.mark.parametrize("what", ["sm2012sph", "dust"])
def test_radiation_refusals(what):
    """SM2012 and dust with radiation are refused, naming item 12."""
    p = spitzer_params(64, radiation="treeray")
    if what == "dust":
        p.set("dust_forces", "test_particle")
        p.set("sink_particles", 0)
    else:
        p.set("sim", what)
    controller = SimulationBase.factory(p, "cpu", torch.float64)
    with pytest.raises(NotImplementedError, match="item 12"):
        controller.SetupSimulation()
