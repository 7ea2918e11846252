"""Port parity: radiation and radiative feedback below 3D, radiation in
SM2012 and with dust, through the port's controllers on the CPU against
gandalf_tpu's, float64.

- The HII region below 3D (check.hii_ic: the lattice disc of about 300
  particles, the rod of 250, one star of mass 1e-6 at the origin, the
  flat stellar table at each scheme's check.spitzer_ndot for Rs = 0.35),
  handed as one IC to both packages (the JAX package's spitzer IC is 3D
  only): 3 steps under ionisation, treeray and monoionisation on the disc
  (the Monte-Carlo draws made with jax.random as the JAX package makes
  them and handed to the port) and under ionisation on the rod.
- SM2012 with radiation (ionisation) in 3D (the Spitzer sphere) and 2D.
- Radiative feedback on the 2D sink disc (check.sink_disc_params on the
  radws relaxation, disc heating about the first slot) and on the 1D rod
  with a star (check.radfb_rod), 4 steps each with the JAX tree's COMs
  clamped as the port's (fault F30).

After every step ionfrac is equal and r, v, u and dt agree to 1e-9 of
each field's largest value.  Also: a dusty run with a radiation scheme
(no slots: dust with sinks is refused, F14) makes no update in either
package and equals the same run without radiation; and fault F31, the
JAX package's treeray flux law, which divides by 4 pi d^2 at every
ndim, shown on its 2D function.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.ops import treeray as jtr
from gandalf_tpu.ops.mcrt import isotropic_directions
from gandalf_tpu.ops.stellar import StellarTable
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.simulation import SimulationBase as JaxSim
from gandalf_tpu.state import OPEN, DomainBox
from gandalf_tpu_torch.check import (dustybox_params, hii_ic, radfb_params,
                                     radfb_rod, radws_params,
                                     sink_disc_params, spitzer_ndot,
                                     spitzer_params, spitzer_star)
from gandalf_tpu_torch.convert import (mc_draws_from_numpy,
                                       stellar_table_from_jax)
from gandalf_tpu_torch.sim.ic import spitzer_ic
from gandalf_tpu_torch.sim.simulation import SimulationBase
from test_torch_sink_dims_sim import clamp_jax_com

torch.set_num_threads(1)

TOL = 1e-9
FIELDS = ("u", "r", "v")
STEPS = 3
N_DISC = 300
# the rod: at 250 particles Rs = 0.35 falls half a particle between two
# lattice shells (0.35 N = 87.5), off the knife edge where the ionised
# prefix's sum meets Ndot to the last bit
N_ROD = 250
# the Monte-Carlo disc: 700 particles, the cross-section raised so the
# front is optically thick
N_MC = 700
MC_ACROSS = 50.0


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _jax_draws(ndim):
    def draws(seed, ndot, n_packets, n_iter):
        """The JAX package's draws of monochromatic_ionisation_mc
        (gandalf_tpu/ops/mcrt.py:129-147, 196-198) as numpy arrays."""
        L = jnp.asarray(ndot)
        out = []
        for k in jax.random.split(jax.random.PRNGKey(seed), n_iter):
            k1, k2 = jax.random.split(k)
            src = jax.random.choice(k1, L.shape[0], (n_packets,),
                                    p=L / jnp.maximum(jnp.sum(L), 1e-300))
            out.append((np.asarray(src), np.asarray(
                isotropic_directions(k2, n_packets, ndim))))
        return out
    return draws


def _flat_table(ndot):
    logn = np.log10(ndot)
    return StellarTable(mass=np.asarray([0.0, 1e3]), log_lum=np.zeros(2),
                        log_nlyc=np.asarray([logn, logn]),
                        teff=np.full(2, 4e4), mdot=np.zeros(2),
                        vwind=np.zeros(2))


def _setup(params, ic):
    """Both controllers of `params` on the IC dict `ic` (the JAX package
    takes it as staged restart data), the flat stellar table at the
    scheme's Ndot set after setup as tests/test_spitzer.py sets it."""
    jsim = JaxSim.factory(_jax_params(params))
    jsim.restart_data = {k: v for k, v in ic.items()}
    jsim.SetupSimulation()
    tsim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
    tsim.SetupSimulation({k: v for k, v in ic.items()})
    scheme, ndim = params.stringparams["radiation"], params.intparams["ndim"]
    jsim.stellar_table = _flat_table(spitzer_ndot(scheme, ndim=ndim))
    tsim.stellar_table = stellar_table_from_jax(jsim.stellar_table)
    if scheme == "monoionisation":
        jsim.mc_across = tsim.mc_across = MC_ACROSS
        draws = _jax_draws(ndim)
        tsim.mc_draw_fn = lambda seed, ndot, n, it: mc_draws_from_numpy(
            draws(seed, ndot.numpy(), n, it))
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


def _steps(jsim, tsim, tag):
    for k in range(STEPS):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _compare(jsim, tsim, (tag, k))


@pytest.mark.parametrize("scheme,ndim", [("ionisation", 2), ("treeray", 2),
                                         ("monoionisation", 2),
                                         ("ionisation", 1)])
def test_hii_region_steps(scheme, ndim):
    """Three steps of the disc (the rod) with its star: the first update
    carves the HII region, ionfrac equal and the fields within 1e-9."""
    n = {1: N_ROD, 2: N_MC if scheme == "monoionisation" else N_DISC}[ndim]
    over = {"Nphotonratio": 1.0} if scheme == "monoionisation" else {}
    params = spitzer_params(n, scheme, ndim=ndim, **over)
    jsim, tsim = _setup(params, hii_ic(n, ndim))
    assert tsim.ndim == ndim and tsim.has_sinks
    _steps(jsim, tsim, (scheme, ndim))
    ion = tsim.state.ionfrac.numpy() > 0.5
    assert ion.any() and not ion.all()


@pytest.mark.parametrize("ndim", [3, 2])
def test_sm2012_with_radiation(ndim):
    """SM2012 with the ionisation scheme: the JAX SM2012 controller
    inherits the grad-h hook, and so does the port's."""
    params = spitzer_params(N_DISC, "ionisation", ndim=ndim, sim="sm2012sph")
    if ndim == 3:
        ic = dict(spitzer_ic(params, None), star=spitzer_star())
    else:
        ic = hii_ic(N_DISC, ndim)
    jsim, tsim = _setup(params, ic)
    assert type(tsim).__name__ == "SM2012SphSimulation"
    _steps(jsim, tsim, ("sm2012", ndim))
    ion = tsim.state.ionfrac.numpy() > 0.5
    assert ion.any() and not ion.all()


def test_radiative_feedback_sink_disc_2d():
    """Radiative feedback on the 2D sink disc (400 particles, sinks
    forming at rho_sink 0.3, the radws relaxation toward K30's ambient
    temperature with disc heating about the first slot): 4 steps, the
    fields, the sinks and the alive masks as the JAX package's."""
    params = radfb_params(radws_params(sink_disc_params(
        400, 2, 0.3, ntreebuildstep=4, tend=1.0)))
    tsim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
    tsim.SetupSimulation()
    assert tsim.rad_fb and tsim.radfb_disc_cfg.n_central == 1
    with pytest.MonkeyPatch.context() as mp:
        clamp_jax_com(mp)
        jsim = JaxSim.factory(_jax_params(params))
        jsim.SetupSimulation()
        for k in range(4):
            jsim.main_loop_step()
            tsim.main_loop_step()
            js, ts = jsim.state, tsim.state
            alive = np.asarray(js.alive)
            assert np.array_equal(ts.alive.numpy(), alive), k
            for f in ("u", "r", "v", "ueq"):
                want = np.asarray(getattr(js, f))[alive]
                got = getattr(ts, f).numpy()[alive]
                err = np.max(np.abs(got - want)) / np.max(np.abs(want))
                assert err <= TOL, (k, f, err)
            assert np.array_equal(ts.sinks.active.numpy(),
                                  np.asarray(jsim.sinks.active))
    assert int(tsim.state.sinks.active.sum()) >= 1
    assert np.isfinite(tsim.state.ueq.numpy()).all()


def test_radiative_feedback_star_rod_1d():
    """Radiative feedback in 1D (check.radfb_rod: the 64-particle rod with
    a stellar-class star accreting from it, sink and ambient heating):
    4 steps, the fields and the alive masks as the JAX package's."""
    params, ic = radfb_rod(64)
    tsim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
    tsim.SetupSimulation({k: v for k, v in ic.items()})
    with pytest.MonkeyPatch.context() as mp:
        clamp_jax_com(mp)
        jsim = JaxSim.factory(_jax_params(params))
        jsim.restart_data = {k: v for k, v in ic.items()}
        jsim.SetupSimulation()
        for k in range(4):
            jsim.main_loop_step()
            tsim.main_loop_step()
            js, ts = jsim.state, tsim.state
            alive = np.asarray(js.alive)
            assert np.array_equal(ts.alive.numpy(), alive), k
            for f in ("u", "r", "v", "ueq"):
                want = np.asarray(getattr(js, f))[alive]
                got = getattr(ts, f).numpy()[alive]
                err = np.max(np.abs(got - want)) / np.max(np.abs(want))
                assert err <= TOL, (k, f, err)
    assert tsim.ndim == 1 and int((~tsim.state.alive).sum()) > 0
    assert float(tsim.state.ueq.max()) > float(tsim.state.ueq.min())


def test_dust_with_radiation_makes_no_update():
    """A dusty run has no slots (dust with sinks or stars is refused,
    F14), so a radiation scheme makes no update there in either package:
    ten steps of the 1D dusty box with treeray equal those without, bit
    for bit, in both; ionfrac stays 0."""
    out = {}
    for scheme in ("none", "treeray"):
        params = dustybox_params(16, 1)
        params.set("radiation", scheme)
        tsim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
        tsim.SetupSimulation()
        jsim = JaxSim.factory(_jax_params(params))
        jsim.SetupSimulation()
        for _ in range(10):
            tsim.main_loop_step()
            jsim.main_loop_step()
        assert not tsim.has_sinks and not jsim.has_sinks
        assert not tsim.state.ionfrac.any()
        assert not np.asarray(jsim.state.ionfrac).any()
        out[scheme] = (tsim.state, jsim.state)
    for f in ("r", "v", "u", "rho", "h"):
        for i in range(2):
            a = np.asarray(getattr(out["none"][i], f))
            b = np.asarray(getattr(out["treeray"][i], f))
            assert np.array_equal(a, b), (f, i)
        want = np.asarray(getattr(out["none"][1], f))
        err = np.max(np.abs(out["none"][0].__getattribute__(f).numpy()
                            - want)) / np.max(np.abs(want))
        assert err <= TOL, f


def test_treeray_flux_law_is_3d_f31():
    """Fault F31: the JAX package's treeray_ionisation divides Ndot by
    4 pi d^2 at every ndim (gandalf_tpu/ops/treeray.py:199-200), a 3D
    point source's flux; a 2D source's falls as 1 / (2 pi d).  On a
    uniform 2D medium of n_H = 1 its front lies where the 3D law puts it,
    d^3 = Ndot / (4 pi alphaB n_H^2): Ndot = 4 pi Rs^3 ionises out to Rs
    = 0.2, and the 2D law's Ndot for a front at Rs, 2 pi Rs^2, ionises
    out to (Rs^2 / 2)^(1/3) = 0.271, not Rs: the fronts' ratio is the 3D
    law's."""
    rng = np.random.default_rng(2)
    n = 6000
    r = rng.uniform(-1.0, 1.0, (n, 2))
    m, rho = np.full(n, 4.0 / n), np.ones(n)
    box = DomainBox(ndim=2, boxmin=(-1.0, -1.0), boxmax=(1.0, 1.0),
                    lhs=(OPEN, OPEN), rhs=(OPEN, OPEN))
    spec = jg.plan_grid27(box, r, 0.05, 2.0)
    b = jg.bin_particles(spec, jnp.asarray(r))
    _, nh2 = jtr.cell_field(spec, b, jnp.asarray(m), jnp.asarray(rho))
    d = np.sqrt((r ** 2).sum(-1))
    rs = 0.2
    fronts = {}
    for law, ndot in (("3d", 4.0 * np.pi * rs ** 3),
                      ("2d", 2.0 * np.pi * rs ** 2)):
        ion = np.asarray(jtr.treeray_ionisation(
            spec, nh2, jnp.asarray(r), jnp.zeros((1, 2)),
            jnp.asarray([ndot]), jnp.asarray([True]), 1.0))
        fronts[law] = float(d[ion].max())
    # the outermost ionised particle of a random medium on a grid of
    # cells 0.05 across lies within 15% of the law's front; the two
    # fronts' ratio, (Rs^2 / 2)^(1/3) / Rs = 1.357, within 5%
    assert abs(fronts["3d"] - rs) < 0.15 * rs, fronts
    ratio = (rs ** 2 / 2.0) ** (1.0 / 3.0) / rs
    assert abs(fronts["2d"] / fronts["3d"] - ratio) < 0.05 * ratio, fronts
