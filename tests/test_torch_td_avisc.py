"""Port parity: time-dependent artificial viscosity (time_dependent_avisc
= mm97 and cd2010), float64 on the CPU against gandalf_tpu.

- K21's plain version (ops/forces.py:cullen_dehnen_sums_plain through
  cullen_dehnen_dense) against gandalf_tpu's cullen_dehnen_dense at
  ndim 1, 2 and 3, in periodic and open boxes with dead particles and
  an isolated pair (a singular rr: the bad branch);
- _cd2010_finalize against the JAX function on random sums, with
  singular and ill-conditioned rr, and the all-pairs oracle
  cullen_dehnen_alpha against the JAX package's and the stencil form;
- 8 Sod steps (check.sod_params at 128 + 32) with mm97, with cd2010,
  and with cd2010 between mirror walls, through both controllers:
  alpha, r, v, u, h and rho within 1e-9;
- ROADMAP fault F13: under block timesteps the JAX package advances
  alpha by MM97's law whatever the scheme, so a cd2010 run and an mm97
  run of the block sphere (check.sphere_block_params without gravity)
  give the same alpha; the port keeps this, and its cd2010 run matches
  the JAX package's over 3 ticks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import forces as jforces
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu_torch.check import sod_params, sphere_block_params
from gandalf_tpu_torch.convert import grid_spec_from_jax
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import forces as tforces
from gandalf_tpu_torch.ops import sph_grid27 as tg
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation
from gandalf_tpu_torch.state import OPEN, PERIODIC, DomainBox

torch.set_num_threads(1)

TOL = 1e-10
TOL_SIM = 1e-9
FIELDS = ("alpha", "r", "v", "u", "h", "rho")


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


def _visc(module):
    return module.ArtificialViscosity(avisc=module.AVISC_MON97MM97,
                                      alpha_visc=1.0, alpha_visc_min=0.1)


@pytest.mark.parametrize("ndim,periodic", [(1, True), (1, False),
                                           (2, True), (2, False),
                                           (3, True), (3, False)])
def test_cullen_dehnen_plain_matches_jax(ndim, periodic):
    rng = np.random.default_rng(10 * ndim + periodic)
    n = {1: 100, 2: 300, 3: 600}[ndim]
    code = PERIODIC if periodic else OPEN
    box = (ndim, (0.0,) * ndim, (1.0,) * ndim, (code,) * ndim,
           (code,) * ndim)
    r = rng.random((n, ndim))
    if not periodic:
        # an isolated pair: rr is singular (rank 1) in 2D and 3D, and in
        # 1D a lone particle's rr is 0
        r[0], r[1] = 1.6, 1.6
        r[1, 0] = 1.601 if ndim > 1 else 2.4
    v = rng.standard_normal((n, ndim))
    a = rng.standard_normal((n, ndim))
    m = np.full(n, 1.0 / n)
    h = 1.3 * (1.0 / n) ** (1.0 / ndim) * (1.0 + 0.2 * rng.random(n))
    rho = 1.0 + 0.1 * rng.random(n)
    hfactor = h ** -(ndim + 1)
    alpha = 0.1 + rng.random(n)
    sound = 1.0 + rng.random(n)
    alive = rng.random(n) > 0.05
    alive[:2] = True
    alpha[:2] = 0.1
    jspec = jg.plan_grid27(JaxBox(*box), r, h.max() * 1.3, 2.0)
    args = (r, v, a, m, h, rho, sound, hfactor, alpha, alive)

    # one jitted program: eager JAX compiles each small op anew
    @jax.jit
    def jax_switch(*x):
        b = jg.bin_particles(jspec, x[0], discard=~x[-1])
        return jforces.cullen_dehnen_dense(jax_kernel("m4", ndim),
                                           _visc(jforces), jspec, b, *x)

    ja, jd = jax_switch(*map(jnp.asarray, args))
    T = torch.tensor
    ta, td = tforces.cullen_dehnen_dense(
        kernel_factory("m4", ndim), _visc(tforces),
        grid_spec_from_jax(jspec), *map(T, args))
    assert _rel(ta, ja) <= TOL
    assert _rel(td, jd) <= TOL
    ja = np.asarray(ja)
    assert (ja[~alive] == alpha[~alive]).all()
    assert (ja > alpha + 1e-12).any()
    if not periodic:
        assert ja[0] == 1.0 and ja[1] == 1.0      # bad: alpha_visc


def test_cullen_dehnen_oracle_matches_jax():
    """The all-pairs oracle (cullen_dehnen_alpha, tests only) against the
    JAX package's, and against the port's stencil form on the same
    periodic box: beyond the support every pair adds exactly zero."""
    rng = np.random.default_rng(21)
    n = 300
    box = (3, (0.0,) * 3, (1.0,) * 3, (PERIODIC,) * 3, (PERIODIC,) * 3)
    r = rng.random((n, 3))
    v, a = rng.standard_normal((n, 3)), rng.standard_normal((n, 3))
    m = np.full(n, 1.0 / n)
    h = 1.2 * (1.0 / n) ** (1.0 / 3.0) * (1.0 + 0.1 * rng.random(n))
    rho = 1.0 + 0.1 * rng.random(n)
    hfactor, alpha = h ** -4, 0.1 + rng.random(n)
    sound = 1.0 + rng.random(n)
    args = (r, v, a, m, h, rho, sound, hfactor, alpha)
    ext = (r, v, a, m)
    ja, jd = jax.jit(lambda *x: jforces.cullen_dehnen_alpha(
        jax_kernel("m4", 3), _visc(jforces), JaxBox(*box), *x))(
        *map(jnp.asarray, args + ext))
    T = torch.tensor
    ta, td = tforces.cullen_dehnen_alpha(
        kernel_factory("m4", 3), _visc(tforces), DomainBox(*box),
        *map(T, args + ext))
    assert _rel(ta, ja) <= TOL and _rel(td, jd) <= TOL
    spec = tg.plan_grid27(DomainBox(*box), r, h.max() * 1.3, 2.0)
    da, dd = tforces.cullen_dehnen_dense(
        kernel_factory("m4", 3), _visc(tforces), spec, *map(T, args),
        torch.ones(n, dtype=torch.bool))
    assert _rel(da, ta) <= TOL and _rel(dd, td) <= TOL


def test_cd2010_finalize_matches_jax():
    """Random sums, one singular rr (det 0: the identity takes its
    place) and one ill-conditioned (|rr|^2 |rr^-1|^2 / 9 > 1e4), both
    bad."""
    rng = np.random.default_rng(4)
    n = 64
    rr = rng.standard_normal((n, 3, 3))
    rr = rr @ rr.transpose(0, 2, 1) + 0.1 * np.eye(3)
    rr[0] = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])
    rr[1] = np.diag([1.0, 1.0, 1e-4])
    dvw = rng.standard_normal((n, 3, 3))
    daw = rng.standard_normal((n, 3, 3))
    h = 0.1 + rng.random(n)
    sound = 0.5 + rng.random(n)
    alpha = 0.1 + 0.5 * rng.random(n)
    args = (rr, dvw, daw, h, sound, alpha)
    ja, jd = jax.jit(lambda *x: jforces._cd2010_finalize(
        _visc(jforces), *x))(*map(jnp.asarray, args))
    ta, td = tforces._cd2010_finalize(_visc(tforces),
                                      *map(torch.tensor, args))
    assert _rel(ta, ja) <= TOL and _rel(td, jd) <= TOL
    bad = tforces._cd2010_terms(_visc(tforces),
                                *map(torch.tensor, args))[2].numpy()
    assert bad[0] and bad[1] and not bad[2:].all()
    assert float(ta[0]) == 1.0 and float(ta[1]) == 1.0


def _both(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    jsim = JaxSim(jp)
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(params.copy(), device="cpu",
                              dtype=torch.float64)
    tsim.SetupSimulation()
    return jsim, tsim


def _same(jsim, tsim, where):
    errs = {f: _rel(getattr(tsim.state, f), getattr(jsim.state, f))
            for f in FIELDS}
    errs["t"] = _rel(tsim.state.t, jsim.state.t)
    bad = {k: e for k, e in errs.items() if not e <= TOL_SIM}
    assert not bad, f"{where}: {bad}"


@pytest.mark.parametrize("scheme,mirror", [("mm97", False),
                                           ("cd2010", False),
                                           ("cd2010", True)])
def test_sod_steps_match_jax(scheme, mirror):
    """alpha starts at alpha_visc_min and rises at the shock as in the
    JAX package: mm97 through the closing kick's dalpha/dt, cd2010 at
    once to the switch's target (K21's plain version)."""
    p = sod_params(128, 32, tend=0.25, mirror=mirror)
    p.set("time_dependent_avisc", scheme)
    jsim, tsim = _both(p)
    assert float(tsim.state.alpha.max()) == 0.1
    _same(jsim, tsim, "bootstrap")
    for i in range(8):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _same(jsim, tsim, f"step {i + 1}")
    assert float(tsim.state.alpha.max()) > 0.1


def _block(scheme):
    p = sphere_block_params(500, tend=1.0, self_gravity=0)
    p.set("time_dependent_avisc", scheme)
    return p


def test_block_cd2010_evolves_by_mm97_law_f13():
    """ROADMAP fault F13: the block tick advances alpha by
    _dalphadt * dt_base whatever the scheme (gandalf_tpu/sim/
    simulation.py:1168-1171), so cd2010 and mm97 block runs agree
    exactly, and the port's cd2010 run matches the JAX package's."""
    jsim, tsim = _both(_block("cd2010"))
    mm = GradhSphSimulation(_block("mm97"), device="cpu",
                            dtype=torch.float64)
    mm.SetupSimulation()
    for i in range(3):
        jsim.main_loop_step()
        tsim.main_loop_step()
        mm.main_loop_step()
        _same(jsim, tsim, f"tick {i + 1}")
    assert torch.equal(tsim.state.alpha, mm.state.alpha)
    assert float(tsim.state.alpha.max()) > 0.1
