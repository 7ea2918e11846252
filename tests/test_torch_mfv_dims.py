"""Port parity: the meshless finite-volume grid path in 1 and 2 dims and
its options, float64, against gandalf_tpu.

- The plain versions of K10, K11, K31 and K12 (gandalf_tpu_torch/ops/
  mfv_grid27.py) against density_mfv_grid27, gradients_mfv_grid27 (the
  Gizmo cell limiter and both per-neighbour sweeps) and
  fluxes_mfv_grid27 on the MFV Sod tube (1D, 128 + 32) and the small 2D
  box of tests/test_mfv_grid.py (16^2 + 16^2), at the JAX package's
  state after its bootstrap and two steps.
- Five steps through both controllers (MfvMusclSimulation,
  MfvRungeKuttaSimulation), each package generating its own IC: the
  tube with HLLC and the Gizmo limiter, under mfvrk, with the exact
  solver and tvdscalar, and with springel2009 and static particles; the
  2D box under mfvrk with springel2009, and with the exact solver and
  tvdscalar from its lattice jittered by 0.1 spacings (below); the
  Gresho vortex at 16^2 from its jittered lattice; the isothermal MFV
  sound wave (64 particles) on the grid path (neib_search kdtree: the
  port runs no all-pairs path).
- ROADMAP fault F25, shown on the JAX package: on an exact lattice a
  gradient component, or a difference to a neighbour extremum, that is
  0 by symmetry sums to 0 or to rounding noise depending on the order
  of the sums; tvdscalar's live test |dW| > 1e-300 turns that noise
  into an O(1) change of a cell alpha, and the cell limiter's ratio
  dWmax / (drmax |grad|) into a change of the noise's order over the
  gradient's.  The JAX package's own grid and all-pairs paths part by
  1e-2 within two steps on the 2D box under tvdscalar (and agree to
  1e-14 under the Gizmo limiter there), and by 3e-7 on the Gresho
  vortex.  The port sums in another order again, so those two runs are
  held to the JAX package from their jittered lattices, where no such
  term is 0 by symmetry.
- gresho_ic against the JAX generator, and convert.mfv_state_from_jax
  at ndim 1 and 2.

Tolerances: the plain kernels 1e-10 of each output's largest value,
the controllers 1e-9 (only the order of sums differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import mfv as jm
from gandalf_tpu.ops import mfv_grid27 as jmg
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim import ic as jax_ic
from gandalf_tpu.sim import mfv_sim as jax_mfv
from gandalf_tpu.sim.simulation import SimulationBase as JaxSim
from gandalf_tpu_torch.check import (MFV_EXACT_TUBE_L1, MFV_PARITY_CASES,
                                     gresho_params, jittered_lattice_ic,
                                     mfv_khi_params, mfv_parity_case,
                                     mfv_sod_params, sod_l1)
from gandalf_tpu_torch.convert import grid_spec_from_jax, mfv_state_from_jax
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import mfv as tm
from gandalf_tpu_torch.ops import mfv_grid27 as tmg
from gandalf_tpu_torch.ops import sph_grid27 as tg
from gandalf_tpu_torch.ops.active_grid import dense_ids
from gandalf_tpu_torch.sim import ic as port_ic
from gandalf_tpu_torch.sim.simulation import SimulationBase

torch.set_num_threads(1)

TOL = 1e-10
TOL_SIM = 1e-9
STEPS = 5
FIELDS = ("r", "v", "u", "rho", "h", "Wprim")


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _pair(params, ic=None):
    """Both controllers after setup, each from its own IC, or both from
    `ic` (handed to the JAX controller, which takes no IC argument, by
    replacing gandalf_tpu.sim.mfv_sim.generate_ic during its setup)."""
    jsim = JaxSim.factory(_jax_params(params))
    with pytest.MonkeyPatch.context() as mp:
        if ic is not None:
            mp.setattr(jax_mfv, "generate_ic",
                       lambda p, eos: {k: v.copy() for k, v in ic.items()})
        jsim.SetupSimulation()
    tsim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
    tsim.SetupSimulation(None if ic is None
                         else {k: v.copy() for k, v in ic.items()})
    assert type(jsim).__name__ == type(tsim).__name__
    assert jsim.use_celllist
    return jsim, tsim


def _errors(jsim, tsim):
    errs = {}
    for f in FIELDS:
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        errs[f] = np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-300)
    for f in ("t", "dt"):
        want = float(getattr(jsim.state, f))
        got = float(getattr(tsim.state, f))
        errs[f] = abs(got - want) / max(abs(want), 1e-300)
    return errs


@pytest.mark.parametrize("case", list(MFV_PARITY_CASES))
def test_five_steps_match_jax(case):
    """r, v, u, rho, h, Wprim, t and dt within 1e-9 after the bootstrap
    and each of 5 steps, with the same grid plan (check.MFV_PARITY_CASES;
    a jittered case starts both from check.jittered_lattice_ic)."""
    jsim, tsim = _pair(*mfv_parity_case(case))
    assert max(_errors(jsim, tsim).values()) <= TOL_SIM
    for i in range(STEPS):
        jsim.main_loop_step()
        tsim.main_loop_step()
        errs = _errors(jsim, tsim)
        assert max(errs.values()) <= TOL_SIM, (i + 1, errs)
        assert grid_spec_from_jax(jsim.gridspec) == tsim.gridspec
    assert tsim.Nsteps == jsim.Nsteps == STEPS
    assert torch.isfinite(tsim.state.v).all()


def _jax_paths_part(params, steps=2):
    """v's largest difference, relative to its largest value, between
    the JAX package's grid path and its all-pairs path (neib_search
    bruteforce), which sum each gradient in another order, after
    `steps` steps from the same lattice."""
    vs = []
    for neib in ("kdtree", "bruteforce"):
        p = params.copy()
        p.set("neib_search", neib)
        sim = JaxSim.factory(_jax_params(p))
        sim.SetupSimulation()
        for _ in range(steps):
            sim.main_loop_step()
        vs.append(np.asarray(sim.state.v))
    return np.abs(vs[0] - vs[1]).max() / np.abs(vs[0]).max()


@pytest.mark.parametrize("case", ["box2d_tvdscalar", "gresho_gizmo"])
def test_lattice_paths_part_in_the_jax_package(case):
    """ROADMAP fault F25 on the JAX package alone, two steps from an
    exact lattice: the 2D box with the exact solver parts by more than
    1e-3 of v's largest value under tvdscalar, and stays within 1e-12
    under the Gizmo limiter; the Gresho vortex (the Gizmo limiter) parts
    by more than 1e-8."""
    if case == "box2d_tvdscalar":
        p = mfv_khi_params(16, riemann_solver="exact",
                           slope_limiter="tvdscalar")
        assert _jax_paths_part(p) > 1e-3
        p.set("slope_limiter", "gizmo")
        assert _jax_paths_part(p) < 1e-12
    else:
        assert _jax_paths_part(gresho_params(16)) > 1e-8


@pytest.mark.parametrize("case", ["muscl", "mfvrk", "exact_tvdscalar"])
def test_sod_tube_on_the_cpu(case):
    """The MFV Sod tube at the reference's resolution (512 + 128) to t =
    0.5 through the port's plain path in float64: MUSCL with HLLC and the
    Gizmo limiter, and mfvrk, meet the reference's gate L1(vx) < 7e-3
    (tests/test_mfv.py:62, :171-185; the JAX package reads 6.7e-3); the
    exact solver with tvdscalar reads check.MFV_EXACT_TUBE_L1, to which
    chip_smoke.py holds the card."""
    over = {"muscl": {}, "mfvrk": {"sim": "mfvrk"},
            "exact_tvdscalar": {"riemann_solver": "exact",
                                "slope_limiter": "tvdscalar"}}[case]
    sim = SimulationBase.factory(mfv_sod_params(**over), "cpu",
                                 torch.float64)
    sim.Run()
    assert sim.t == pytest.approx(0.5, abs=1e-12)
    l1 = sod_l1(sim)
    if case == "exact_tvdscalar":
        assert abs(l1 - MFV_EXACT_TUBE_L1) <= 1e-9 * MFV_EXACT_TUBE_L1, l1
    else:
        assert l1 < 7e-3, l1


def test_gresho_ic_matches_jax():
    """gresho_ic bit for bit against the JAX generator."""
    p = gresho_params(16)
    want = jax_ic.gresho_ic(_jax_params(p), None)
    got = port_ic.generate_ic(p, None)
    for k in ("r", "v", "m", "h", "u"):
        assert np.array_equal(got[k], want[k]), k


@pytest.fixture(scope="module", params=["tube", "box2d"])
def grid(request):
    """A JAX MFV simulation after its bootstrap and two steps from its
    jittered lattice (the tube with tvdscalar, the 2D box with
    springel2009; on an exact lattice a gradient component that is 0 by
    symmetry is rounding noise in one order of the sums and 0 in
    another, F25, and each cell alpha follows it), its dense views and
    the port's slot map of the same grid."""
    params = (mfv_sod_params(128, 32, slope_limiter="tvdscalar")
              if request.param == "tube"
              else mfv_khi_params(16, slope_limiter="springel2009"))
    ic = jittered_lattice_ic(params)
    jsim = JaxSim.factory(_jax_params(params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mfv, "generate_ic", lambda p, eos: ic)
        jsim.SetupSimulation()
    for _ in range(2):
        jsim.main_loop_step()
    s = jsim.state
    jspec, b, fill, d, back = jsim._grid_binning(s, s.r)
    spec = grid_spec_from_jax(jspec)
    r = torch.tensor(np.asarray(s.r))
    ids_d = dense_ids(spec, tg.bin_particles(spec, r))
    nd = spec.ndim
    return dict(jsim=jsim, s=s, jspec=jspec, fill=fill, d=d, back=back,
                spec=spec, r=r, ids_d=ids_d, nd=nd,
                jk=jax_kernel("m4", nd), tk=kernel_factory("m4", nd))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if got.dtype == bool:
        assert np.array_equal(got, want)
        return
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)
    assert err <= tol, f"{err:.3e}"


def _t(x):
    return torch.tensor(np.asarray(x))


def test_density_matches_jax(grid):
    """Plain K10 and its finish in 1D and 2D: h, ndens, rho, invomega,
    zeta, hfactor and the overflow flag, from an uneven h start."""
    g, s, d = grid, grid["s"], grid["d"]
    jsim = g["jsim"]
    hmax = tg.hmax_of(g["spec"], 2.0)
    h0 = np.asarray(s.h) * (1.0 + 0.4 * np.random.default_rng(1).random(
        s.r.shape[0]))
    want = jmg.density_mfv_grid27(g["jk"], g["jspec"], jsim.h_fac,
                                  jsim.h_converge, d(s.r), d(s.m),
                                  d(jnp.asarray(h0)), g["fill"], hmax)
    sums = tmg.density_sums(g["tk"], g["spec"], jsim.h_fac, jsim.h_converge,
                            hmax, g["ids_d"], g["r"], _t(s.m), _t(h0))
    got = tmg.density_finish(jsim.h_fac, hmax, _t(s.m), *sums, ndim=g["nd"])
    for f in ("h", "ndens", "rho", "invomega", "zeta", "hfactor"):
        _close(getattr(got, f), g["back"](getattr(want, f)))
    assert bool(got.overflow) == bool(want.overflow)


def _grad_packed(s):
    return torch.cat([_t(s.h)[:, None], _t(s.ndens)[:, None], _t(s.Wprim),
                      _t(s.sound)[:, None]], -1)


@pytest.mark.parametrize("limiter", ["gizmo", "tvdscalar", "springel2009"])
def test_gradients_and_sweep_match_jax(grid, limiter):
    """Plain K11 (and for tvdscalar and springel2009 the K31 sweep from
    alpha = 1 over its gradients and extrema) in 1D and 2D: B, the
    gradients, the cell alphas, vsig_max and the bad-gradient flag."""
    g, s, d = grid, grid["s"], grid["d"]
    want = jmg.gradients_mfv_grid27(
        g["jk"], g["jspec"],
        {"r": d(s.r), "h": d(s.h), "ndens": d(s.ndens), "Wprim": d(s.Wprim),
         "sound": d(s.sound)}, g["fill"], limiter=limiter)
    got = tmg.gradients(g["tk"], g["spec"], g["ids_d"], g["r"],
                        _grad_packed(s), limiter)
    for f in ("B", "grad", "alpha_slope", "vsig_max", "bad"):
        _close(getattr(got, f), g["back"](getattr(want, f)))
    if limiter != "gizmo":
        assert float(got.alpha_slope.min()) < 1.0


@pytest.mark.parametrize("mode", [
    dict(),
    dict(riemann="exact", slope_limiter="tvdscalar", time_scheme="rk2",
         static_particles=True),
    dict(riemann="exact", slope_limiter="zeroslope", zero_mass_flux=False),
    dict(slope_limiter="null", time_scheme="rk2")],
    ids=["hllc_gizmo", "exact_tvdscalar_rk2_static", "exact_zeroslope",
         "null_rk2"])
def test_fluxes_match_jax(grid, mode):
    """Plain K12 in 1D and 2D in four modes: dQdt and rdmdt_dot from the
    state's gradients, alphas, a0 and dt."""
    g, s, d = grid, grid["s"], grid["d"]
    kw = dict(gamma=g["jsim"].mfv_cfg.gamma, **mode)
    dense = {"r": d(s.r), "h": d(s.h), "ndens": d(s.ndens),
             "hfactor": d(s.hfactor), "Wprim": d(s.Wprim),
             "sound": d(s.sound), "a0": d(s.a0), "B": d(s.B),
             "grad": d(s.grad), "alpha_slope": d(s.alpha_slope),
             "bad": d(s.bad_grad.astype(s.h.dtype))}
    want = jmg.fluxes_mfv_grid27(g["jk"], jm.MfvConfig(**kw), g["jspec"],
                                 s.dt, dense, g["fill"])
    packed = tmg.pack_flux_fields(*map(_t, (s.h, s.ndens, s.Wprim, s.sound,
                                            s.a0, s.B, s.grad,
                                            s.alpha_slope, s.bad_grad)))
    got = tmg.fluxes(g["tk"], tm.MfvConfig(**kw), g["spec"], _t(s.dt),
                     g["ids_d"], g["r"], packed)
    _close(got.dQdt, g["back"](want.dQdt))
    _close(got.rdmdt_dot, g["back"](want.rdmdt_dot))


def test_state_converts_from_jax(grid):
    """convert.mfv_state_from_jax at ndim 1 and 2: the same fields, of
    the grid's dims, bad_grad as a float flag."""
    js = grid["s"]
    st = mfv_state_from_jax(js)
    nd = grid["nd"]
    assert st.ndim == nd and st.nvar == nd + 2
    assert tuple(st.grad.shape) == (st.N, nd + 2, nd)
    for f in FIELDS + ("B", "grad", "alpha_slope", "ndens", "Qcons0"):
        assert np.array_equal(getattr(st, f).numpy(),
                              np.asarray(getattr(js, f))), f
    assert st.bad_grad.dtype == torch.float64
