"""Port parity: block-timestep meshless finite volume (MfvMusclSimulation
with Nlevels > 1), float64, against gandalf_tpu.

- Each function of integrate/mfv_block.py against the JAX package's on
  states and schedules made from a numpy seed (1e-14): the initial
  ladder, the predicted gravity terms, the prediction and drift, the
  Saitoh-Makino limiter, the commit with and without a cooling hook
  (the resync tick included), the per-particle gravity terms and the
  all-pairs distant signal-velocity oracle.
- The plain K12 in its block mode against fluxes_mfv_grid27 with dt_own
  and start on the small 2D box and a 3D 8^3 box, HLLC with the Gizmo
  limiter and the exact solver with tvdscalar (1e-12); the plain K32
  and K33 against vsig_near_grid27 and vsig_far_cells on the supersonic
  state of tests/test_mfv_block.py:137-160 in 1D, 2D (also on a grid of
  8 x 8 cells, where cells half a box apart tie in the periodic wrap)
  and 3D (1e-12); the plain K22 in 1D and 2D against the JAX
  _levelneib_pass (exact).
- The grid bound of the conservative limiter at or above the all-pairs
  oracle (tests/test_mfv_block.py:193-204), and RK2 with Nlevels > 1
  refused as the JAX package refuses it.

tests/test_torch_mfv_block_sim.py runs the slice through both
controllers.
- CUDA-marked tests: K12's block mode, K22 in 1-3 dims, K32 and K33
  against their plain versions on the card (skipped without one).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.integrate import block as jblock
from gandalf_tpu.integrate import mfv_block as jmb
from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import mfv as jm
from gandalf_tpu.ops import mfv_grid27 as jmg
from gandalf_tpu.ops.eos import eos_factory as jax_eos
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim import mfv_sim as jax_mfv
from gandalf_tpu.sim.ic import generate_ic as jax_generate_ic
from gandalf_tpu.sim.simulation import SimulationBase as JaxSim
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu.state import make_mfv_state as jax_mfv_state
from gandalf_tpu_torch.check import (jittered_box_ic, jittered_lattice_ic,
                                     mfv_khi_params, mfv_params,
                                     mfv_sod_params)
from gandalf_tpu_torch.convert import (grid_spec_from_jax,
                                       mfv_state_from_jax, schedule_from_jax)
from gandalf_tpu_torch.integrate import block as tblock
from gandalf_tpu_torch.integrate import mfv_block as tmb
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import mfv as tm
from gandalf_tpu_torch.ops import mfv_grid27 as tmg
from gandalf_tpu_torch.ops import sph_grid27 as tg
from gandalf_tpu_torch.ops.active_grid import dense_ids, levelneib_grid27
from gandalf_tpu_torch.ops.eos import eos_factory
from gandalf_tpu_torch.sim.simulation import SimulationBase
from gandalf_tpu_torch.state import DomainBox

torch.set_num_threads(1)

TOL_FN = 1e-14
TOL_KERNEL = 1e-12
N = 80


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, tol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    err = np.max(np.abs(got - want), initial=0.0) / max(
        np.max(np.abs(want), initial=0.0), 1e-300)
    assert err <= tol, f"{what}: {err:.3e}"


# ---------------------------------------------------------------------------
# integrate/mfv_block.py, function by function
# ---------------------------------------------------------------------------

ND = 3
JCFG = jblock.BlockConfig(nlevels=4, level_diff_max=1)
TCFG = tblock.BlockConfig(nlevels=4, level_diff_max=1)


def _states(seed=0, level_max=3, n=5):
    """A random mid-run block MFV state (JAX and port) at tick counter n
    on a ladder of depth `level_max`: each particle's nlast the start of
    its current step, levelneib at or above its level, flux
    accumulators, gravity and the step-start copies random."""
    rng = np.random.default_rng(seed)
    nvar = ND + 2
    js = jax_mfv_state(rng.random((N, ND)), rng.standard_normal((N, ND)),
                       np.full(N, 1.0 / N) * (1.0 + 0.1 * rng.random(N)),
                       0.1 + 0.05 * rng.random(N), 1.0 + rng.random(N))
    level = rng.integers(0, level_max + 1, N).astype(np.int32)
    nstep = (1 << (level_max - level)).astype(np.int32)
    m = np.full(N, 1.0 / N) * (1.0 + 0.1 * rng.random(N))
    Q0 = np.concatenate([m[:, None] * rng.standard_normal((N, ND)),
                         m[:, None], (m * (2.0 + rng.random(N)))[:, None]],
                        -1)
    fields = {
        "Qcons0": Q0, "dQ": 1e-3 * rng.standard_normal((N, nvar)),
        "dQdt": 1e-2 * rng.standard_normal((N, nvar)),
        "a": rng.standard_normal((N, ND)), "a0": rng.standard_normal((N, ND)),
        "r0": rng.random((N, ND)), "v0": rng.standard_normal((N, ND)),
        "ndens": 50.0 + 10.0 * rng.random(N), "gpot": rng.random(N),
        "rdmdt": 1e-4 * rng.standard_normal((N, ND)),
        "rdmdt0": 1e-4 * rng.standard_normal((N, ND)),
        "level": level,
        "levelneib": (level + rng.integers(0, 3, N)).astype(np.int32),
        "nlast": ((n // nstep) * nstep).astype(np.int32),
        "tlast": 0.5 * rng.random(N), "t": np.float64(0.75),
    }
    js = js.replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    return js, mfv_state_from_jax(js), nstep, rng


def _schedule(nstep, n, level_max, rng, dt_max=1.0):
    nresync = 1 << level_max
    B = jblock.BlockSchedule(
        n=jnp.asarray(n, jnp.int32),
        level_max=jnp.asarray(level_max, jnp.int32),
        nresync=jnp.asarray(nresync, jnp.int32),
        dt_base=jnp.asarray(dt_max / nresync), dt_max=jnp.asarray(dt_max),
        nstep_part=jnp.asarray(nstep),
        dt_next=jnp.asarray(dt_max / 2.0 ** rng.integers(0, level_max + 1,
                                                         len(nstep))))
    return B, schedule_from_jax(B)


def _same_sched(tb, jb, what):
    for f in jblock.BlockSchedule._fields:
        _close(getattr(tb, f), getattr(jb, f), TOL_FN, f"{what}: {f}")


def test_init_schedule_mfv_matches_jax():
    js, ts, _, rng = _states(1)
    dt_part = 1e-3 * (0.5 + rng.random(N))
    js2, jb = jmb.init_schedule_mfv(JCFG, js, jnp.asarray(dt_part))
    ts2, tb = tmb.init_schedule_mfv(TCFG, ts, torch.tensor(dt_part))
    for f in ("level", "levelneib", "nlast", "tlast", "dQ", "dQdt",
              "rdmdt", "rdmdt0"):
        _close(getattr(ts2, f), getattr(js2, f), TOL_FN, f)
    _same_sched(tb, jb, "init")
    assert len(np.unique(np.asarray(js2.level))) >= 2


def test_gravity_terms_match_jax():
    """_grav_predict (the tick's prediction) and gravity_source_terms_pp
    (the commit) with per-particle times."""
    js, ts, _, rng = _states(2)
    dt_el = 0.01 * rng.random(N)
    dt_own = 0.02 * rng.random(N)
    Q = np.asarray(js.Qcons0) + np.asarray(js.dQ)
    want = jmb._grav_predict(ND, js.Qcons0, jnp.asarray(Q), js.a0,
                             jnp.asarray(dt_el), jnp.asarray(dt_own))
    got = tmb._grav_predict(ND, ts.Qcons0, _t(Q), ts.a0, _t(dt_el),
                            _t(dt_own))
    _close(got, want, TOL_FN, "grav_predict")
    want = jmb.gravity_source_terms_pp(ND, jnp.asarray(dt_own), js.Qcons0,
                                       jnp.asarray(Q), js.a0, js.a, js.rdmdt)
    got = tmb.gravity_source_terms_pp(ND, _t(dt_own), ts.Qcons0, _t(Q),
                                      ts.a0, ts.a, ts.rdmdt)
    _close(got, want, TOL_FN, "gravity_source_terms_pp")


@pytest.mark.parametrize("n", [2, 4, 5])
def test_advance_and_limiter_match_jax(n):
    """advance_mfv (every particle predicted, the enders' committed
    exchange), then check_timesteps_mfv, which must end some steps."""
    js, ts, nstep, rng = _states(3, n=n)
    jb, tb = _schedule(nstep, n, 3, rng)
    js2, jact, jt, jQ = jmb.advance_mfv(js, jb)
    ts2, tact, tt, tQ = tmb.advance_mfv(ts, tb)
    for f in ("r", "v", "m", "u"):
        _close(getattr(ts2, f), getattr(js2, f), TOL_FN, f)
    _close(tact, jact, 0, "active")
    _close(tQ, jQ, TOL_FN, "Q")
    _close(tt, jt, TOL_FN, "t")
    ja, jn, jl, js3 = jmb.check_timesteps_mfv(JCFG, js2, jb, jact)
    ta, tn, tl, ts3 = tmb.check_timesteps_mfv(TCFG, ts2, tb, tact)
    for got, want, what in ((ta, ja, "active"), (tn, jn, "nstep"),
                            (tl, jl, "level"), (ts3.dQ, js3.dQ, "dQ")):
        _close(got, want, TOL_FN, what)
    assert int((ta & ~tact).sum()) > 0


def _cooling(Q, ndens, gpot, dt, lib):
    """A stand-in radiative term: the energy column loses 10% of Q_E dt
    ndens gpot per unit time."""
    loss = 0.1 * Q[..., -1] * dt * ndens * gpot
    if lib is jnp:
        return Q.at[..., -1].add(-loss)
    return torch.cat([Q[:, :-1], (Q[:, -1] - loss)[:, None]], -1)


@pytest.mark.parametrize("n,cooling", [(5, False), (6, True), (7, True)],
                         ids=["tick6", "tick7_cooling", "resync_cooling"])
def test_end_timestep_mfv_matches_jax(n, cooling):
    """The commit of the enders and the ladder update (tick 8 is the
    resync of a depth-3 ladder), with and without a cooling hook."""
    js, ts, nstep, rng = _states(4, n=n)
    jb, tb = _schedule(nstep, n, 3, rng)
    p = mfv_params(4, 0)
    jeos, teos = jax_eos(_jax_params(p)), eos_factory(p, "cpu",
                                                      torch.float64)
    js2, jact, jt, _ = jmb.advance_mfv(js, jb)
    ts2, tact, tt, _ = tmb.advance_mfv(ts, tb)
    dt_crit = 1e-3 * (0.5 + rng.random(N))
    jout, jb2 = jmb.end_timestep_mfv(
        JCFG, jeos, js2, jb, jact, js2.level, jb.nstep_part,
        jnp.asarray(dt_crit), jt,
        cooling_fn=(lambda *a: _cooling(*a, jnp)) if cooling else None)
    tout, tb2 = tmb.end_timestep_mfv(
        TCFG, teos, ts2, tb, tact, ts2.level, tb.nstep_part,
        torch.tensor(dt_crit), tt,
        cooling_fn=(lambda *a: _cooling(*a, torch)) if cooling else None)
    for f in ("m", "v", "u", "pressure", "sound", "Qcons0", "r0", "v0",
              "a0", "rdmdt0", "rdmdt", "dQ", "dQdt", "level", "levelneib",
              "nlast", "tlast", "t", "dt"):
        _close(getattr(tout, f), getattr(jout, f), TOL_FN, f)
    _same_sched(tb2, jb2, "end")
    assert bool(tact.any())


def test_vsig_distant_dense_matches_jax():
    """The all-pairs oracle in a periodic box, over all rows and over a
    sample of rows."""
    rng = np.random.default_rng(5)
    r, v = rng.random((N, ND)), 2.0 * rng.standard_normal((N, ND))
    h, c = 0.05 + 0.05 * rng.random(N), 0.5 + rng.random(N)
    p = mfv_params(4, 0)
    want = jmb.vsig_distant_dense(JaxBox.from_params(_jax_params(p)),
                                  *map(jnp.asarray, (r, v, h, c)),
                                  jnp.ones(N, bool))
    box = DomainBox.from_params(p)
    got = tmb.vsig_distant_dense(box, *map(torch.tensor, (r, v, h, c)),
                                 torch.ones(N, dtype=torch.bool))
    _close(got, want, TOL_FN, "vsig")
    rows = torch.tensor([3, 17, 40])
    sub = tmb.vsig_distant_dense(box, *map(torch.tensor, (r, v, h, c)),
                                 torch.ones(N, dtype=torch.bool), rows=rows)
    _close(sub, np.asarray(want)[rows.numpy()], TOL_FN, "rows")


# ---------------------------------------------------------------------------
# the plain kernels
# ---------------------------------------------------------------------------

def _after_steps(params, ic, steps):
    """A JAX global-dt MFV simulation after its bootstrap and `steps`
    steps from `ic`."""
    jsim = JaxSim.factory(_jax_params(params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mfv, "generate_ic",
                   lambda p, eos: {k: v.copy() for k, v in ic.items()})
        jsim.SetupSimulation()
    for _ in range(steps):
        jsim.main_loop_step()
    return jsim


@pytest.fixture(scope="module", params=["box2d", "box3d"])
def flux_state(request):
    """A JAX MFV state after two steps, its dense views, the port's slot
    map of its grid, and per-particle dt_own and start of a 3-level
    ladder."""
    if request.param == "box2d":
        params = mfv_khi_params(16)
        ic = jittered_lattice_ic(params)
    else:
        params = mfv_params(8, 0)
        ic = jittered_box_ic(params, 8)
    jsim = _after_steps(params, ic, 2)
    s = jsim.state
    jspec, _, fill, d, back = jsim._grid_binning(s, s.r)
    spec = grid_spec_from_jax(jspec)
    r = _t(s.r)
    rng = np.random.default_rng(6)
    level = rng.integers(0, 3, s.N)
    dt_own = float(s.dt) * 2.0 ** -level
    start = rng.random(s.N) < 0.4
    return dict(s=s, jspec=jspec, fill=fill, d=d, back=back, spec=spec,
                r=r, ids_d=dense_ids(spec, tg.bin_particles(spec, r)),
                jk=jax_kernel("m4", spec.ndim),
                tk=kernel_factory("m4", spec.ndim),
                gamma=jsim.mfv_cfg.gamma, dt_own=dt_own, start=start)


@pytest.mark.parametrize("mode", [
    dict(), dict(riemann="exact", slope_limiter="tvdscalar")],
    ids=["hllc_gizmo", "exact_tvdscalar"])
def test_block_fluxes_match_jax(flux_state, mode):
    """Plain K12 in its block mode: dQdt, rdmdt_dot and the committed dQ
    and rdmdt, each pair's half step over min(dt_own_i, dt_own_j)."""
    g, s, d = flux_state, flux_state["s"], flux_state["d"]
    cfg = dict(gamma=g["gamma"], **mode)
    dense = {"r": d(s.r), "h": d(s.h), "ndens": d(s.ndens),
             "hfactor": d(s.hfactor), "Wprim": d(s.Wprim),
             "sound": d(s.sound), "a0": d(s.a0), "B": d(s.B),
             "grad": d(s.grad), "alpha_slope": d(s.alpha_slope),
             "bad": d(s.bad_grad.astype(s.h.dtype)),
             "dt_own": d(jnp.asarray(g["dt_own"])),
             "start": d(jnp.asarray(g["start"].astype(np.float64)))}
    want = jmg.fluxes_mfv_grid27(g["jk"], jm.MfvConfig(**cfg), g["jspec"],
                                 s.dt, dense, g["fill"])
    packed = tmg.pack_flux_fields(
        *map(_t, (s.h, s.ndens, s.Wprim, s.sound, s.a0, s.B, s.grad,
                  s.alpha_slope, s.bad_grad)),
        dt_own=torch.tensor(g["dt_own"]), start=torch.tensor(g["start"]))
    got = tmg.fluxes(g["tk"], tm.MfvConfig(**cfg), g["spec"], _t(s.dt),
                     g["ids_d"], g["r"], packed, block=True)
    for f in ("dQdt", "rdmdt_dot", "dQ", "rdmdt"):
        _close(getattr(got, f), g["back"](getattr(want, f)), TOL_KERNEL, f)
    assert float(torch.abs(got.dQ).max()) > 0.0


def _supersonic(case):
    """tests/test_mfv_block.py:137-160's state on the grid of `case`: the
    configuration's IC with velocities 2 N(0, 1) and sound speeds 0.5 +
    U(0, 1) (numpy generator 7), and the JAX grid planned from the IC; on
    "khi_even" the grid is 8 x 8 cells."""
    params = {"tube": lambda: mfv_sod_params(64, 16),
              "khi": lambda: mfv_khi_params(16),
              "khi_even": lambda: mfv_khi_params(16),
              "box3d": lambda: mfv_params(8, 0)}[case]()
    jsim = JaxSim.factory(_jax_params(params))
    jsim.process_parameters()
    ic = jax_generate_ic(jsim.params, jsim.eos)
    rng = np.random.default_rng(7)
    n = len(ic["m"])
    v = 2.0 * rng.standard_normal(ic["v"].shape)
    sound = 0.5 + rng.random(n)
    jsim._plan_grid(ic["r"], ic["h"])
    if case == "khi_even":
        jsim.gridspec = dataclasses.replace(jsim.gridspec, ncells=(8, 8),
                                            k_cell=64)
    return jsim, ic, v, sound


@pytest.mark.parametrize("case", ["tube", "khi", "khi_even", "box3d"])
def test_vsig_near_and_far_match_jax(case):
    """Plain K32 and K33 against vsig_near_grid27 and vsig_far_cells, and
    the combined bound against the JAX _vsig_conservative."""
    jsim, ic, v, sound = _supersonic(case)
    jspec = jsim.gridspec
    s = jax_mfv_state(ic["r"], v, ic["m"], ic["h"], ic["u"]).replace(
        sound=jnp.asarray(sound))
    _, b, fill, d, back = jsim._grid_binning(s, s.r)
    dense = {"r": d(s.r), "v": d(s.v), "sound": d(s.sound), "h": d(s.h)}
    spec = grid_spec_from_jax(jspec)
    if case == "khi_even":
        assert spec.ncells == (8, 8) and all(spec.periodic)
    r, vv, c, h = map(_t, (s.r, s.v, s.sound, s.h))
    b = tg.bin_particles(spec, r)
    ids_d = dense_ids(spec, b)
    near = tmg.vsig_near(spec, ids_d, b.cell_of, r, vv, c, h)
    _close(near, back(jmg.vsig_near_grid27(jspec, dense, fill)), TOL_KERNEL,
           "near")
    A, Bc = tmg.vsig_far(spec, ids_d, vv, c)
    jA, jB = jmg.vsig_far_cells(jspec, dense, fill)
    _close(A, jA, TOL_KERNEL, "A")
    some = np.asarray(jB) > -1e29
    _close(Bc.numpy()[some], np.asarray(jB)[some], TOL_KERNEL, "Bc")
    assert np.array_equal(Bc.numpy() > -1e29, some)
    if case == "khi_even":
        assert some.any()
    jsim.time_step_limiter = "conservative"
    want = jsim._vsig_conservative(s)
    _close(tmg.vsig_conservative(spec, ids_d, b.cell_of, r, vv, c, h), want,
           TOL_KERNEL, "bound")


@pytest.mark.parametrize("case", ["tube", "khi"])
def test_levelneib_matches_jax_below_3d(case):
    """Plain K22 at ndim 1 and 2 against the JAX MFV controller's
    _levelneib_pass, on random levels: equal."""
    jsim, ic, _, _ = _supersonic(case)
    level = np.random.default_rng(8).integers(0, 5, len(ic["m"]))
    s = jax_mfv_state(ic["r"], ic["v"], ic["m"], ic["h"], ic["u"]).replace(
        level=jnp.asarray(level, jnp.int32))
    want = jsim._levelneib_pass(s)
    spec = grid_spec_from_jax(jsim.gridspec)
    got = levelneib_grid27(kernel_factory("m4", spec.ndim), spec, _t(s.r),
                           _t(s.h), torch.tensor(level, dtype=torch.int32),
                           torch.ones(s.N, dtype=torch.bool))
    _close(got, want, 0, "levelneib")
    assert len(np.unique(got.numpy())) >= 2


def test_conservative_bound_holds_over_the_oracle():
    """The port's grid bound (K32 and K33's plain versions) at or above
    the all-pairs oracle on tests/test_mfv_block.py:137-160's supersonic
    KHI state, and within a factor 10 at the median."""
    jsim, ic, v, sound = _supersonic("khi")
    p = mfv_khi_params(16)
    spec = grid_spec_from_jax(jsim.gridspec)
    r, vv, c, h = map(torch.tensor, (ic["r"], v, sound, ic["h"]))
    b = tg.bin_particles(spec, r)
    prod = tmg.vsig_conservative(spec, dense_ids(spec, b), b.cell_of, r, vv,
                                 c, h)
    oracle = tmb.vsig_distant_dense(DomainBox.from_params(p), r, vv, h, c,
                                    torch.ones(len(c), dtype=torch.bool))
    assert bool((prod >= oracle - 1e-10).all())
    assert float(torch.median(prod / torch.clamp_min(oracle, 1e-30))) < 10.0


def test_rk2_block_refused():
    """mfvrk with Nlevels > 1: the JAX package refuses it, so does the
    port."""
    p = mfv_params(4, 0)
    p.set("sim", "mfvrk")
    p.set("Nlevels", 3)
    with pytest.raises(NotImplementedError, match="RK2 block coupling"):
        jax_mfv.MfvRungeKuttaSimulation(_jax_params(p)).process_parameters()
    with pytest.raises(NotImplementedError, match="RK2 block coupling"):
        SimulationBase.factory(p, "cpu", torch.float64).process_parameters()


def test_block_wrappers_refuse_cpu_tensors():
    """K12's block mode, K22 in 1D, K32 and K33: CPU tensors raise and
    count no launch; K12's block mode refuses RK2."""
    from gandalf_tpu_torch import _ext

    spec = tg.Grid27Spec(ndim=1, ncells=(4,), lo=(0.0,), extents=(1.0,),
                         k_cell=4, periodic=(True,))
    kern = kernel_factory("m4", 1)
    f64 = dict(dtype=torch.float64)
    ids = torch.arange(16, dtype=torch.int32).reshape(4, 4)
    r, x = torch.rand((16, 1), **f64), torch.rand((16,), **f64)
    modes = tmg.flux_modes(tm.MfvConfig(gamma=1.4), block=True)
    packed = torch.rand((16, 17), **f64)
    lo, csize, reach = tmg.far_geometry(spec)
    before = dict(_ext.LAUNCHES)
    calls = (
        lambda: _ext.mfv_fluxes(spec, kern, modes, torch.tensor(1e-3, **f64),
                                ids, r, packed),
        lambda: _ext.levelneib(spec, kern, ids, r, x,
                               torch.zeros(16, dtype=torch.int32)),
        lambda: _ext.mfv_vsig_near(spec, ids, r, r, x, x),
        lambda: _ext.mfv_vsig_far(spec, ids, r, x, lo, csize, reach))
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="MUSCL"):
        _ext.mfv_fluxes(spec, kern, modes._replace(rk2=1),
                        torch.tensor(1e-3, **f64), ids, r, packed)
    assert _ext.LAUNCHES == before
    assert modes.block == 1 and tmg.flux_count(
        spec, tm.MfvConfig(gamma=1.4), block=True) == "mfv_fluxes_block_1d"


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tube", "khi", "box3d"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_block_kernels_on_the_card(case, dtype):
    """K12's block mode, K22, K32 and K33 against their plain versions
    after 3 ticks under the conservative limiter (check.py's
    tolerances)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gandalf_tpu_torch.check import compare_mfv_block_kernels

    if case == "tube":
        params, ic = mfv_sod_params(128, 32, Nlevels=3), None
    elif case == "khi":
        params = mfv_khi_params(32, Nlevels=3)
        ic = jittered_lattice_ic(params)
    else:
        params = mfv_params(16, 1)
        params.set("Nlevels", 3)
        ic = jittered_box_ic(params, 16)
    params.set("time_step_limiter", "conservative")
    sim = SimulationBase.factory(params, "cuda", dtype)
    sim.SetupSimulation(ic)
    for _ in range(3):
        sim.main_loop_step()
    rep = compare_mfv_block_kernels(sim)
    assert all(r["ok"] for r in rep.values()), rep
