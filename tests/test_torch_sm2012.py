"""Port parity: Saitoh & Makino (2012) SPH against gandalf_tpu's (float64,
CPU, the plain versions of K25 and K26), and the refusals of the SM2012
path.

Each pass is compared on the same numpy-seeded inputs: the Sod tube in
1D (check.sod_params at 128 + 32, jittered), the small Kelvin-Helmholtz
instability in 2D (check.khi_params(1)) and a random 3D box like
tests/test_dense_kernels.py:_random_state, each with 5% dead particles
(FLAG_DEAD, zero mass).  Then the controllers: a few global steps in 1D
and 2D, a 3D box with self-gravity, a small sink case and a dense block
tick with sinks, through both SM2012SphSimulations.  Tolerance 1e-9 of
each field's largest value (both sides evaluate the same formulas over
the same candidates; only the order of the sums differs)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import active_grid as jag
from gandalf_tpu.ops import forces as jforces
from gandalf_tpu.ops import sm2012 as jsm
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu.sim.simulation import SM2012SphSimulation as JaxSM2012
from gandalf_tpu.state import DUST_TYPE, FLAG_DEAD
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu.state import make_sph_state as jax_state
from gandalf_tpu_torch.check import (dustybox_params, jittered_box_ic,
                                     khi_params, plummer_block_params,
                                     plummer_stars_params, slice_params,
                                     sod_params)
from gandalf_tpu_torch.convert import grid_spec_from_jax, state_from_numpy
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import forces as tforces
from gandalf_tpu_torch.ops import sm2012 as tsm
from gandalf_tpu_torch.params import Parameters
from gandalf_tpu_torch.sim.ic import generate_ic
from gandalf_tpu_torch.sim.simulation import (SimulationBase,
                                              SM2012SphSimulation)
from gandalf_tpu_torch.state import PERIODIC, DomainBox

torch.set_num_threads(1)

TOL = 1e-9
H_FAC, H_CONV, GAMMA = 1.2, 0.01, 1.4


def _fields(case, seed=3):
    """(numpy fields r, v, m, h, u, alpha, flags; box args; h_max of the
    plan) of a case, 5% of the particles dead with zero mass."""
    rng = np.random.default_rng(seed)
    if case == "box3d":
        n = 400
        r = rng.uniform(0, 1, (n, 3))
        f = {"r": r, "v": rng.normal(0, 0.1, (n, 3)),
             "m": np.full(n, 1.0 / n), "h": rng.uniform(0.06, 0.10, n),
             "u": rng.uniform(0.5, 1.5, n)}
        box = (3, (0.0,) * 3, (1.0,) * 3, (PERIODIC,) * 3, (PERIODIC,) * 3)
        h_plan = 0.25
    else:
        p = sod_params(128, 32) if case == "tube" else khi_params(1)
        ic = generate_ic(p, None)
        tbox = DomainBox.from_params(p)
        n, nd = ic["r"].shape
        spacing = min(tbox.size) / 32.0
        r = ic["r"] + 0.1 * spacing * rng.standard_normal((n, nd))
        lo, size = np.asarray(tbox.boxmin), np.asarray(tbox.size)
        f = {"r": lo + np.mod(r - lo, size),
             "v": ic["v"] + 0.05 * rng.standard_normal((n, nd)),
             "m": ic["m"].copy(), "h": ic["h"].copy(), "u": ic["u"].copy()}
        box = (tbox.ndim, tbox.boxmin, tbox.boxmax, tbox.lhs, tbox.rhs)
        h_plan = float(ic["h"].max()) * 2.0
    f["alpha"] = rng.uniform(0.1, 1.0, n)
    dead = rng.random(n) < 0.05
    f["m"][dead] = 0.0
    f["flags"] = np.where(dead, FLAG_DEAD, 0).astype(np.int32)
    return f, box, h_plan


def _states(case):
    """The JAX state, the port's, both grid plans and both boxes."""
    f, box, h_plan = _fields(case)
    js = jax_state(f["r"], f["v"], f["m"], f["h"], f["u"])
    js = js.replace(alpha=jnp.asarray(f["alpha"]),
                    flags=jnp.asarray(f["flags"]))
    fields = {fl.name: np.asarray(getattr(js, fl.name))
              for fl in dataclasses.fields(js)
              if getattr(js, fl.name) is not None}
    ts = state_from_numpy(fields, dtype=torch.float64)
    jbox = JaxBox(*box)
    jspec = jg.plan_grid27(jbox, f["r"], h_plan, 2.0)
    return js, ts, jspec, grid_spec_from_jax(jspec)


def _visc(mod, avisc):
    return mod.ArtificialViscosity(avisc=mod._AVISC_CODES[avisc],
                                   alpha_visc=1.0, alpha_visc_min=0.1,
                                   beta_visc=2.0)


def _scaled(got, want, rows):
    got, want = np.asarray(got)[rows], np.asarray(want)[rows]
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


@pytest.mark.parametrize("case,avisc", [("tube", "mon97"),
                                        ("tube", "none"),
                                        ("khi", "mon97"),
                                        ("khi", "mon97mm97"),
                                        ("box3d", "mon97mm97")])
def test_hydro_pass_matches_jax(case, avisc):
    """The whole pass (plain K25, then K26) against the JAX package's
    gather path: h, rho, q, hfactor, pressure, sound, a, du/dt, div v
    over the alive particles, the dead's benign values and the overflow
    flag."""
    js, ts, jspec, tspec = _states(case)
    nd = ts.ndim
    jout, jq = jsm.sm2012_hydro_pass_grid(
        jax_kernel("m4", nd), _visc(jforces, avisc), GAMMA, jspec, H_FAC,
        H_CONV, js, js.alive, True)
    tout, tq = tsm.sm2012_hydro_pass_grid(
        kernel_factory("m4", nd), _visc(tforces, avisc), GAMMA, tspec,
        H_FAC, H_CONV, ts, ts.alive, True)
    live = np.asarray(js.alive)
    assert 0 < (~live).sum() < live.size
    assert _scaled(tq.numpy(), jq, live) <= TOL
    every = np.ones_like(live)
    for f in ("h", "rho", "hfactor", "pressure", "sound", "invomega",
              "zeta", "a", "dudt", "div_v", "u"):
        want = np.asarray(getattr(jout, f))
        assert _scaled(getattr(tout, f).numpy(), want, every) <= TOL, f
    assert bool(tout.neib_overflow) == bool(jout.neib_overflow)
    assert not bool(tout.neib_overflow)


def test_all_pairs_oracles_match_jax():
    """The torch twins of the JAX package's all-pairs sm2012_density and
    sm2012_forces (oracles only) on the jittered tube, every particle's
    neighbours the whole periodic set, dead rows left out of the
    iteration (`active`)."""
    js, ts, _, _ = _states("tube")
    live = np.asarray(js.alive)
    box = (1, (-2.0,), (2.0,), (PERIODIC,), (PERIODIC,))
    jbox, tbox = JaxBox(*box), DomainBox(*box)
    m_live = jnp.where(js.alive, js.m, 0.0)
    jd = jsm.sm2012_density(jax_kernel("m4", 1), jbox, H_FAC, H_CONV, js.r,
                            js.m, js.u, js.h, js.r, m_live, js.u,
                            active=js.alive)
    tm_live = torch.where(ts.alive, ts.m, 0.0)
    td = tsm.sm2012_density_pairs(kernel_factory("m4", 1), tbox, H_FAC,
                                  H_CONV, ts.r, ts.m, ts.u, ts.h, ts.r,
                                  tm_live, ts.u, active=ts.alive)
    for f in ("h", "rho", "q", "hfactor"):
        assert _scaled(getattr(td, f).numpy(), getattr(jd, f), live) <= TOL
    # the dead take benign values, as the controllers' passes give them
    sane = {f: np.where(live, np.asarray(getattr(jd, f)), d)
            for f, d in (("h", 1.0), ("rho", 1.0), ("q", 1.0),
                         ("hfactor", 0.0))}
    sane["sound"] = np.sqrt(GAMMA * (GAMMA - 1.0) * np.asarray(js.u))
    j = {k: jnp.asarray(v) for k, v in sane.items()}
    t = {k: torch.tensor(v) for k, v in sane.items()}
    fields = ("h", "rho", "q", "hfactor", "sound")
    jf = jsm.sm2012_forces(jax_kernel("m4", 1), _visc(jforces, "mon97mm97"),
                           GAMMA, jbox, js.r, js.v, js.m, js.u,
                           *(j[k] for k in fields), js.alpha, js.r, js.v,
                           m_live, js.u, *(j[k] for k in fields), js.alpha)
    tf = tsm.sm2012_forces_pairs(
        kernel_factory("m4", 1), _visc(tforces, "mon97mm97"), GAMMA, tbox,
        ts.v, ts.u, *(t[k] for k in fields), ts.alpha, ts.r, ts.r, ts.v,
        tm_live, ts.u, *(t[k] for k in fields), ts.alpha)
    for f in ("a", "dudt", "div_v"):
        assert _scaled(getattr(tf, f).numpy(), getattr(jf, f), live) <= TOL


# ---------------------------------------------------------------------------
# The controllers
# ---------------------------------------------------------------------------

def _sm2012(params):
    p = params.copy()
    p.set("sim", "sm2012sph")
    return p


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _pair(params, ic=None):
    """Both SM2012SphSimulations after setup, from the same parameters
    (and the same staged IC where one is given)."""
    jsim = JaxSM2012(_jax_params(params))
    if ic is not None:
        # staged arrays take the generated IC's place (ImportArray's route)
        jsim.restart_data = {k: v.copy() for k, v in ic.items()}
    jsim.SetupSimulation()
    tsim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
    assert isinstance(tsim, SM2012SphSimulation)
    tsim.SetupSimulation(None if ic is None
                         else {k: v.copy() for k, v in ic.items()})
    return jsim, tsim


def _compare(jsim, tsim, where, fields=("r", "v", "u", "h", "rho")):
    """Each field within TOL of its largest value over the alive
    particles, equal alive masks, and the sinks' slots where there are
    any."""
    alive = np.asarray(jsim.state.alive)
    assert np.array_equal(tsim.state.alive.numpy(), alive), where
    errs = {f: _scaled(getattr(tsim.state, f).numpy(),
                       getattr(jsim.state, f), alive) for f in fields}
    for f in ("t", "dt"):
        want = float(getattr(jsim.state, f))
        errs[f] = (abs(float(getattr(tsim.state, f)) - want)
                   / max(abs(want), 1e-300))
    if getattr(jsim, "has_sinks", False):
        js, ts = jsim.sinks, tsim.state.sinks
        assert np.array_equal(ts.active.numpy(), np.asarray(js.active))
        for f in ("r", "v", "a", "m"):
            errs[f"sink_{f}"] = _scaled(getattr(ts, f).numpy(),
                                        getattr(js, f),
                                        np.ones(ts.N, bool))
    bad = {k: e for k, e in errs.items() if not e <= TOL}
    assert not bad, f"{where}: {bad}"


def _steps(jsim, tsim, n, fields=("r", "v", "u", "h", "rho")):
    _compare(jsim, tsim, "bootstrap", fields)
    for i in range(n):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _compare(jsim, tsim, f"step {i + 1}", fields)
    assert tsim.Nsteps == jsim.Nsteps == n


@pytest.mark.parametrize("case", ["tube", "khi"])
def test_global_steps_match_jax(case):
    """5 global steps of the jittered Sod tube and the small KHI through
    both SM2012SphSimulations, each package generating its own IC."""
    params = _sm2012(sod_params(128, 32) if case == "tube"
                     else khi_params(1))
    jsim, tsim = _pair(params)
    assert grid_spec_from_jax(jsim.gridspec) == tsim.gridspec
    assert float(tsim.state.invomega.min()) == 1.0
    _steps(jsim, tsim, 5)


def test_gravity_box_matches_jax():
    """5 steps of the self-gravitating 8^3 box (the benchmark's
    configuration, tree rebuilt every 2 steps): zeta = 0, so the tree's
    zeta correction vanishes in both packages."""
    params = _sm2012(slice_params(8, 1.0, self_gravity=1))
    params.set("ntreebuildstep", 2)
    jsim, tsim = _pair(params, jittered_box_ic(params, 8))
    assert float(torch.abs(tsim.state.zeta).max()) == 0.0
    _steps(jsim, tsim, 5, ("r", "v", "u", "h", "rho", "gpot"))
    assert tsim._n_tree_plans >= 3


def test_sinks_match_jax():
    """4 steps of the hybrid Plummer sphere (128 gas, 4 stars, accretion)
    with tree gravity, star-gas and star-star gravity, in a background
    Plummer field that the gas feels after its tree gravity and the
    stars beside their star-gas and star-star gravity
    (gandalf_tpu/sim/simulation.py:1480-1487, :1626-1632)."""
    jsim, tsim = _pair(_sm2012(plummer_stars_params(128, 4, "plummer")))
    _steps(jsim, tsim, 4, ("r", "v", "a", "u", "h", "rho", "gpot"))
    assert int((~tsim.state.alive).sum()) > 0


def test_dense_block_tick_with_sinks_matches_jax():
    """4 dense block ticks of the block-stepped hybrid Plummer sphere
    (128 gas, 16 stars, Nlevels 3, smooth accretion, mm97): the SM2012
    pass in every tick (gandalf_tpu/sim/simulation.py:1814-1853), equal
    levels each tick."""
    jsim, tsim = _pair(_sm2012(plummer_block_params(128, 16)))
    assert tsim.use_block and tsim.has_sinks
    _compare(jsim, tsim, "bootstrap")
    for i in range(4):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _compare(jsim, tsim, f"tick {i + 1}")
        assert np.array_equal(tsim.state.level.numpy(),
                              np.asarray(jsim.state.level))


# ---------------------------------------------------------------------------
# Refusals, each shown first on the JAX package
# ---------------------------------------------------------------------------

def _refused(params, match, setup=True):
    sim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
    with pytest.raises(NotImplementedError, match=match):
        sim.SetupSimulation() if setup else sim.process_parameters()


def test_walls_refused_item_8():
    """SM2012 between mirror walls: the JAX package sets
    _mirror_grid_ok = False for it (gandalf_tpu/sim/simulation.py:2290),
    so the walled run takes its all-pairs path (:1057-1064), which the
    port keeps as an oracle only; the port refuses it naming item 8."""
    params = _sm2012(sod_params(64, 16, mirror=True))
    jsim = JaxSM2012(_jax_params(params))
    jsim.process_parameters()
    assert not jsim.use_celllist
    _refused(params, "item 8", setup=False)


def test_dust_refused_f18():
    """SM2012 with dust (fault F18): the JAX override of _hydro_only_pass
    (:2299-2310) ignores has_dust, so gas and dust go through one untyped
    SM2012 pass (compare the grad-h controller's type-masked passes,
    :1490-1500): a dust particle of the 1D dusty box sums its gas
    neighbours into its density.  The port refuses it."""
    params = dustybox_params(16, 1)
    jg_sim = JaxSim(_jax_params(params))
    jg_sim.SetupSimulation()
    jsim = JaxSM2012(_jax_params(_sm2012(params)))
    jsim.SetupSimulation()
    dust = np.asarray(jsim.state.ptype) == DUST_TYPE
    rho_typed = np.asarray(jg_sim.state.rho)[dust]
    rho_untyped = np.asarray(jsim.state.rho)[dust]
    assert np.all(rho_untyped > 10.0 * rho_typed)
    _refused(_sm2012(params), "F18", setup=False)


def test_block_steps_without_sinks_refused_f17(monkeypatch):
    """SM2012 with Nlevels > 1 and no sinks or dust (fault F17): the JAX
    package's compacted tick calls the grad-h active_hydro_pass
    (gandalf_tpu/sim/simulation.py:1077-1089, :1135-1147), so every tick
    after the SM2012 bootstrap runs grad-h SPH.  Shown by recording the
    calls of that pass in one JAX tick; the port refuses the case."""
    params = _sm2012(slice_params(6))
    params.set("Nlevels", 3)
    calls = []
    orig = jag.active_hydro_pass

    def recorded(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(jag, "active_hydro_pass", recorded)
    jsim = JaxSM2012(_jax_params(params))
    jsim.SetupSimulation()
    assert jsim._step_fn is None and not calls
    jsim.main_loop_step()
    assert calls
    _refused(params, "F17")
    # with sinks the JAX package's dense tick runs the SM2012 pass: taken
    sim = SimulationBase.factory(_sm2012(plummer_block_params(64, 4)),
                                 "cpu", torch.float64)
    sim.process_parameters()
    assert sim.use_block


def test_other_eos_refused():
    """energy_eqn and isothermal only, in both packages (:2295-2297)."""
    params = _sm2012(sod_params(64, 16))
    params.set("gas_eos", "barotropic")
    with pytest.raises(ValueError, match="energy_eqn/isothermal"):
        JaxSM2012(_jax_params(params)).process_parameters()
    with pytest.raises(ValueError, match="energy_eqn/isothermal"):
        SimulationBase.factory(params, "cpu",
                               torch.float64).process_parameters()


def test_parameter_file_refused_in_both_packages(tmp_path):
    """A parameter file with sim = sm2012sph is refused by both packages'
    check_invalid_parameters; parameters built in code run."""
    path = tmp_path / "sm.dat"
    path.write_text("run_id = SM\nsim = sm2012sph\n")
    for cls in (JaxParameters, Parameters):
        with pytest.raises(ValueError, match="disabled"):
            cls().read_file(str(path))
