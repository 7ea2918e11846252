"""Port parity of periodic self-gravity with the Ewald sum through both
controllers, on the CPU against the JAX package, float64, 5 steps each
(the tree replanned every 2 steps):

- GANDALF's Jeans test (``check.jeans_params``, ``ewald_jeans_box`` cut
  to 8^3) through GradhSphSimulation;
- the self-gravitating slab (``ic = ewaldslab``, open along z) and
  cylinder (``ic = ewaldcylinder``, periodic along z only) tests, whose
  tables switch to the sheet and line far fields;
- the MFV box (``check.mfv_params``) with ewald = 1 through
  MfvMusclSimulation;
- a block-timestep run of the self-gravitating box with ewald = 1: the
  bootstrap's walk takes the Ewald sum, the ticks' active-group walks do
  not, in both packages (ROADMAP fault F11, kept for parity).

r, v, u, h, rho, gpot (and for MFV m and the conserved variables), t and
dt agree within 1e-9 of each field's largest value after every step,
with the tree plans and grid replans on the same steps.  Two
slow-marked tests record the periodic tree's accuracy on ewald_jeans_box
(the JAX package's at 32^3, the reference of chip_smoke.py's gate, and
the port's plain path's at 16^3)."""

import numpy as np
import pytest
import torch

from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim import mfv_sim as jax_mfv
from gandalf_tpu.sim.simulation import SimulationBase as JaxBase
from gandalf_tpu_torch.check import (jeans_params, jittered_box_ic,
                                     mfv_params, slice_params)
from gandalf_tpu_torch.convert import ewald_table_from_jax, tree_spec_from_jax
from gandalf_tpu_torch.sim.simulation import SimulationBase

from test_torch_block_sim import _unlisted_pads

torch.set_num_threads(1)

TOL = 1e-9
STEPS = 5
NTB = 2
SPH_FIELDS = ("r", "v", "u", "h", "rho", "gpot")
MFV_FIELDS = ("r", "v", "u", "m", "h", "rho", "Qcons0", "gpot")


def _jax_params(p):
    q = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(q, table).update(getattr(p, table))
    return q


def _mixed(ic, periodic):
    """The slab or cylinder test: a unit box centred on the origin, open
    along the axes not in `periodic`, a 16-node table."""
    p = jeans_params(8, ntreebuildstep=NTB)
    p.set("ic", ic)
    p.set("nEwaldGrid", 9)
    for k in range(3):
        p.set(f"boxmin[{k}]", -0.5)
        p.set(f"boxmax[{k}]", 0.5)
        side = "periodic" if periodic[k] else "open"
        p.set(f"boundary_lhs[{k}]", side)
        p.set(f"boundary_rhs[{k}]", side)
    return p


def _pair(p, ic=None):
    """Both controllers set up from one IC (generated, or `ic` for the
    MFV controller), the JAX one counting its tree plans."""
    jsim = JaxBase.factory(_jax_params(p))
    plan = jsim._plan_tree_buckets
    jsim.n_plans = 0

    def counted(*args, **kw):
        jsim.n_plans += 1
        return plan(*args, **kw)

    jsim._plan_tree_buckets = counted
    with pytest.MonkeyPatch.context() as mp:
        if ic is not None:
            # the staged IC takes the generated one's place
            mp.setattr(jax_mfv, "generate_ic",
                       lambda p, eos: {k: v.copy() for k, v in ic.items()})
        jsim.SetupSimulation()
    tsim = SimulationBase.factory(p, "cpu", torch.float64)
    tsim.SetupSimulation(None if ic is None
                         else {k: v.copy() for k, v in ic.items()})
    return jsim, tsim


def _errors(jsim, tsim, fields):
    errs = {}
    for f in fields:
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        errs[f] = np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0)
    for f in ("t", "dt"):
        want = float(getattr(jsim.state, f))
        errs[f] = abs(float(getattr(tsim.state, f)) - want) \
            / (abs(want) or 1.0)
    return errs


def _counts(jsim, tsim):
    return ((jsim.n_plans, getattr(jsim, "_n_grid_overflows", 0)),
            (tsim._n_tree_plans, tsim._n_grid_overflows))


def _run(p, fields, ic=None, steps=STEPS):
    jsim, tsim = _pair(p, ic)
    assert tsim.use_ewald and jsim.use_ewald
    # the same table on both sides
    mine, theirs = tsim.ewald_table, ewald_table_from_jax(jsim.ewald_table)
    assert np.array_equal(mine.acc, theirs.acc)
    assert mine.far_kind == theirs.far_kind
    for i in range(steps + 1):
        if i:
            jsim.main_loop_step()
            tsim.main_loop_step()
        errs = _errors(jsim, tsim, fields)
        assert max(errs.values()) <= TOL, (i, errs)
        jc, tc = _counts(jsim, tsim)
        assert jc == tc, (i, jc, tc)
        assert tree_spec_from_jax(jsim.treespec) == tsim.treespec, i
    return jsim, tsim


def test_jeans_five_steps_match_jax():
    _, tsim = _run(jeans_params(8, ntreebuildstep=NTB), SPH_FIELDS)
    assert tsim.ewald_table.far_kind == 7
    assert tsim.Nsteps == STEPS


@pytest.mark.parametrize("ic,periodic,kind", [
    ("ewaldslab", (True, True, False), 2),
    ("ewaldcylinder", (False, False, True), 1)])
def test_slab_and_cylinder_match_jax(ic, periodic, kind):
    _, tsim = _run(_mixed(ic, periodic), SPH_FIELDS)
    assert tsim.ewald_table.far_kind == kind
    # momentum is conserved by the mixed-periodic corrections too
    s = tsim.state
    mom = (s.m[:, None] * s.v).sum(0).numpy()
    assert np.abs(mom).max() < 1e-8


def test_mfv_box_with_ewald_matches_jax():
    """mfv_box cut to 8^3 with ewald = 1: the MFV zeta mode's near field
    with the min-imaged pairs and their corrections."""
    p = mfv_params(8, self_gravity=1, tend=1.0)
    p.set("ewald", 1)
    p.set("ntreebuildstep", NTB)
    _run(p, MFV_FIELDS, ic=jittered_box_ic(p, 8))


def test_block_run_keeps_f11():
    """Block timesteps (Nlevels = 3) in the self-gravitating periodic box
    with ewald = 1: the bootstrap's gravity pass takes the Ewald sum, and
    each tick's active-group walk takes none, in both packages (ROADMAP
    fault F11).  8 ticks, the active sets (row counts) equal on each."""
    p = slice_params(8, 1.0, self_gravity=1)
    for k, v in {"ewald": 1, "Nlevels": 3, "ntreebuildstep": 4}.items():
        p.set(k, v)
    ic = jittered_box_ic(p, 8)
    jsim = JaxBase.factory(_jax_params(p))
    jsim.restart_data = {k: v.copy() for k, v in ic.items()}
    run = jsim._run_f_active
    rows = []

    def recorded(s, idx, val, ids):
        rows.append(len(ids))
        return run(s, _unlisted_pads(idx, val, ids, len(ic["m"])), val, ids)

    jsim._run_f_active = recorded
    jsim.SetupSimulation()
    tsim = SimulationBase.factory(p, "cpu", torch.float64)
    tsim.SetupSimulation({k: v.copy() for k, v in ic.items()})
    assert tsim.use_block and tsim.use_ewald
    assert max(_errors(jsim, tsim, SPH_FIELDS).values()) <= TOL
    for i in range(8):
        rows.clear()
        jsim.main_loop_step()
        tsim.main_loop_step()
        assert tsim.last_tick_rows == rows, i
        errs = _errors(jsim, tsim, ("r", "v", "u", "h", "rho", "gpot"))
        assert max(errs.values()) <= TOL, (i, errs)
    np.testing.assert_array_equal(tsim.state.level.numpy(),
                                  np.asarray(jsim.state.level))


@pytest.mark.slow
def test_jax_ewald_accuracy_at_32():
    """The JAX package's periodic tree on ewald_jeans_box at 32^3 (its
    bootstrap state) against the float64 min-imaged direct sum plus each
    pair's correction (check.periodic_gravity_accuracy's oracle), with
    the same table: the reference reading of chip_smoke.py's
    ewald_jeans_box gate (0.5, about twice the larger of this reading,
    0.194, and the card's at 64^3).  The accepted cells take the
    correction at their centre of mass only, and the sine mode's net
    force is a residual of far larger terms.  Slow (two minutes on the
    CPU): run it with -m slow."""
    from gandalf_tpu.ops.tree import tree_gravity_grouped
    from gandalf_tpu_torch.ops.sph_gravity import direct_sph_gravity

    p = jeans_params(32)
    jsim = JaxBase.factory(_jax_params(p))
    jsim.SetupSimulation()
    tsim = SimulationBase.factory(p, "cpu", torch.float64)
    tsim.process_parameters()
    s = jsim.state
    a_tree, _, ovf = tree_gravity_grouped(
        jsim.treespec, s.bucket_map, s.r, jsim._gravity_mass(s), s.h,
        jsim.kern, alive=s.alive, zh=s.zeta * s.hfactor,
        periodic_extent=[1.0, 1.0, 1.0], ewald_table=jsim.ewald_table)
    assert not bool(ovf)
    t = torch.as_tensor(np.sort(np.random.default_rng(0).choice(
        s.r.shape[0], 2048, replace=False)))
    host = {f: torch.tensor(np.asarray(getattr(s, f)))
            for f in ("r", "m", "h", "zeta", "hfactor")}
    a_ref, _ = direct_sph_gravity(
        tsim.kern, host["r"], host["m"], host["h"], host["zeta"],
        host["hfactor"], targets=t, box=tsim.box,
        ewald_table=ewald_table_from_jax(jsim.ewald_table))
    da = np.asarray(a_tree)[t.numpy()] - a_ref.numpy()
    err = float(np.sqrt(np.sum(da * da) / np.sum(a_ref.numpy() ** 2)))
    print(f"gandalf_tpu ewald_jeans_box at 32^3, float64: rms|da|/rms|a| "
          f"= {err:.4e} (rms|a| = "
          f"{float(np.sqrt(np.mean(np.sum(a_ref.numpy() ** 2, -1)))):.4e})")
    assert err < 0.25


@pytest.mark.slow
def test_port_ewald_accuracy_at_16():
    """The port's plain walk on ewald_jeans_box at 16^3 (its bootstrap
    state, float64, 512 sampled particles) against the same periodic
    oracle: about a tenth, for the same reason as the JAX package's
    reading above.  Slow (forty seconds on one CPU core)."""
    from gandalf_tpu_torch.check import periodic_gravity_accuracy

    sim = SimulationBase.factory(jeans_params(16), "cpu", torch.float64)
    sim.SetupSimulation()
    walk = periodic_gravity_accuracy(sim, 512)
    print(f"gandalf_tpu_torch ewald_jeans_box at 16^3, float64: "
          f"rms|da|/rms|a| = {walk['rms_rel_err']:.4e} (rms|a| = "
          f"{walk['rms_a']:.4e})")
    assert not walk["overflow"] and walk["rms_rel_err"] < 0.25
