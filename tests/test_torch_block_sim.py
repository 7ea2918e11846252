"""Port parity: hierarchical block timesteps with self-gravity (the
cold_sphere_block configuration at Nhydro = 1000, 912 particles, its tree
rebuilt every 4 ticks) through the port's controller on the CPU against
gandalf_tpu's GradhSphSimulation, float64, 12 ticks.

On every tick the active and Saitoh-Makino sets (the row counts of each
active pass), the levels and the schedule agree exactly; r, v, u, h, rho,
gpot and t within 1e-9 of each field's largest value; the tree plans
and grid replans fall on the same ticks.  Also records the JAX package's
own energy drift over the run, which chip_smoke.py's block energy gate
refers to, and its tree accuracy at the end (at 912 particles the walk
opens nearly every cell), and makes one tick overflow: it is replanned
and redone from the pre-tick state and schedule, as in the JAX
package."""

import dataclasses

import numpy as np
import pytest
import torch

from gandalf_tpu.ops.sph_gravity import direct_sph_gravity
from gandalf_tpu.ops.tree import tree_gravity_grouped
from gandalf_tpu.sim.ic import generate_ic
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu_torch.check import sphere_block_params
from gandalf_tpu_torch.convert import grid_spec_from_jax, tree_spec_from_jax
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

torch.set_num_threads(1)

TOL = 1e-9
FIELDS = ("r", "v", "u", "h", "rho", "gpot")
INTS = ("level", "nlast")
SCHED = ("n", "level_max", "nresync")
NTB = 4
TICKS = 12
N_TARGET = 1000
OVERFLOW_TICK = 5


def _params(**kw):
    return sphere_block_params(N_TARGET, tend=1.0, ntreebuildstep=NTB, **kw)


def _unlisted_pads(idx, val, ids, n_total):
    """JAX's padded index list with its pad rows pointing at a particle
    outside the list instead of particle 0 (ROADMAP fault F7: a pad row
    scatters particle 0's old values over its new ones when particle 0
    is listed).  A list of every particle has no pads."""
    spare = np.setdiff1d(np.arange(n_total), ids)
    if spare.size == 0:
        return idx
    return np.where(val, idx, spare[0]).astype(idx.dtype)


def repoint_pads(jsim):
    """Send every active pass of the JAX simulation jsim through
    _unlisted_pads, and record the listed rows of each pass in
    jsim.last_tick_rows (the port's simulations keep the same list)."""
    run = jsim._run_f_active
    jsim.last_tick_rows = []

    def repointed(s, idx, val, ids):
        jsim.last_tick_rows.append(len(ids))
        return run(s, _unlisted_pads(idx, val, ids, s.m.shape[0]), val, ids)

    jsim._run_f_active = repointed


def _pair(**kw):
    """Both simulations after setup, from one staged IC; the JAX one
    counts its tree plans and records the rows of its active passes."""
    ic = generate_ic(_params(**kw), None)
    ic = {k: ic[k] for k in ("r", "v", "m", "h", "u")}
    jsim = JaxSim(_params(**kw))
    jsim.restart_data = {k: v.copy() for k, v in ic.items()}
    plan = jsim._plan_tree_buckets
    jsim.n_plans = 0

    def counted(*args, **kwargs):
        jsim.n_plans += 1
        return plan(*args, **kwargs)

    jsim._plan_tree_buckets = counted
    repoint_pads(jsim)
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(_params(**kw), device="cpu",
                              dtype=torch.float64)
    tsim.SetupSimulation({k: v.copy() for k, v in ic.items()})
    return jsim, tsim


def _tick(sim):
    sim.last_tick_rows = []
    sim.main_loop_step()


def _compare(jsim, tsim, where):
    """Float fields' errors; integers, schedule and counts must be equal."""
    js, ts = jsim.state, tsim.state
    for f in INTS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      err_msg=f"{where}: {f}")
    jb, tb = jsim._blocksched, tsim._blocksched
    np.testing.assert_array_equal(tb.nstep_part.numpy(),
                                  np.asarray(jb.nstep_part),
                                  err_msg=f"{where}: nstep_part")
    for f in SCHED:
        assert int(getattr(tb, f)) == int(getattr(jb, f)), (where, f)
    assert tsim.last_tick_rows == jsim.last_tick_rows, where
    assert (tsim._n_tree_plans, tsim._n_grid_overflows) == \
        (jsim.n_plans, getattr(jsim, "_n_grid_overflows", 0)), where
    jtree = getattr(jsim, "treespec", None)
    assert (jtree and tree_spec_from_jax(jtree)) == tsim.treespec, where
    assert grid_spec_from_jax(jsim.gridspec) == tsim.gridspec, where
    errs = {}
    for f in FIELDS:
        want = np.asarray(getattr(js, f))
        # fields that are still zero (v at the bootstrap) compare absolutely
        errs[f] = np.max(np.abs(getattr(ts, f).numpy() - want)) \
            / (np.max(np.abs(want)) or 1.0)
    errs["t"] = abs(float(ts.t) - float(js.t)) / (float(js.t) or 1.0)
    return errs


def _energy(s, gpot):
    m = np.asarray(s.m)
    return float(np.sum(m * (0.5 * np.sum(np.asarray(s.v) ** 2, -1)
                             + np.asarray(s.u))) - 0.5 * np.sum(m * gpot))


def _full_gravity(jsim):
    """The JAX package's tree over every particle (a, gpot) and its
    rms|da|/rms|a| against the direct sum (open box)."""
    s = jsim.state
    a_t, gpot, ovf = tree_gravity_grouped(
        jsim.treespec, s.bucket_map, s.r, s.m, s.h, jsim.kern,
        zh=s.zeta * s.hfactor)
    assert not bool(ovf)
    ref = direct_sph_gravity(jsim.kern, s.r, s.m, s.h, s.zeta, s.hfactor)
    da = np.asarray(a_t) - np.asarray(ref.a)
    acc = float(np.sqrt(np.sum(da * da) / np.sum(np.asarray(ref.a) ** 2)))
    return np.asarray(gpot), acc


def _shrink_grid(jsim, tsim, k_cell):
    """Give both simulations a grid whose slot count is too small."""
    small = dataclasses.replace(jsim.gridspec, k_cell=k_cell)
    jsim.gridspec = small
    jsim._compile()
    tsim.gridspec = grid_spec_from_jax(small)


@pytest.fixture(scope="module")
def run12():
    """12 ticks through both packages, compared after each; before tick
    OVERFLOW_TICK both grids lose their slots, so that tick overflows,
    replans and is redone."""
    jsim, tsim = _pair()
    out = {"bootstrap": _compare(jsim, tsim, "bootstrap"), "ticks": [],
           "active": [], "replans": [], "e0": _energy(jsim.state, np.asarray(
               jsim.state.gpot))}
    for i in range(TICKS):
        if i + 1 == OVERFLOW_TICK:
            out["k_cell_before"] = tsim.gridspec.k_cell
            out["n_before"] = int(tsim._blocksched.n)
            _shrink_grid(jsim, tsim, 8)
        _tick(jsim)
        _tick(tsim)
        out["ticks"].append(_compare(jsim, tsim, f"tick {i + 1}"))
        out["active"].append(list(tsim.last_tick_rows))
        out["replans"].append(tsim._n_grid_overflows)
        if i + 1 == OVERFLOW_TICK:
            out["k_cell_after"] = tsim.gridspec.k_cell
            out["n_after"] = (int(tsim._blocksched.n),
                              int(jsim._blocksched.n))
    gpot, out["accuracy"] = _full_gravity(jsim)
    out["drift"] = abs(_energy(jsim.state, gpot) - out["e0"]) \
        / abs(out["e0"])
    out["levels"] = np.bincount(np.asarray(jsim.state.level)).tolist()
    out["N"] = tsim.state.N
    out["nsteps"] = (jsim.Nsteps, tsim.Nsteps)
    return out


def test_twelve_ticks_match_jax(run12):
    """Same active sets, levels, schedule, tree plans and grid replans on
    every tick (checked in the fixture), fields within 1e-9 of their
    largest values."""
    assert run12["N"] == 912
    assert max(run12["bootstrap"].values()) <= TOL, run12["bootstrap"]
    for i, errs in enumerate(run12["ticks"]):
        assert max(errs.values()) <= TOL, (i + 1, errs)
    assert run12["nsteps"] == (TICKS, TICKS)


def test_run_exercises_the_ladder(run12):
    """The run compacts (some ticks have fewer active rows than
    particles) and fills at least two levels."""
    rows = [r[0] for r in run12["active"]]
    assert min(rows) < run12["N"] and max(rows) == run12["N"]
    assert sum(1 for n in run12["levels"] if n) >= 2


def test_jax_energy_drift_and_tree_accuracy(run12):
    """The JAX package's own values on this run: the drift of
    E = sum m (v^2/2 + u) - sum m gpot / 2 over the 12 ticks, gpot from a
    full tree pass at the end, and its tree against the direct sum at
    the end (at 912 particles in 32 buckets the walk opens nearly every
    cell)."""
    print(f"gandalf_tpu cold_sphere_block N=912 float64: energy drift over "
          f"{TICKS} ticks = {run12['drift']:.3e}, rms|da|/rms|a| = "
          f"{run12['accuracy']:.3e}, levels {run12['levels']}")
    assert run12["drift"] <= 5e-3
    assert run12["accuracy"] <= 1e-6


def test_overflow_tick_replans_and_rewinds_like_jax(run12):
    """The tick with too few slots overflowed in its active pass; both
    packages replanned from the pre-tick state and redid the tick from
    the pre-tick schedule (equal fields, levels and replan counts are
    checked in the fixture): one replan, a grown grid, and the schedule
    advanced by one tick only."""
    i = OVERFLOW_TICK - 1
    assert run12["replans"][i] - run12["replans"][i - 1] == 1
    assert run12["replans"][-1] == 1
    assert run12["k_cell_after"] > 8
    n_t, n_j = run12["n_after"]
    assert n_t == n_j
    # the failed attempt's active pass is counted, then the redone ones
    assert len(run12["active"][i]) >= 2
    assert run12["active"][i][0] == run12["active"][i][1]


def test_ticks_without_gravity_match_jax():
    """The same configuration without self-gravity (the block tick's
    hydro-only branch, no tree): 6 ticks through both packages, compared
    after each as above; the ticks compact."""
    jsim, tsim = _pair(self_gravity=0)
    assert tsim.treespec is None
    rows = []
    for i in range(6):
        _tick(jsim)
        _tick(tsim)
        errs = _compare(jsim, tsim, f"tick {i + 1}")
        assert max(errs.values()) <= TOL, (i + 1, errs)
        rows.append(tsim.last_tick_rows[0])
    print(f"no gravity: active rows {rows}, levels "
          f"{np.bincount(tsim.state.level.numpy()).tolist()}")
    assert min(rows) < tsim.state.N
