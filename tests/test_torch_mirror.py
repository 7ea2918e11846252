"""Port parity: mirror and wall boundaries on the grid path against
gandalf_tpu's (float64, CPU, plain versions of K1-K3 and K19).

The layouts are those of tests/test_grid_mirror.py: walls on dim 0 on
both sides, a mirror/wall pair on dim 1 with an open/mirror pair on dim
2 (8^3 lattices), and the 1D mirror column of 64 particles, on
jittered_state's recipe (check.mirror_ic).  Each stage is compared on
the same inputs: the plan with its image-cell layers, the reflected
copies, the binning with the discard mask, the whole mirror pass, and
5 controller steps; then a run in which particles cross a wall and come
back reflected."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import forces as jforces
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.ops.eos import Adiabatic as JaxAdiabatic
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu.state import make_sph_state as jax_state
from gandalf_tpu_torch.check import (MIRROR_DIM0, MIRROR_MIXED, mirror_ic,
                                     mirror_params)
from gandalf_tpu_torch.convert import grid_spec_from_jax, state_from_numpy
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import forces as tforces
from gandalf_tpu_torch.ops import sph_grid27 as tg
from gandalf_tpu_torch.ops.eos import Adiabatic
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation
from gandalf_tpu_torch.state import DomainBox

torch.set_num_threads(1)

TOL_FIELDS = 1e-10
TOL_ACCEL = 1e-9
TOL_SIM = 1e-9
H_FAC, H_CONV = 1.2, 0.01

# (ndim, n_side, walls) of each layout
LAYOUTS = {"dim0": (3, 8, MIRROR_DIM0), "mixed": (3, 8, MIRROR_MIXED),
           "column": (1, 64, MIRROR_DIM0)}


def _layout(name):
    ndim, n_side, walls = LAYOUTS[name]
    params = mirror_params(n_side, ndim, walls)
    ic = mirror_ic(params, walls)
    box = DomainBox.from_params(params)
    args = (box.ndim, box.boxmin, box.boxmax, box.lhs, box.rhs)
    h_max = float(ic["h"].max()) * 1.3
    jspec = jg.plan_grid27(JaxBox(*args), ic["r"], h_max, 2.0)
    tspec = tg.plan_grid27(DomainBox(*args), ic["r"], h_max, 2.0)
    return params, ic, JaxBox(*args), DomainBox(*args), jspec, tspec


def _t(x):
    return torch.tensor(np.array(x))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_plan_matches_jax(name):
    """The grid anchored at each wall, one image-cell layer beyond it,
    and the occupancy counted with the images: the JAX package's spec."""
    *_, jspec, tspec = _layout(name)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert grid_spec_from_jax(jspec) == tspec
    assert tspec.mirror


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_mirror_extend_matches_jax_exactly(name, dead):
    """The plain K19 against grid_mirror_extend: the reflected copies and
    the keep mask, bit for bit, with and without dead particles."""
    _, ic, jbox, tbox, jspec, tspec = _layout(name)
    N = len(ic["m"])
    alive = np.random.default_rng(4).random(N) > (0.2 if dead else -1.0)
    want = jg.grid_mirror_extend(jbox, jspec, jnp.asarray(ic["r"]),
                                 jnp.asarray(ic["v"]), jnp.asarray(alive))
    got = tg.grid_mirror_extend(tbox, tspec, _t(ic["r"]), _t(ic["v"]),
                                _t(alive))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape[0] == N * (1 + len(tbox.mirror_walls()))
    assert bool(got[2][N:].any()) and not bool(got[2][N:].all())


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_binning_with_discard_matches_jax(name):
    """K1's plain version with the discard mask: cells exactly, slots of
    the kept exactly, overflow from the kept only."""
    _, ic, jbox, tbox, jspec, tspec = _layout(name)
    jr, _, jkeep = jg.grid_mirror_extend(
        jbox, jspec, jnp.asarray(ic["r"]), jnp.asarray(ic["v"]),
        jnp.ones(len(ic["m"]), bool))
    tr, _, tkeep = tg.grid_mirror_extend(tbox, tspec, _t(ic["r"]),
                                         _t(ic["v"]))
    keep = tkeep.numpy()
    for k_cell in (None, 2):
        js, ts = jspec, tspec
        if k_cell is not None:
            js = dataclasses.replace(jspec, k_cell=k_cell)
            ts = dataclasses.replace(tspec, k_cell=k_cell)
        jb = jg.bin_particles(js, jr, discard=~jkeep)
        tb = tg.bin_particles(ts, tr, discard=~tkeep)
        np.testing.assert_array_equal(tb.cell_of.numpy(),
                                      np.asarray(jb.cell_of))
        np.testing.assert_array_equal(tb.slot_of.numpy()[keep],
                                      np.asarray(jb.slot_of)[keep])
        assert bool(tb.overflow) == bool(jb.overflow) == (k_cell is not None)
        assert (tb.cell_of.numpy()[~keep] == ts.total_cells).all()
        if k_cell is None:
            np.testing.assert_array_equal(
                tg.dense_fill_mask(ts, tb).numpy(),
                np.asarray(jg.dense_fill_mask(js, jb)))


def _pass_both(name, hydro_forces=True):
    _, ic, jbox, tbox, jspec, tspec = _layout(name)
    nd = LAYOUTS[name][0]
    js = jax_state(ic["r"], ic["v"], ic["m"], ic["h"], ic["u"])
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js)
              if getattr(js, f.name) is not None}
    ts = state_from_numpy(fields, dtype=torch.float64)
    args = (H_FAC, H_CONV, hydro_forces)
    jout = jg.hydro_pass_grid27(jax_kernel("m4", nd),
                                jforces.ArtificialViscosity(), jbox, jspec,
                                JaxAdiabatic(gamma=1.4), *args, js)
    tout = tg.hydro_pass_grid27(kernel_factory("m4", nd),
                                tforces.ArtificialViscosity(), tbox, tspec,
                                Adiabatic(gamma=1.4), *args, ts)
    return jout, tout


FIELDS = ["h", "rho", "invomega", "hfactor", "u", "pressure", "sound",
          "dudt", "div_v"]


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_mirror_pass_matches_jax(name):
    """The whole mirror pass (K19, K1 with discard, K2 over the extended
    set with the parents iterating, the EOS on the particles, K3 with
    the images holding their parents' fields) against the JAX package's
    _hydro_pass_grid27_mirror: fields within 1e-10 (relative), a within
    1e-9 of its largest value, the same overflow flag."""
    jout, tout = _pass_both(name)
    for f in FIELDS:
        want = np.asarray(getattr(jout, f))
        got = getattr(tout, f).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL_FIELDS, atol=1e-12,
                                   err_msg=f)
    want = np.asarray(jout.a)
    err = np.max(np.abs(tout.a.numpy() - want)) / np.max(np.abs(want))
    assert err <= TOL_ACCEL
    assert bool(tout.neib_overflow) == bool(jout.neib_overflow) is False


def test_mirror_pass_without_forces_matches_jax():
    jout, tout = _pass_both("dim0", hydro_forces=False)
    np.testing.assert_allclose(tout.rho.numpy(), np.asarray(jout.rho),
                               rtol=TOL_FIELDS)
    assert not tout.a.numpy().any()


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _pair_sims(params, ic):
    jsim = JaxSim(_jax_params(params))
    jsim.restart_data = {k: v.copy() for k, v in ic.items()}
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(params.copy(), device="cpu",
                              dtype=torch.float64)
    tsim.SetupSimulation({k: v.copy() for k, v in ic.items()})
    assert jsim.use_celllist
    return jsim, tsim


def _assert_same(jsim, tsim, where):
    for f in ("r", "v", "u", "h", "rho"):
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err <= TOL_SIM, f"{where}: {f} differs by {err:.3e} of max"
    assert grid_spec_from_jax(jsim.gridspec) == tsim.gridspec, where


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_five_steps_match_jax(name):
    """5 global steps of each layout through both GradhSphSimulations
    from the same IC: positions, velocities and fields within 1e-9, the
    same grid plans."""
    params, ic, *_ = _layout(name)
    jsim, tsim = _pair_sims(params, ic)
    _assert_same(jsim, tsim, "bootstrap")
    for i in range(5):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _assert_same(jsim, tsim, f"step {i + 1}")


def test_crossing_particles_come_back_reflected():
    """Particles sent through the walls of dim 0 at speed come back
    inside the box with their normal velocity reversed (box.reflect after
    the drift), in both packages alike; none is ever beyond a wall."""
    ndim, n_side, walls = LAYOUTS["dim0"]
    params = mirror_params(n_side, ndim, walls)
    ic = mirror_ic(params, walls)
    x = ic["r"][:, 0]
    out_lo, out_hi = x < 0.03, x > 0.97
    ic["v"][out_lo, 0] = -4.0
    ic["v"][out_hi, 0] = 4.0
    jsim, tsim = _pair_sims(params, ic)
    flipped = np.zeros(len(x), bool)
    for i in range(6):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _assert_same(jsim, tsim, f"step {i + 1}")
        r = tsim.state.r.numpy()
        assert (r[:, 0] >= 0.0).all() and (r[:, 0] <= 1.0).all()
        v0 = tsim.state.v.numpy()[:, 0]
        flipped |= (out_lo & (v0 > 0.0)) | (out_hi & (v0 < 0.0))
    # the particles sent out have come back moving inwards
    assert flipped.sum() > 0.5 * (out_lo.sum() + out_hi.sum())
