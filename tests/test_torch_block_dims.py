"""Port parity: block timesteps on the 1D and 2D grid path (the compacted
tick through K1, K8 and K9, and the dense dust tick) against
gandalf_tpu's GradhSphSimulation, float64 on the CPU.

- The active pass (plain K8 and K9) on the block Sod tube and the small
  KHI through both packages, for a quarter of the particles and for all
  of them, hydro forces on and off (tests/test_torch_active_grid.py's
  make_case and check_active_pass, which build the 1D and 2D states
  too): every field within 1e-10, levelneib equal.
- tests/test_block.py:158-186 through the port: the compacted pass over
  every particle equals the port's dense pass at rtol 1e-9.
- 12 ticks each of the block Sod tube (Nlevels 4), the KHI x1 (Nlevels
  3) and the 2D Sedov blast at 24^2 (Nlevels 4) through both
  controllers: equal levels, nlast and listed rows on every tick, every
  field within 1e-9 of its largest value.  The JAX package pads each
  active list to a power of two with rows that point at particle 0
  (ROADMAP fault F7); here its pads point outside the list
  (tests/test_torch_block_sim.py:repoint_pads).
- 12 dense ticks of the 1D dusty box (Nlevels 3, tests/test_dust.py:
  112-133's configuration), one compacted 1D tick with the quintic,
  and 2 ticks of the 2D KHI with cd2010, which evolves alpha by MM97's
  law under block steps in both packages (fault F13).
- Fault F28 (the port's compacted tick parting from the JAX package's
  on particle 0 of the 552-particle Spitzer sphere) is F7: with the JAX
  package's pads as it makes them only particle 0 parts; with them
  pointed outside the list every particle agrees.
- The refusals that stay below 3D: mirror walls with block steps (item
  8); the wrappers of K8 and K9 refuse CPU tensors at ndim 1 and 2.
"""

import numpy as np
import pytest
import torch

from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu_torch import _ext
from gandalf_tpu_torch.check import (block_sod_params, dustybox_block_params,
                                     family_params, khi_params,
                                     mirror_params, sedov_params,
                                     spitzer_params)
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops.active_grid import active_hydro_pass
from gandalf_tpu_torch.ops.forces import ArtificialViscosity
from gandalf_tpu_torch.ops.sph_grid27 import Grid27Spec, hydro_pass_grid27
from gandalf_tpu_torch.sim.simulation import (GradhSphSimulation,
                                              SimulationBase)
from test_torch_active_grid import check_active_pass, make_case
from test_torch_block_sim import repoint_pads

torch.set_num_threads(1)

TOL = 1e-9
FIELDS = ("r", "v", "u", "h", "rho", "a", "dudt")
TICKS = 12
CASES = {"tube": lambda: block_sod_params(4),
         "khi": lambda: khi_params(1, nlevels=3),
         "sedov": lambda: sedov_params(24, 4)}
# the Spitzer sphere of ROADMAP fault F28: 552 particles in a 2^3 grid,
# particle 0 at its edge
F28_NHYDRO = 500


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _both(params, repoint=True):
    """Both controllers after setup; the JAX one's pads pointed outside
    its active lists unless `repoint` is False."""
    jsim = JaxSim(_jax_params(params))
    if repoint:
        repoint_pads(jsim)
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(params.copy(), device="cpu",
                              dtype=torch.float64)
    tsim.SetupSimulation()
    return jsim, tsim


def _errors(jsim, tsim, fields=FIELDS):
    errs = {}
    for f in fields:
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        errs[f] = float(np.max(np.abs(got - want))
                        / max(np.max(np.abs(want)), 1e-300))
    errs["t"] = abs(float(tsim.t) - float(jsim.t)) / float(jsim.t)
    return errs


def _tick(jsim, tsim, where, fields=FIELDS):
    """One tick of each, then equal levels, nlast and (on the compacted
    tick) listed rows, and every field within TOL."""
    jsim.last_tick_rows = []
    jsim.main_loop_step()
    tsim.main_loop_step()
    for f in ("level", "nlast"):
        np.testing.assert_array_equal(getattr(tsim.state, f).numpy(),
                                      np.asarray(getattr(jsim.state, f)),
                                      err_msg=f"{where}: {f}")
    if not tsim.has_dust:
        assert tsim.last_tick_rows == jsim.last_tick_rows, where
    errs = _errors(jsim, tsim, fields)
    assert max(errs.values()) <= TOL, (where, errs)


@pytest.fixture(scope="module", params=["tube", "khi"])
def case(request):
    return make_case(request.param)


@pytest.mark.parametrize("hydro", [True, False], ids=["hydro", "no_hydro"])
@pytest.mark.parametrize("which", ["quarter", "all"])
def test_active_pass_matches_jax(case, which, hydro):
    """Plain K8 and K9 at ndim 1 and 2 against the JAX package's
    active_hydro_pass."""
    assert case["s"].ndim == {"tube": 1, "khi": 2}[case["kind"]]
    check_active_pass(case, which, hydro)


def test_full_set_matches_dense_pass():
    """tests/test_block.py:158-186 through the port: the compacted pass
    over every particle of the block Sod tube's bootstrap state equals
    the dense grid pass (K1-K3) to rtol 1e-9."""
    sim = GradhSphSimulation(block_sod_params(4), device="cpu",
                             dtype=torch.float64)
    sim.SetupSimulation()
    s0 = sim.state
    dense = hydro_pass_grid27(sim.kern, sim.visc, sim.box, sim.gridspec,
                              sim.eos, sim.h_fac, sim.h_converge, True, s0,
                              s0.alive)
    compact, ovf = active_hydro_pass(
        sim.kern, sim.visc, sim.gridspec, sim.eos, sim.h_fac,
        sim.h_converge, s0, torch.arange(s0.N, dtype=torch.int32))
    assert not bool(ovf)
    for f in ("h", "rho", "pressure", "dudt", "a", "div_v"):
        np.testing.assert_allclose(getattr(compact, f).numpy(),
                                   getattr(dense, f).numpy(), rtol=1e-9,
                                   atol=1e-11, err_msg=f)


@pytest.mark.parametrize("name", list(CASES))
def test_ticks_match_jax(name):
    """12 compacted ticks through both controllers; the ladder fills more
    than one level and some ticks list only part of the particles."""
    jsim, tsim = _both(CASES[name]())
    assert tsim.use_block and not tsim.has_dust
    rows = []
    for i in range(TICKS):
        _tick(jsim, tsim, (name, i + 1))
        rows.append(tsim.last_tick_rows[0])
    assert min(rows) < tsim.state.N
    print(f"{name}: N {tsim.state.N}, first-pass rows {rows}, levels "
          f"{np.bincount(tsim.state.level.numpy()).tolist()}")


def test_dustybox_dense_ticks_match_jax():
    """tests/test_dust.py:112-133's dusty box (1D, Nlevels 3) through the
    dense dust tick of both controllers: 12 ticks, the drag over each
    particle's own step."""
    jsim, tsim = _both(dustybox_block_params())
    assert tsim.use_block and tsim.has_dust
    for i in range(TICKS):
        _tick(jsim, tsim, ("dustybox", i + 1))
    assert tsim.active_rows == TICKS * tsim.state.N


def test_quintic_tick_1d_matches_jax():
    """One compacted tick of the block Sod tube with the quintic kernel
    (K8 and K9 take the family at every ndim)."""
    jsim, tsim = _both(family_params("quintic", block_sod_params(4)))
    assert tsim.kern.variant == "quintic" and tsim.kern.ndim == 1
    _tick(jsim, tsim, "quintic tick")


def test_cd2010_block_2d_matches_jax():
    """Two ticks of the small KHI with cd2010 and Nlevels 3: alpha
    evolves by MM97's law in both packages (fault F13) and agrees."""
    p = khi_params(1, nlevels=3)
    p.set("time_dependent_avisc", "cd2010")
    jsim, tsim = _both(p)
    for i in range(2):
        _tick(jsim, tsim, ("cd2010", i + 1), FIELDS + ("alpha",))
    assert float(tsim.state.alpha.max()) > tsim.visc.alpha_visc_min


def test_f28_is_f7():
    """ROADMAP fault F28: on the cold Spitzer sphere without a star (552
    particles, Nlevels 2) the second compacted tick lists 528 particles,
    particle 0 among them, and the JAX package pads its list to 552.
    With the pads as it makes them (pointing at particle 0, fault F7)
    only particle 0's h parts from the port's; the same tick redone from
    the same state with the pads pointed outside the list agrees on every
    field to 1e-9.  The port, which does not pad, is right."""
    params = spitzer_params(F28_NHYDRO, Nlevels=2, radiation="none")
    jsim, tsim = _both(params, repoint=False)
    assert tsim.state.N == 552
    jsim.main_loop_step()
    tsim.main_loop_step()
    assert tsim.last_tick_rows == [552]
    assert max(_errors(jsim, tsim).values()) <= TOL
    before = (jsim.state, jsim._blocksched, jsim.Nsteps)
    jsim.main_loop_step()
    tsim.main_loop_step()
    assert tsim.last_tick_rows == [528]
    dh = np.abs(tsim.state.h.numpy() - np.asarray(jsim.state.h))
    assert np.nonzero(dh > TOL * float(tsim.state.h.max()))[0].tolist() \
        == [0]
    assert dh[0] > 1e-3 * float(tsim.state.h[0])
    jsim.state, jsim._blocksched, jsim.Nsteps = before
    repoint_pads(jsim)
    jsim.main_loop_step()
    assert jsim.last_tick_rows == [528]
    errs = _errors(jsim, tsim)
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("ndim", [1, 2])
def test_mirror_walls_with_block_steps_refused(ndim):
    """Mirror walls with block timesteps stay the JAX package's all-pairs
    path (item 8) at ndim 1 and 2."""
    p = mirror_params(8, ndim)
    p.set("Nlevels", 3)
    sim = SimulationBase.factory(p, "cpu", torch.float64)
    with pytest.raises(NotImplementedError, match="item 8"):
        sim.process_parameters()


@pytest.mark.parametrize("ndim", [1, 2])
def test_active_wrappers_refuse_cpu_tensors(ndim):
    """K8 and K9 at ndim 1 and 2: CPU tensors raise and count no launch;
    a mirror plan is refused (item 8)."""
    kern = kernel_factory("m4", ndim)
    f64 = dict(dtype=torch.float64)
    cells = (4,) * ndim
    spec = Grid27Spec(ndim, cells, (0.0,) * ndim, (1.0,) * ndim, 8,
                      (True,) * ndim)
    N = 32
    idx = torch.arange(4, dtype=torch.int32)
    ids = torch.full(cells + (8,), -1, dtype=torch.int32)
    cell = torch.zeros((N,), dtype=torch.int32)
    r, m = torch.rand((N, ndim), **f64), torch.rand((N,), **f64)
    lvl = torch.zeros((N,), dtype=torch.int32)
    before = dict(_ext.LAUNCHES)
    for call in (
            lambda: _ext.active_density(spec, kern, 1.2, 0.01, 1.0, idx,
                                        cell, ids, r, m, m),
            lambda: _ext.active_forces(spec, kern, ArtificialViscosity(),
                                       idx, cell, ids, r, r,
                                       torch.rand((N, 9), **f64), lvl, lvl,
                                       True)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _ext.LAUNCHES == before
    assert _ext._grid_args(spec) == _ext._grid_args_nd(spec)
