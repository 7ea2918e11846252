"""Port parity: the controllers whose grid kernels K21 and K23-K26 now take
the quintic, gaussian and tabulated smoothing kernels, float64 on the CPU
(the plain versions) against gandalf_tpu, with equal grid plans.

- cd2010: 6 steps of the Sod tube (check.sod_params at 128 + 32) with
  time_dependent_avisc = cd2010 and the quintic: alpha, r, v, u, h and
  rho within 1e-9 of each field's largest value;
- the dusty box (check.dustybox_params(32, 1)): 8 global steps two-fluid
  with the fixed law and the gaussian, 8 steps test-particle with the
  Epstein law and the tabulated quintic, and 8 dense block ticks
  (Nlevels 3, the dense dust tick) with the tabulated quintic, with
  equal levels (the JAX package's pads pointed outside its lists, F7);
- SM2012: 5 steps of the Sod tube with the tabulated M4 and of the small
  KHI (check.khi_params(1), the 2D box) with the quintic.

Then every variant (quintic, gaussian, m4_tab, quintic_tab,
gaussian_tab) of every one of the three controllers at ndim 1, 2 and 3
on the port alone: it sets up, steps twice and stays finite, launching
(on the CPU: running) its kernels under the variant.  The refusals that
stay are in tests/test_torch_kernel_family.py (sinks and stars, F23) and
tests/test_torch_sm2012.py (F17, F18).
"""

import numpy as np
import pytest
import torch

from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu.sim.simulation import SM2012SphSimulation as JaxSM2012
from gandalf_tpu_torch.check import (dustybox_params, family_params,
                                     jittered_box_ic, khi_params,
                                     slice_params, sm2012_params,
                                     sod_params)
from gandalf_tpu_torch.convert import grid_spec_from_jax
from gandalf_tpu_torch.kernels.smoothing import VARIANTS
from gandalf_tpu_torch.sim.simulation import SimulationBase
from gandalf_tpu_torch.state import DUST_TYPE
from test_torch_block_dims import _both as _block_both
from test_torch_block_dims import _tick

torch.set_num_threads(1)

TOL = 1e-9


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _both(params, jax_cls=JaxSim):
    """Both controllers after setup from the same parameters, with equal
    grid plans."""
    jsim = jax_cls(_jax_params(params))
    jsim.SetupSimulation()
    tsim = SimulationBase.factory(params.copy(), "cpu", torch.float64)
    tsim.SetupSimulation()
    assert tsim.gridspec == grid_spec_from_jax(jsim.gridspec)
    return jsim, tsim


def _steps(jsim, tsim, n, fields):
    """n steps of each, every field within TOL after each."""
    for i in range(n + 1):
        if i:
            jsim.main_loop_step()
            tsim.main_loop_step()
        errs = {f: _rel(getattr(tsim.state, f), getattr(jsim.state, f))
                for f in fields}
        errs["t"] = _rel(tsim.state.t, jsim.state.t)
        bad = {k: e for k, e in errs.items() if not e <= TOL}
        assert not bad, f"step {i}: {bad}"
    assert tsim.Nsteps == jsim.Nsteps == n


def test_cd2010_sod_quintic_matches_jax():
    p = family_params("quintic", sod_params(128, 32, tend=0.25))
    p.set("time_dependent_avisc", "cd2010")
    jsim, tsim = _both(p)
    assert tsim.kern.variant == "quintic"
    _steps(jsim, tsim, 6, ("alpha", "r", "v", "u", "h", "rho"))
    assert float(tsim.state.alpha.max()) > tsim.visc.alpha_visc_min


@pytest.mark.parametrize("variant,mode,law", [
    ("gaussian", "full_twofluid", "fixed"),
    ("quintic_tab", "test_particle", "epstein")])
def test_dustybox_matches_jax(variant, mode, law):
    p = family_params(variant, dustybox_params(32, 1, dust_forces=mode,
                                               drag_law=law))
    jsim, tsim = _both(p)
    assert tsim.has_dust and tsim.kern.variant == variant
    _steps(jsim, tsim, 8, ("v", "rho", "u", "h"))
    dust = tsim.state.ptype == DUST_TYPE
    # the drag slowed the dust
    assert float(tsim.state.v[dust, 0].mean()) < 0.995


def test_dustybox_block_ticks_match_jax():
    """8 dense block ticks of the dusty box (Nlevels 3) with the tabulated
    quintic: equal levels and nlast each tick."""
    p = family_params("quintic_tab",
                      dustybox_params(32, 1, Nlevels=3, level_diff_max=1))
    jsim, tsim = _block_both(p)
    assert tsim.use_block and tsim.has_dust
    for i in range(8):
        _tick(jsim, tsim, ("dustybox quintic_tab", i + 1))


@pytest.mark.parametrize("case,variant", [("tube", "m4_tab"),
                                          ("khi", "quintic")])
def test_sm2012_matches_jax(case, variant):
    p = sm2012_params(sod_params(128, 32) if case == "tube"
                      else khi_params(1))
    jsim, tsim = _both(family_params(variant, p), JaxSM2012)
    assert tsim.kern.variant == variant
    assert float(tsim.state.invomega.min()) == 1.0
    _steps(jsim, tsim, 5, ("r", "v", "u", "h", "rho"))


# ---------------------------------------------------------------------------
# Every variant on the port alone
# ---------------------------------------------------------------------------

def _small(controller, ndim):
    """A small configuration of `controller` at `ndim` and its IC (None:
    the configuration's own)."""
    if controller == "dust":
        return dustybox_params({1: 16, 2: 6, 3: 4}[ndim], ndim), None
    n = {1: 32, 2: 8, 3: 5}[ndim]
    if ndim == 1:
        p = sod_params(n, n // 4)
    else:
        p = slice_params(n, ndim=ndim)
    if controller == "cd2010":
        p.set("time_dependent_avisc", "cd2010")
    else:
        p = sm2012_params(p)
    return p, None if ndim == 1 else jittered_box_ic(p, n)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("controller", ["cd2010", "dust", "sm2012"])
def test_every_variant_sets_up_and_steps(controller, variant):
    for ndim in (1, 2, 3):
        p, ic = _small(controller, ndim)
        sim = SimulationBase.factory(family_params(variant, p), "cpu",
                                     torch.float64)
        sim.SetupSimulation(ic)
        sim.main_loop_steps(2)
        s = sim.state
        assert sim.kern.variant == variant and sim.ndim == ndim
        assert sim.Nsteps == 2
        for f in ("r", "v", "u", "h", "rho", "alpha"):
            assert bool(torch.isfinite(getattr(s, f)).all()), (ndim, f)
        assert bool((s.rho > 0).all()) and not bool(s.neib_overflow)
