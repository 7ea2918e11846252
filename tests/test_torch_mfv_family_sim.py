"""Port parity: the meshless finite-volume controllers
(MfvMusclSimulation, MfvRungeKuttaSimulation) with the quintic, gaussian
and tabulated smoothing kernels through the port's plain path on the
CPU against gandalf_tpu's, float64, from one IC.

Runs (each package from the same IC; after the bootstrap and each step
or tick the state within 1e-9 of each field's largest value, t and dt
within 1e-9, the same grid and tree plans):

- mfv_box at 8^3 (jittered) with the quintic and tree gravity, 3 steps;
- the 2D box of tests/test_mfv_grid.py at 12^2 + 12^2 (jittered) with
  the tabulated gaussian, 4 steps;
- the Sod tube (64 + 16) under mfvrk with the exact solver, with the
  gaussian and with the tabulated quintic, 5 steps;
- the 2D box at 16^2 + 16^2 (jittered) with Nlevels 3 and the tabulated
  M4, 6 ticks, levels, levelneib and nlast equal.

Also: the gaussian with self-gravity refused before setup, naming fault
F23, by every MFV controller; and every MFV controller (meshlessfv,
mfvmuscl with Nlevels 3, mfvrk) set up and stepped on the port alone
with the quintic, the gaussian and both tabulated, at ndim 1-3."""

import numpy as np
import pytest
import torch

from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim import mfv_sim as jax_mfv
from gandalf_tpu.sim.simulation import SimulationBase as JaxSim
from gandalf_tpu_torch.check import (family_params, jittered_box_ic,
                                     jittered_lattice_ic, mfv_khi_params,
                                     mfv_params, mfv_sod_params)
from gandalf_tpu_torch.convert import grid_spec_from_jax, tree_spec_from_jax
from gandalf_tpu_torch.sim.simulation import SimulationBase

torch.set_num_threads(1)

TOL_SIM = 1e-9
FIELDS = ("r", "v", "u", "m", "h", "rho", "Qcons0")
BLOCK_INTS = ("level", "levelneib", "nlast")


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _box():
    p = family_params("quintic", mfv_params(8, self_gravity=1))
    return p, jittered_box_ic(p, 8), 3


def _khi():
    p = family_params("gaussian_tab", mfv_khi_params(12))
    return p, jittered_lattice_ic(p), 4


def _tube(variant):
    p = family_params(variant, mfv_sod_params(64, 16, sim="mfvrk",
                                              riemann_solver="exact"))
    return p, None, 5


def _khi_block():
    p = family_params("m4_tab", mfv_khi_params(16, Nlevels=3))
    return p, jittered_lattice_ic(p), 6


CASES = {"box_quintic_gravity": _box, "khi_gaussian_tab": _khi,
         "tube_mfvrk_exact_gaussian": lambda: _tube("gaussian"),
         "tube_mfvrk_exact_quintic_tab": lambda: _tube("quintic_tab"),
         "khi_block_m4_tab": _khi_block}


def _errors(jsim, tsim):
    errs = {}
    fields = FIELDS + (("a", "gpot") if tsim.self_gravity else ())
    for f in fields:
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        errs[f] = np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-300)
    for f in ("t",) + (() if tsim.use_block else ("dt",)):
        want = float(getattr(jsim.state, f))
        got = float(getattr(tsim.state, f))
        errs[f] = abs(got - want) / max(abs(want), 1e-300)
    return errs


def _same_plans(jsim, tsim):
    same = grid_spec_from_jax(jsim.gridspec) == tsim.gridspec
    if tsim.self_gravity:
        same = same and tree_spec_from_jax(jsim.treespec) == tsim.treespec
    if tsim.use_block:
        same = same and all(
            np.array_equal(getattr(tsim.state, f).numpy(),
                           np.asarray(getattr(jsim.state, f)))
            for f in BLOCK_INTS)
    return same


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax(case):
    """The state within 1e-9 after the bootstrap and each step (tick),
    the plans (and with block steps the levels) equal, the port's kernel
    the configured variant."""
    params, ic, steps = CASES[case]()
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
    name, tab = params.stringparams["kernel"], params.intparams[
        "tabulated_kernel"]
    assert tsim.kern.variant == (f"{name}_tab" if tab else name)
    assert jsim.kern.name == name
    assert max(_errors(jsim, tsim).values()) <= TOL_SIM
    for i in range(steps):
        jsim.main_loop_step()
        tsim.main_loop_step()
        errs = _errors(jsim, tsim)
        assert max(errs.values()) <= TOL_SIM, (i + 1, errs)
        assert _same_plans(jsim, tsim), i + 1
    assert tsim.Nsteps == jsim.Nsteps == steps
    assert torch.isfinite(tsim.state.v).all()


@pytest.mark.parametrize("sim", ["meshlessfv", "mfvmuscl", "mfvrk"])
@pytest.mark.parametrize("tab", [0, 1])
def test_gaussian_with_self_gravity_refused_f23(sim, tab):
    """The gaussian's softened gravity is zero in the JAX package (fault
    F23): every MFV controller refuses it with self-gravity before
    setup, as the SPH controllers do."""
    p = mfv_params(6, self_gravity=1)
    p.set("sim", sim)
    p.set("kernel", "gaussian")
    p.set("tabulated_kernel", tab)
    sim_ = SimulationBase.factory(p, "cpu", torch.float64)
    with pytest.raises(NotImplementedError, match="F23"):
        sim_.process_parameters()
    assert sim_.state is None


def _small(ndim):
    """A few hundred particles at `ndim`: the Sod tube (32 + 8), the 2D
    box (8^2 + 8^2, jittered), mfv_box at 6^3 (jittered, hydro only)."""
    if ndim == 1:
        return mfv_sod_params(32, 8), None
    if ndim == 2:
        p = mfv_khi_params(8)
        return p, jittered_lattice_ic(p)
    p = mfv_params(6, self_gravity=0)
    return p, jittered_box_ic(p, 6)


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("variant", ["quintic", "gaussian", "quintic_tab",
                                     "gaussian_tab"])
@pytest.mark.parametrize("sim,nlevels", [("meshlessfv", 1),
                                         ("mfvmuscl", 3), ("mfvrk", 1)])
def test_every_controller_runs_every_kernel(sim, nlevels, variant, ndim):
    """The port alone: each MFV controller sets up and takes two steps
    (ticks) with the variant at ndim, finite, mass kept."""
    p, ic = _small(ndim)
    p.set("sim", sim)
    p.set("Nlevels", nlevels)
    family_params(variant, p)
    s = SimulationBase.factory(p, "cpu", torch.float64)
    s.SetupSimulation(ic)
    m0 = s.state.m.clone()
    for _ in range(2):
        s.main_loop_step()
    assert s.kern.variant == variant and s.ndim == ndim
    assert s.use_block == (nlevels > 1)
    assert torch.isfinite(s.state.Qcons0).all()
    assert torch.isfinite(s.state.r).all()
    assert torch.allclose(s.state.m.sum(), m0.sum(), rtol=1e-12)
