"""Port parity: the M4 smoothing kernel in torch against gandalf_tpu's,
and the M4 identities (float64, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu_torch.kernels.smoothing import kernel_factory

torch.set_num_threads(1)

S = np.linspace(0.0, 2.5, 2501)
TOL = 1e-14


@pytest.mark.parametrize("fn", ["w0", "w1", "womega", "wzeta"])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_m4_matches_jax(fn, ndim):
    tk, jk = kernel_factory("m4", ndim), jax_kernel("m4", ndim)
    got = getattr(tk, fn)(torch.as_tensor(S)).numpy()
    want = np.asarray(getattr(jk, fn)(jnp.asarray(S)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (tk.kernrange, tk.kernnorm, tk.kernnormdrag) == (
        jk.kernrange, jk.kernnorm, jk.kernnormdrag)


@pytest.mark.parametrize("fn", ["wgrav", "wpot"])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_m4_gravity_kernels_match_jax(fn, ndim):
    """The softened gravity kernels on s in [0, 3], through the support's
    end, where they become 1/s^2 and 1/s."""
    s = np.linspace(0.0, 3.0, 3001)
    tk, jk = kernel_factory("m4", ndim), jax_kernel("m4", ndim)
    got = getattr(tk, fn)(torch.as_tensor(s)).numpy()
    want = np.asarray(getattr(jk, fn)(jnp.asarray(s)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    beyond = s >= 2.0
    np.testing.assert_allclose(
        got[beyond], s[beyond] ** (-2.0 if fn == "wgrav" else -1.0),
        rtol=TOL)


@pytest.mark.parametrize("fn", ["w0_s2", "womega_s2", "wzeta_s2"])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_m4_squared_argument_matches_jax(fn, ndim):
    tk, jk = kernel_factory("m4", ndim), jax_kernel("m4", ndim)
    s2 = S * S
    got = getattr(tk, fn)(torch.as_tensor(s2)).numpy()
    want = np.asarray(getattr(jk, fn)(jnp.asarray(s2)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _volume_element(ndim, s):
    return {1: 2.0 * np.ones_like(s), 2: 2.0 * np.pi * s,
            3: 4.0 * np.pi * s * s}[ndim]


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_m4_normalisation(ndim):
    kern = kernel_factory("m4", ndim)
    s = np.linspace(0.0, kern.kernrange, 50001)
    w = kern.w0(torch.as_tensor(s)).numpy()
    assert abs(np.trapezoid(w * _volume_element(ndim, s), s) - 1.0) < 1e-5


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_m4_w1_is_derivative_of_w0(ndim):
    kern = kernel_factory("m4", ndim)
    s = np.linspace(1e-3, kern.kernrange - 1e-3, 50001)
    eps = 1e-6
    dw0 = (kern.w0(torch.as_tensor(s + eps)).numpy()
           - kern.w0(torch.as_tensor(s - eps)).numpy()) / (2 * eps)
    np.testing.assert_allclose(kern.w1(torch.as_tensor(s)).numpy(), dw0,
                               atol=5e-5)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_m4_womega_identity(ndim):
    kern = kernel_factory("m4", ndim)
    s = torch.as_tensor(np.linspace(0.0, kern.kernrange - 1e-6, 50001))
    expect = -(ndim * kern.w0(s) + s * kern.w1(s))
    np.testing.assert_allclose(kern.womega(s).numpy(), expect.numpy(),
                               atol=1e-10)


def test_m4_reference_values():
    kern = kernel_factory("m4", 3)
    norm = 1.0 / np.pi
    w0 = lambda x: float(kern.w0(torch.tensor(x, dtype=torch.float64)))
    assert np.isclose(w0(0.0), norm)
    assert np.isclose(w0(1.0), 0.25 * norm)
    assert w0(2.0) == 0.0
    assert w0(2.5) == 0.0


def _softened_wrappers(inputs):
    """Each wrapper of a kernel that evaluates the softened gravity
    kernels (K14, K16, K20's sums), called with kernel `k` on `inputs`
    (None: no inputs; the gaussian's refusal comes before any is
    read)."""
    from gandalf_tpu_torch import _ext

    r, v, m, rs, ms, act, alive = (None,) * 7 if inputs is None else inputs
    dt = None if inputs is None else m[0]
    return {
        "direct_softened": lambda k: _ext.direct_softened(
            r, v, m, m, True, kern=k),
        "star_gas_forces": lambda k: _ext.star_gas_forces(
            r, m, m, rs, ms, ms, act, kern=k),
        "smooth_accretion_sums": lambda k: _ext.smooth_accretion_sums(
            r, v, m, m, m, alive, rs, rs, ms, ms, act, 2.0, dt, 1.0, 0.01,
            0.01, 0.01, kern=k),
    }


def _mfv_plain_outputs(name, tab):
    """The plain K10, K11, K12 (and, but with the gaussian, K7's MFV
    mode) with the kernel (name, tab) on the 6^3 MFV box's state after
    setup (check.mfv_params, jittered): every output tensor."""
    from gandalf_tpu_torch.check import jittered_box_ic, mfv_params
    from gandalf_tpu_torch.ops import mfv_grid27 as mg
    from gandalf_tpu_torch.ops import sph_grid27 as g27
    from gandalf_tpu_torch.ops import tree as tt
    from gandalf_tpu_torch.ops.active_grid import dense_ids
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    grav = int(name != "gaussian")
    p = mfv_params(6, self_gravity=grav)
    p.set("kernel", name)
    p.set("tabulated_kernel", tab)
    sim = SimulationBase.factory(p, "cpu", torch.float64)
    sim.SetupSimulation(jittered_box_ic(p, 6))
    s, spec, kern = sim.state, sim.gridspec, sim.kern
    ids_d = dense_ids(spec, g27.bin_particles(spec, s.r))
    hmax = g27.hmax_of(spec, kern.kernrange)
    out = list(mg.density_sums(kern, spec, sim.h_fac, sim.h_converge, hmax,
                               ids_d, s.r, s.m, s.h))
    gpk = torch.cat([s.h[:, None], s.ndens[:, None], s.Wprim,
                     s.sound[:, None]], -1)
    g = mg.gradients(kern, spec, ids_d, s.r, gpk)
    out += list(g)
    fpk = mg.pack_flux_fields(s.h, s.ndens, s.Wprim, s.sound, s.a0, g.B,
                              g.grad, g.alpha_slope, g.bad)
    out += list(mg.fluxes(kern, sim.mfv_cfg, spec, s.dt, ids_d, s.r, fpk))
    if grav:
        out += list(tt.tree_gravity_grouped(
            sim.treespec, s.bucket_map, s.r, s.m, s.h, kern,
            s.zeta * s.hfactor, sim._periodic_extent(), zeta_scaling="mfv"))
    return [x for x in out if x is not None]


@pytest.mark.parametrize("name,tab", [("quintic", 0), ("gaussian", 0),
                                      ("m4", 1)])
def test_unported_kernels_raise(name, tab):
    """The kernel factory builds the quintic, the gaussian and the
    tabulated M4, which the grad-h grid and tree kernels, the meshless
    finite-volume kernels (K10-K12, K7's MFV mode), cd2010 (K21), the
    drag (K23, K24), SM2012 (K25, K26), N-body softening and the sink
    kernels run: the MFV plain versions return finite results.  The
    wrappers of the softened gravity (K7, K14, K16, K20's sums) refuse
    the gaussian before reading any input (its wgrav and wpot are zero,
    fault F23) and take the quintic and the tables to their input checks
    (CPU tensors raise there); K18 and K20's update take no kernel."""
    import inspect

    from gandalf_tpu_torch import _ext

    kern = kernel_factory(name, 3, tab)
    assert kern.variant == (f"{name}_tab" if tab else name)
    for x in _mfv_plain_outputs(name, tab):
        assert bool(torch.isfinite(x.double()).all())
    f64 = dict(dtype=torch.float64)
    cpu = (torch.rand((16, 3), **f64), torch.rand((16, 3), **f64),
           torch.rand((16,), **f64), torch.rand((4, 3), **f64),
           torch.rand((4,), **f64), torch.ones((4,), dtype=torch.bool),
           torch.ones((16,), dtype=torch.bool))
    before = dict(_ext.LAUNCHES)
    softened = _softened_wrappers(None)
    on_cpu = _softened_wrappers(cpu)
    for wrapper, call in softened.items():
        if name == "gaussian":
            with pytest.raises(NotImplementedError, match="F23"):
                call(kern)
        else:
            with pytest.raises(ValueError, match="CUDA"):
                on_cpu[wrapper](kern)
    assert _ext.LAUNCHES == before
    # K18 and K20's sink update read no kernel
    for fn in (_ext.accretion_sums, _ext.smooth_accretion_apply):
        assert "kern" not in inspect.signature(fn).parameters
    if name == "gaussian":
        with pytest.raises(NotImplementedError, match="F23"):
            _ext.tree_near(None, kern, None, None, None, None, None, None,
                           None, 0)
