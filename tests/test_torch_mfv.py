"""Port parity: each plain function of gandalf_tpu_torch/ops/mfv.py
against its gandalf_tpu/ops/mfv.py counterpart, float64, on inputs made
with numpy from a seed.  Tolerance 1e-12 of the largest value of each
output: both sides evaluate the same formulas on the same inputs; only
the order of a few sums differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import mfv as jm
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import mfv as tm
from gandalf_tpu_torch.state import DomainBox

torch.set_num_threads(1)

TOL = 1e-12
GAMMA = 1.4
N, K = 48, 16


def _t(x):
    return torch.tensor(np.array(x))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if got.dtype == bool:
        assert np.array_equal(got, want)
        return
    scale = max(np.max(np.abs(want)), 1e-300)
    err = np.max(np.abs(got - want)) / scale
    assert err <= tol, f"{err:.3e} of max |want| {scale:.3e}"


def _states(rng, shape):
    """Primitive vectors W = (v, rho, p) with rho, p positive."""
    v = 0.3 * rng.standard_normal(shape + (3,))
    rho = 0.5 + rng.random(shape)
    p = 0.4 + rng.random(shape)
    return np.concatenate([v, rho[..., None], p[..., None]], -1)


def _views(seed=0):
    """A particle block and a (N, K) neighbour view of it: separations
    within the M4 support of h ~ 0.15, some beyond it, one coincident
    partner; gradients, B matrices, alphas and flags per particle."""
    rng = np.random.default_rng(seed)
    h = 0.12 + 0.06 * rng.random(N)
    nbr = rng.integers(0, N, size=(N, K))
    dr = 0.35 * (rng.random((N, K, 3)) - 0.5)
    dr[0, 0] = 0.0
    W = _states(rng, (N,))
    return {
        "h": h, "nbr": nbr, "dr": dr, "W": W,
        "ndens": 200.0 + 50.0 * rng.random(N),
        "sound": np.sqrt(GAMMA * W[:, 4] / W[:, 3]),
        "a0": 0.1 * rng.standard_normal((N, 3)),
        "B": 50.0 * (np.eye(3) + 0.1 * rng.standard_normal((N, 3, 3))),
        "grad": rng.standard_normal((N, 5, 3)),
        "alpha": rng.random((N, 5)),
        "bad": rng.random(N) < 0.3,
        "mask": rng.random((N, K)) < 0.9,
    }


@pytest.fixture(scope="module")
def kerns():
    return jax_kernel("m4", 3), kernel_factory("m4", 3)


def test_conserved_primitive_round_trip():
    rng = np.random.default_rng(1)
    m = 0.5 + rng.random(N)
    v = rng.standard_normal((N, 3))
    u = 0.1 + rng.random(N)
    ndens = 100.0 + rng.random(N)
    Q = jm.qcons_from_state(3, jnp.asarray(m), jnp.asarray(v), jnp.asarray(u))
    _close(tm.qcons_from_state(3, _t(m), _t(v), _t(u)), Q)
    # a negative internal energy hits the 1e-15 floor on both sides
    Q = np.array(Q)
    Q[3, 4] = -1.0
    want = jm.state_from_qcons(3, jnp.asarray(Q), jnp.asarray(ndens))
    got = tm.state_from_qcons(3, _t(Q), _t(ndens))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_invert_small(ndim):
    rng = np.random.default_rng(ndim)
    E = rng.standard_normal((N, ndim, ndim)) + 3.0 * np.eye(ndim)
    E[0] = 0.0          # a singular matrix takes the 1e-300 floor
    if ndim == 1:
        E = E[..., 0, 0]
    with np.errstate(over="ignore"):
        want = np.asarray(jm._invert_small(jnp.asarray(E), ndim))
    got = tm._invert_small(_t(E), ndim).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    _close(got[1:], want[1:])


def _grad_inputs(v):
    nbr = v["nbr"]
    return (v["h"], v["ndens"], v["W"], v["sound"], v["dr"], v["W"][nbr],
            v["sound"][nbr], v["W"][nbr][..., :3], v["mask"])


def test_gradient_accumulate_and_finalize(kerns):
    """Two blocks of neighbours accumulated in turn, then the finish."""
    jk, tk = kerns
    v = _views(2)
    ins = _grad_inputs(v)
    half = K // 2
    parts = [tuple(x[:, :half] if i >= 4 else x for i, x in enumerate(ins)),
             tuple(x[:, half:] if i >= 4 else x for i, x in enumerate(ins))]
    ja = jm.gradient_init(N, 3, jnp.float64)
    ta = tm.gradient_init(N, 3, torch.float64)
    for part in parts:
        ja = jm.gradient_accumulate(jk, 3, ja, *map(jnp.asarray, part))
        ta = tm.gradient_accumulate(tk, 3, ta, *map(_t, part))
        for g, w in zip(ta, ja):
            _close(g, w)
    jr = jm.gradient_finalize(3, ja, jnp.asarray(v["h"]), jnp.asarray(v["W"]),
                              jnp.asarray(v["sound"]))
    tr_ = tm.gradient_finalize(3, ta, _t(v["h"]), _t(v["W"]), _t(v["sound"]))
    for g, w in zip(tr_, jr):
        _close(g, w)


def test_gradient_finalize_takes_the_sph_fallback():
    """An ill-conditioned E (|E|^2|B|^2/9 >= 1e4) selects grad_sph."""
    rng = np.random.default_rng(3)
    acc = [rng.standard_normal((N, 3, 3)) + 2.0 * np.eye(3),
           rng.standard_normal((N, 5, 3)), rng.standard_normal((N, 5, 3)),
           rng.random(N), rng.random((N, 5)) + 1.0, rng.random((N, 5)) - 1.0,
           rng.random(N)]
    acc[0][:10] = np.diag([1.0, 1e-3, 1e3])
    h, W, snd = 0.1 + rng.random(N), _states(rng, (N,)), rng.random(N)
    jr = jm.gradient_finalize(3, jm.GradAccum(*map(jnp.asarray, acc)),
                              jnp.asarray(h), jnp.asarray(W), jnp.asarray(snd))
    tr_ = tm.gradient_finalize(3, tm.GradAccum(*map(_t, acc)), _t(h), _t(W),
                               _t(snd))
    assert bool(np.asarray(jr.bad)[:10].all())
    for g, w in zip(tr_, jr):
        _close(g, w)


def _face_args(v, equal_w=False):
    nbr = v["nbr"]
    Wj = v["W"][nbr].copy()
    if equal_w:
        Wj[:, :4] = v["W"][:, None, :]      # the Wi == Wj branch
    return Wj


@pytest.mark.parametrize("equal_w", [False, True])
def test_gizmo_limited_dW(equal_w):
    v = _views(4)
    Wj = _face_args(v, equal_w)
    half = 0.5 * v["dr"]
    # a zero state component: sign(0) = 0 in both
    W = v["W"].copy()
    W[5, 0] = 0.0
    want = jm.gizmo_limited_dW(jnp.asarray(W), jnp.asarray(Wj),
                               jnp.asarray(v["grad"]), jnp.asarray(v["alpha"]),
                               jnp.asarray(half), jnp.asarray(v["dr"]))
    got = tm.gizmo_limited_dW(_t(W), _t(Wj), _t(v["grad"]), _t(v["alpha"]),
                              _t(half), _t(v["dr"]))
    for g, w in zip(got, want):
        _close(g, w)
    gj, aj = v["grad"][v["nbr"]], v["alpha"][v["nbr"]]
    want = jm._gizmo_limited_dW_j(jnp.asarray(Wj), jnp.asarray(W),
                                  jnp.asarray(gj), jnp.asarray(aj),
                                  jnp.asarray(-half), jnp.asarray(-v["dr"]))
    got = tm._gizmo_limited_dW_j(_t(Wj), _t(W), _t(gj), _t(aj), _t(-half),
                                 _t(-v["dr"]))
    for g, w in zip(got, want):
        _close(g, w)


def test_primitive_time_derivative():
    rng = np.random.default_rng(5)
    W = _states(rng, (N, K))
    gradW = rng.standard_normal((N, K, 5, 3))
    snd = rng.random((N, K))
    want = jm._primitive_time_derivative(jnp.asarray(W), jnp.asarray(gradW),
                                         jnp.asarray(snd), 3)
    _close(tm._primitive_time_derivative(_t(W), _t(gradW), _t(snd), 3), want)


@pytest.mark.parametrize("zero_mass_flux", [True, False])
@pytest.mark.parametrize("equal", [False, True])
def test_hllc_flux(zero_mass_flux, equal):
    """Random face states (every wave configuration: supersonic either
    way, subsonic, contact on either side), and equal states."""
    rng = np.random.default_rng(6)
    Wl = _states(rng, (N, K))
    Wr = Wl.copy() if equal else _states(rng, (N, K))
    Wl[..., :3] *= 1.0 + 8.0 * (rng.random((N, K, 1)) < 0.2)
    if equal:
        Wr = Wl.copy()
    n = rng.standard_normal((N, K, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    vface = 0.2 * rng.standard_normal((N, K, 3))
    want = jm.hllc_flux(jnp.asarray(Wl), jnp.asarray(Wr), jnp.asarray(n),
                        jnp.asarray(vface), GAMMA, zero_mass_flux)
    got = tm.hllc_flux(_t(Wl), _t(Wr), _t(n), _t(vface), GAMMA,
                       zero_mass_flux)
    _close(got, want)
    if zero_mass_flux:
        assert not got[..., 3].any()


@pytest.mark.parametrize("zero_mass_flux", [True, False])
def test_compute_godunov_fluxes(kerns, zero_mass_flux):
    """MUSCL with the Gizmo limiter and HLLC over a (N, K) view with
    bad-gradient fallbacks on both sides, a coincident pair and masked
    partners."""
    jk, tk = kerns
    v = _views(7)
    nbr = v["nbr"]
    jcfg = jm.MfvConfig(gamma=GAMMA, zero_mass_flux=zero_mass_flux)
    tcfg = tm.MfvConfig(gamma=GAMMA, zero_mass_flux=zero_mass_flux)
    nb = {"h": v["h"][nbr], "ndens": v["ndens"][nbr],
          "hfactor": v["h"][nbr] ** -4, "Wprim": v["W"][nbr],
          "sound": v["sound"][nbr], "a0": v["a0"][nbr], "B": v["B"][nbr],
          "grad": v["grad"][nbr], "alpha_slope": v["alpha"][nbr],
          "bad": v["bad"][nbr]}
    dt = 1.5e-3
    r = np.zeros((N, 3))
    want = jm.compute_godunov_fluxes(
        jk, jcfg, 3, jnp.asarray(dt), jnp.asarray(r), jnp.asarray(v["h"]),
        jnp.asarray(v["ndens"]), jnp.asarray(v["h"] ** -4),
        jnp.asarray(v["W"]), jnp.asarray(v["sound"]), jnp.asarray(v["a0"]),
        jnp.asarray(v["B"]), jnp.asarray(v["grad"]), jnp.asarray(v["alpha"]),
        jnp.asarray(v["bad"]), jnp.asarray(v["dr"]),
        {k: jnp.asarray(x) for k, x in nb.items()}, jnp.asarray(v["mask"]))
    got = tm.compute_godunov_fluxes(
        tk, tcfg, 3, torch.tensor(dt, dtype=torch.float64), _t(v["h"]),
        _t(v["ndens"]), _t(v["W"]), _t(v["sound"]), _t(v["a0"]), _t(v["B"]),
        _t(v["grad"]), _t(v["alpha"]), _t(v["bad"]), _t(v["dr"]),
        {k: _t(x) for k, x in nb.items() if k != "hfactor"}, _t(v["mask"]))
    _close(got.dQdt, want.dQdt)
    _close(got.rdmdt_dot, want.rdmdt_dot)
    assert np.abs(np.asarray(want.dQdt)).max() > 0.0


def test_godunov_refuses_options_outside_the_slice(kerns):
    """Every Riemann solver, slope limiter and time scheme of the JAX
    package runs (tests/test_torch_mfv_options.py); a name it does not
    know is refused before any work."""
    v = _views(8)
    for kw in ({"riemann": "roe"}, {"slope_limiter": "minmod"},
               {"time_scheme": "rk3"}):
        cfg = tm.MfvConfig(gamma=GAMMA, **kw)
        with pytest.raises(ValueError, match="unrecognised"):
            tm.compute_godunov_fluxes(
                kerns[1], cfg, 3, 1e-3, _t(v["h"]), _t(v["ndens"]),
                _t(v["W"]), _t(v["sound"]), _t(v["a0"]), _t(v["B"]),
                _t(v["grad"]), _t(v["alpha"]), _t(v["bad"]), _t(v["dr"]),
                {}, None)


def test_gravity_source_terms():
    rng = np.random.default_rng(9)
    Q0, Q = rng.standard_normal((2, N, 5))
    a0, a, rdm = rng.standard_normal((3, N, 3))
    dt = 2e-3
    want = jm.gravity_source_terms(3, jnp.asarray(dt), *map(jnp.asarray,
                                                            (Q0, Q, a0, a,
                                                             rdm)))
    got = tm.gravity_source_terms(3, torch.tensor(dt, dtype=torch.float64),
                                  *map(_t, (Q0, Q, a0, a, rdm)))
    _close(got, want)


@pytest.mark.parametrize("periodic", [True, False])
def test_mfv_smoothed_gravity(kerns, periodic):
    """The O(N^2) oracle, all rows and a subset of target rows."""
    jk, tk = kerns
    rng = np.random.default_rng(10)
    n = 96
    r = rng.random((n, 3))
    m = 1.0 / n * (0.5 + rng.random(n))
    h = 0.15 + 0.1 * rng.random(n)
    zeta = 1e-3 * rng.standard_normal(n)
    hfactor = h ** -4
    code = 1 if periodic else 0
    args = (3, (0.0,) * 3, (1.0,) * 3, (code,) * 3, (code,) * 3)
    want = jm.mfv_smoothed_gravity(jk, JaxBox(*args), *map(
        jnp.asarray, (r, m, h, zeta, hfactor)))
    got = tm.mfv_smoothed_gravity(tk, DomainBox(*args),
                                  *map(_t, (r, m, h, zeta, hfactor)))
    for g, w in zip(got, want):
        _close(g, w)
    rows = torch.tensor([3, 17, 40, 95])
    sub = tm.mfv_smoothed_gravity(tk, DomainBox(*args),
                                  *map(_t, (r, m, h, zeta, hfactor)),
                                  targets=rows)
    for g, w in zip(sub, want):
        _close(g, np.asarray(w)[rows.numpy()])
