"""Port parity: the options of the meshless finite-volume flux pass in
gandalf_tpu_torch/ops/mfv.py against gandalf_tpu/ops/mfv.py, float64, on
inputs made with numpy from a seed: the exact Riemann solver
(exact_star_region, _sample_zero, exact_flux), the per-neighbour cell
limiters (limiter_alpha_accumulate) and compute_godunov_fluxes under
every Riemann solver, slope limiter, time scheme and face velocity, in
1, 2 and 3 dims.

Tolerances: the exact solver's pieces 1e-12 relative (both take exactly
10 Newton steps from the same guess with the same pow calls; only libm's
rounding may differ); the limiter alphas and the fluxes 1e-9 of each
output's largest value (a flux sums ~16 faces of either sign)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import mfv as jm
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import mfv as tm

torch.set_num_threads(1)

TOL_EXACT = 1e-12
TOL = 1e-9
GAMMA = 1.4
N, K = 48, 16

# tests/test_mfv.py:84-94: Sod, the 123 problem, Toro's blast (test 3)
# and Toro's test 4, then 20 random states
TORO = {"sod": (1.0, 0.0, 1.0, 0.125, 0.0, 0.1),
        "123": (1.0, -2.0, 0.4, 1.0, 2.0, 0.4),
        "blast": (1.0, 0.0, 1000.0, 1.0, 0.0, 0.01),
        "toro4": (5.99924, 19.5975, 460.894, 5.99242, -6.19633, 46.095)}


def _random_states():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(20):
        dl, dr = rng.uniform(0.05, 5.0, 2)
        pl, pr = rng.uniform(0.05, 5.0, 2)
        ul, ur = rng.uniform(-1.5, 1.5, 2)
        out.append((dl, ul, pl, dr, ur, pr))
    return out


def _rows(name):
    """(dl, ul, pl, cl, dr, ur, pr, cr) as arrays over the case's
    states."""
    states = _random_states() if name == "random" else [TORO[name]]
    a = np.array(states, dtype=np.float64)
    dl, ul, pl, dr, ur, pr = a.T
    cl, cr = np.sqrt(GAMMA * pl / dl), np.sqrt(GAMMA * pr / dr)
    return dl, ul, pl, cl, dr, ur, pr, cr


def _rel_close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert np.all((err <= tol) | (np.abs(got - want) <= 1e-300)), \
        f"{err.max():.3e}"


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.max(np.abs(want)), 1e-300)
    err = np.max(np.abs(got - want)) / scale
    assert err <= tol, f"{err:.3e} of max |want| {scale:.3e}"


@pytest.mark.parametrize("case", ["sod", "123", "blast", "toro4", "random"])
def test_exact_star_region_and_sample(case):
    """p*, u* and the state sampled at x/t = 0 (rho, u, p) against the
    JAX package's, relative 1e-12 per state."""
    rows = _rows(case)
    jp, ju = jm.exact_star_region(*map(jnp.asarray, rows), GAMMA)
    tp, tu = tm.exact_star_region(*map(torch.tensor, rows), GAMMA)
    _rel_close(tp, jp, TOL_EXACT)
    _rel_close(tu, ju, TOL_EXACT)
    want = jm._sample_zero(jp, ju, *map(jnp.asarray, rows), GAMMA)
    got = tm._sample_zero(tp, tu, *map(torch.tensor, rows), GAMMA)
    for g, w in zip(got, want):
        _rel_close(g, w, TOL_EXACT)


def _faces(rng, n, ndim):
    """Face-frame states, unit normals and face velocities of `n` faces
    in `ndim` dims."""
    def state():
        v = 0.8 * rng.standard_normal((n, ndim))
        rho = rng.uniform(0.05, 5.0, n)
        p = rng.uniform(0.05, 5.0, n)
        return np.concatenate([v, rho[:, None], p[:, None]], -1)

    nrm = rng.standard_normal((n, ndim))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return state(), state(), nrm, 0.3 * rng.standard_normal((n, ndim))


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("zero_mass_flux", [True, False])
def test_exact_flux(ndim, zero_mass_flux):
    """The exact Godunov flux on 64 random faces and the four Toro cases
    along the first axis, relative 1e-12 of each flux component's
    largest value; under zero mass flux the mass flux is 0."""
    rng = np.random.default_rng(10 + ndim)
    Wl, Wr, n, vface = _faces(rng, 64, ndim)
    for dl, ul, pl, dr, ur, pr in TORO.values():
        wl = np.zeros(ndim + 2)
        wr = np.zeros(ndim + 2)
        wl[0], wl[ndim], wl[ndim + 1] = ul, dl, pl
        wr[0], wr[ndim], wr[ndim + 1] = ur, dr, pr
        e0 = np.eye(ndim)[0]
        Wl, Wr = np.vstack([Wl, wl]), np.vstack([Wr, wr])
        n, vface = np.vstack([n, e0]), np.vstack([vface, 0.0 * e0])
    want = np.asarray(jm.exact_flux(*map(jnp.asarray, (Wl, Wr, n, vface)),
                                    GAMMA, zero_mass_flux))
    got = tm.exact_flux(*map(torch.tensor, (Wl, Wr, n, vface)), GAMMA,
                        zero_mass_flux).numpy()
    for v in range(ndim + 2):
        _close(got[:, v], want[:, v], TOL_EXACT)
    if zero_mass_flux:
        assert not np.any(got[:, ndim])


def test_exact_flux_vacuum():
    """Two states receding faster than their sound speeds allow: p* = 0
    and a zero flux, as the JAX package gives."""
    Wl = np.array([[-4.0, 1.0, 0.1]])
    Wr = np.array([[4.0, 1.0, 0.1]])
    n, vface = np.array([[1.0]]), np.array([[0.0]])
    want = np.asarray(jm.exact_flux(*map(jnp.asarray, (Wl, Wr, n, vface)),
                                    GAMMA, True))
    got = tm.exact_flux(*map(torch.tensor, (Wl, Wr, n, vface)), GAMMA,
                        True).numpy()
    assert np.array_equal(want, np.zeros_like(want))
    assert np.array_equal(got, want)


def _views(ndim, seed=0):
    """A particle block and an (N, K) neighbour view of it in `ndim`
    dims: separations within the M4 support of h ~ 0.15, some beyond it,
    one coincident partner; gradients, B matrices, alphas, flags and
    signed extrema per particle."""
    rng = np.random.default_rng(seed)
    nvar = ndim + 2
    h = 0.12 + 0.06 * rng.random(N)
    nbr = rng.integers(0, N, size=(N, K))
    dr = 0.35 * (rng.random((N, K, ndim)) - 0.5)
    dr[0, 0] = 0.0
    v = 0.3 * rng.standard_normal((N, ndim))
    rho = 0.5 + rng.random(N)
    p = 0.4 + rng.random(N)
    W = np.concatenate([v, rho[:, None], p[:, None]], -1)
    return {
        "h": h, "nbr": nbr, "dr": dr, "W": W,
        "ndens": (200.0 + 50.0 * rng.random(N)) ** (ndim / 3.0),
        "sound": np.sqrt(GAMMA * p / rho),
        "a0": 0.1 * rng.standard_normal((N, ndim)),
        "B": 50.0 * (np.eye(ndim)
                     + 0.1 * rng.standard_normal((N, ndim, ndim))),
        "grad": rng.standard_normal((N, nvar, ndim)),
        "alpha": rng.random((N, nvar)),
        "bad": rng.random(N) < 0.3,
        "mask": rng.random((N, K)) < 0.9,
        "dWmax": rng.random((N, nvar)),
        "dWmin": -rng.random((N, nvar)),
    }


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("limiter", ["tvdscalar", "springel2009"])
def test_limiter_alpha_accumulate(limiter, ndim):
    """The per-neighbour sweep from a running alpha below 1, with masked
    partners and a coincident one: alphas within 1e-9, and some limited
    below the running value."""
    v = _views(ndim, 4)
    alpha0 = 0.5 + 0.5 * np.random.default_rng(5).random((N, ndim + 2))
    W_j = v["W"][v["nbr"]]
    args = (v["h"], v["W"], v["grad"], v["dWmax"], v["dWmin"], v["dr"],
            W_j)
    want = jm.limiter_alpha_accumulate(
        limiter, jax_kernel("m4", ndim), ndim, jnp.asarray(alpha0),
        *map(jnp.asarray, args), jnp.asarray(v["mask"]))
    got = tm.limiter_alpha_accumulate(
        limiter, kernel_factory("m4", ndim), ndim, torch.tensor(alpha0),
        *map(torch.tensor, args), torch.tensor(v["mask"]))
    _close(got, want)
    assert np.any(np.asarray(want) < alpha0)


RIEMANN = ("hllc", "exact")
LIMITERS = ("gizmo", "scalar", "null", "zeroslope", "tvdscalar",
            "springel2009")


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("static", [False, True], ids=["moving", "static"])
@pytest.mark.parametrize("scheme", ["muscl", "rk2"])
@pytest.mark.parametrize("limiter", LIMITERS)
@pytest.mark.parametrize("riemann", RIEMANN)
def test_godunov_fluxes_in_every_mode(riemann, limiter, scheme, static,
                                      ndim):
    """compute_godunov_fluxes on the same (N, K) views through both
    packages: dQdt and rdmdt_dot within 1e-9 of their largest values."""
    v = _views(ndim, 8)
    nbr = v["nbr"]
    kw = dict(gamma=GAMMA, zero_mass_flux=True, static_particles=static,
              riemann=riemann, slope_limiter=limiter, time_scheme=scheme)
    nb = {"h": v["h"][nbr], "ndens": v["ndens"][nbr],
          "hfactor": v["h"][nbr] ** -(ndim + 1), "Wprim": v["W"][nbr],
          "sound": v["sound"][nbr], "a0": v["a0"][nbr], "B": v["B"][nbr],
          "grad": v["grad"][nbr], "alpha_slope": v["alpha"][nbr],
          "bad": v["bad"][nbr]}
    dt = 1.5e-3
    want = jm.compute_godunov_fluxes(
        jax_kernel("m4", ndim), jm.MfvConfig(**kw), ndim, jnp.asarray(dt),
        jnp.zeros((N, ndim)), jnp.asarray(v["h"]), jnp.asarray(v["ndens"]),
        jnp.asarray(v["h"] ** -(ndim + 1)), jnp.asarray(v["W"]),
        jnp.asarray(v["sound"]), jnp.asarray(v["a0"]), jnp.asarray(v["B"]),
        jnp.asarray(v["grad"]), jnp.asarray(v["alpha"]),
        jnp.asarray(v["bad"]), jnp.asarray(v["dr"]),
        {k: jnp.asarray(x) for k, x in nb.items()}, jnp.asarray(v["mask"]))
    got = tm.compute_godunov_fluxes(
        kernel_factory("m4", ndim), tm.MfvConfig(**kw), ndim,
        torch.tensor(dt, dtype=torch.float64),
        *map(torch.tensor, (v["h"], v["ndens"], v["W"], v["sound"], v["a0"],
                            v["B"], v["grad"], v["alpha"], v["bad"],
                            v["dr"])),
        {k: torch.tensor(x) for k, x in nb.items() if k != "hfactor"},
        torch.tensor(v["mask"]))
    _close(got.dQdt, want.dQdt)
    _close(got.rdmdt_dot, want.rdmdt_dot)
    assert np.abs(np.asarray(want.dQdt)).max() > 0.0
