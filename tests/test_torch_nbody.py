"""Port parity: the plain versions of K13-K15 (gandalf_tpu_torch/ops/
gravity.py) against gandalf_tpu/ops/gravity.py's direct_nbody,
direct_softened (with and without the jerk) and direct_snap, and the
Hermite passes (integrate/hermite.py) and external potentials, float64,
on star sets made with numpy from a seed.

The K13-K15 tolerance is 1e-12 of the largest value of each output: both
sides evaluate the same formulas on the same inputs and only the order of
the sums over the stars differs.  The elementwise passes agree within
1e-14.  The plain versions' row chunks are also forced small, so that a
sum split across chunks is covered."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.integrate import hermite as jh
from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import gravity as jg
from gandalf_tpu.state import make_nbody_state as jax_nbody_state
from gandalf_tpu_torch.convert import nbody_state_from_jax
from gandalf_tpu_torch.integrate import hermite as th
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import gravity as tg

torch.set_num_threads(1)

TOL = 1e-12
TOL_ELEMENTWISE = 1e-14


def _close(got, want, tol=TOL):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.max(np.abs(want)), 1e-300)
    err = np.max(np.abs(got - want)) / scale
    assert err <= tol, f"{err:.3e} of max |want| {scale:.3e}"


def _cluster(n, ndim, seed=0, coincident=False):
    """A Gaussian cluster of n stars: r, v, a (an acceleration-like
    field for the snap), m, h; with `coincident`, star 1 sits on star
    0."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((n, ndim))
    if coincident:
        r[1] = r[0]
    v = 0.5 * rng.standard_normal((n, ndim))
    a = rng.standard_normal((n, ndim))
    m = (0.5 + rng.random(n)) / n
    h = 0.05 + 0.3 * rng.random(n)
    return r, v, a, m, h


CASES = [(2, 2, False), (2, 3, False), (64, 2, False), (64, 3, True),
         (300, 3, False), (300, 2, True)]
CASE_IDS = [f"n{n}-{d}d" + ("-coincident" if c else "")
            for n, d, c in CASES]


@pytest.mark.parametrize("n,ndim,coincident", CASES, ids=CASE_IDS)
def test_direct_nbody_matches_jax(n, ndim, coincident):
    r, v, _, m, _ = _cluster(n, ndim, coincident=coincident)
    want = jg.direct_nbody(jnp.asarray(r), jnp.asarray(v), jnp.asarray(m))
    got = tg.direct_nbody(torch.tensor(r), torch.tensor(v), torch.tensor(m))
    for k in ("a", "adot", "gpot"):
        _close(getattr(got, k), getattr(want, k))
    assert np.all(np.isfinite(got.a.numpy()))


@pytest.mark.parametrize("jerk", [True, False], ids=["jerk", "no_jerk"])
@pytest.mark.parametrize("n,ndim,coincident", CASES, ids=CASE_IDS)
def test_direct_softened_matches_jax(n, ndim, coincident, jerk):
    r, v, _, m, h = _cluster(n, ndim, seed=1, coincident=coincident)
    want = jg.direct_softened(jnp.asarray(r), jnp.asarray(v),
                              jnp.asarray(m), jnp.asarray(h),
                              jax_kernel("m4", ndim), compute_jerk=jerk)
    got = tg.direct_softened(torch.tensor(r), torch.tensor(v),
                             torch.tensor(m), torch.tensor(h),
                             kernel_factory("m4", ndim), compute_jerk=jerk)
    for k in ("a", "adot", "gpot"):
        _close(getattr(got, k), getattr(want, k))
    if not jerk:
        assert not got.adot.any()


@pytest.mark.parametrize("n,ndim,coincident", CASES, ids=CASE_IDS)
def test_direct_snap_matches_jax(n, ndim, coincident):
    r, v, a, m, _ = _cluster(n, ndim, seed=2, coincident=coincident)
    want = jg.direct_snap(*(jnp.asarray(x) for x in (r, v, a, m)))
    got = tg.direct_snap(*(torch.tensor(x) for x in (r, v, a, m)))
    _close(got, want)


def test_plain_versions_split_the_rows(monkeypatch):
    """Row chunks of 7 targets (300 stars: 43 chunks) give the one-chunk
    result."""
    r, v, a, m, h = (torch.tensor(x) for x in _cluster(300, 3, seed=3))
    kern = kernel_factory("m4", 3)
    whole = (tg.direct_nbody_plain(r, v, m), tg.direct_snap_plain(r, v, a, m),
             tg.direct_softened_plain(r, v, m, h, kern, True))
    monkeypatch.setattr(tg, "_CHUNK_PAIRS", 7 * 300)
    split = (tg.direct_nbody_plain(r, v, m), tg.direct_snap_plain(r, v, a, m),
             tg.direct_softened_plain(r, v, m, h, kern, True))
    for x, y in zip(whole, split):
        for p, q in zip(x if isinstance(x, tuple) else (x,),
                        y if isinstance(y, tuple) else (y,)):
            assert torch.equal(p, q)


@pytest.mark.parametrize("name", ["plummer", "vertical", "none", "silcc"])
def test_external_potential_matches_jax(name):
    r, v, _, _, _ = _cluster(50, 3, seed=4)
    cfg = {"mplummer": 1.3, "rplummer": 0.7, "kgrav": 1, "avert": -0.5,
           "rzero": 0.0}
    want = jg.external_potential(name, cfg, jnp.asarray(r), jnp.asarray(v))
    got = tg.external_potential(name, cfg, torch.tensor(r), torch.tensor(v))
    for x, y in zip(got, want):
        _close(x, y, TOL_ELEMENTWISE)


def _states(ndim=3, n=40, seed=5):
    """The same mid-step NbodyState in both packages: every Hermite field
    filled from the seed, dt 1e-2."""
    rng = np.random.default_rng(seed)
    js = jax_nbody_state(rng.standard_normal((n, ndim)),
                         rng.standard_normal((n, ndim)),
                         (0.5 + rng.random(n)) / n,
                         0.01 + 0.01 * rng.random(n))
    fields = ("a", "adot", "a2dot", "a3dot", "r0", "v0", "a0", "adot0",
              "a2dot0")
    js = js.replace(**{f: jnp.asarray(rng.standard_normal((n, ndim)))
                       for f in fields}, dt=jnp.asarray(1e-2))
    return js, nbody_state_from_jax(js)


PASSES = ["predict", "correct", "correct_ts4", "predict_ts6", "correct_ts6",
          "end_timestep"]


@pytest.mark.parametrize("name", PASSES)
def test_hermite_pass_matches_jax(name):
    js, ts = _states()
    if name == "end_timestep":
        want, got = jh.end_timestep(js), th.end_timestep(ts)
    else:
        want = getattr(jh, name)(js, js.dt)
        got = getattr(th, name)(ts, ts.dt)
    for f in ("r", "v", "a2dot", "a3dot", "r0", "v0", "a0", "adot0",
              "a2dot0"):
        _close(getattr(got, f), getattr(want, f), TOL_ELEMENTWISE)


def test_aarseth_timestep_matches_jax():
    """Every branch of the Aarseth criterion: full, a2dot only,
    acceleration only and none."""
    js, ts = _states(n=40)
    zero_rows = {"adot": slice(10, 20), "a2dot": slice(20, 40),
                 "a": slice(30, 40)}
    js = js.replace(**{f: getattr(js, f).at[rows].set(0.0)
                       for f, rows in zero_rows.items()})
    ts = nbody_state_from_jax(js)
    cfg_j = jh.HermiteConfig(nbody_mult=0.07, npec=1)
    cfg_t = th.HermiteConfig(nbody_mult=0.07, npec=1)
    want = jh.aarseth_timestep(cfg_j, js)
    got = th.aarseth_timestep(cfg_t, ts)
    _close(got, want, TOL_ELEMENTWISE)
    assert float(got.max()) == 1e20


def test_nbody_state_round_trip():
    """convert: a JAX NbodyState field by field into the port and back."""
    from gandalf_tpu_torch.convert import nbody_state_to_numpy

    js, ts = _states(ndim=2)
    back = nbody_state_to_numpy(ts)
    for f in back:
        want = np.asarray(getattr(js, f))
        assert np.array_equal(back[f], want), f
        assert back[f].dtype.kind == want.dtype.kind, f
    assert ts.r.dtype == torch.float64 and ts.nstep.dtype == torch.int64
