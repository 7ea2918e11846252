"""Port parity: the softened gravity of sinks, stars and N-body (K14, K16)
and smooth accretion (K20) with the quintic and tabulated smoothing
kernels, float64 on the CPU, against gandalf_tpu.

For m4_tab, quintic and quintic_tab at ndim 1, 2 and 3, on
check.sink_kernel_inputs and check.smooth_accretion_inputs built with
the kernel (numpy draws from a seed; the gas's h scaled to the kernel's
range; gas 1e-5 either side of kernrange and of two table points of a
star, and of K20's claim edge and two points of its s^2 grid): the plain
versions of K16 (ops/sph_gravity.py:star_gas_forces), K20's two launches
(ops/sinks.py:smooth_accretion_sums and apply_smooth_accretion) and K14
(ops/gravity.py:direct_softened, with and without the jerk, on that gas
as stars and, at ndim 2 and 3, on a 256-star Plummer cluster's first
ndim components with a coincident pair) against the JAX functions, run
eagerly.  Every output within 1e-12 of its largest value, claims and
alive masks exactly.

Pairs near a table point: on a chain of stars whose every pair in the
tabulated M4's support sits within an ulp or two of a point of its s
grid (and of its s^2 grid), K14, K16 and K20's plain forms take the JAX
package's points (the outputs agree to 1e-12), and h moved by 8 ulps
moves them by far more.  The tabulated M4's step, 0.002, has an exact
reciprocal, so fault F34 (the JAX package's jitted lookups multiply by
it) cannot part the two packages there.

The gaussian (direct or tabulated): the three wrappers refuse it before
reading any input, naming fault F23; the JAX package's star_gas_forces
with it returns exactly zero pull and potential on both sides for pairs
inside the support, and the direct gaussian beyond it too (the evidence
that extends F23 to slots).  The CUDA twins, which hold each kernel
against its plain version (check.compare_sink_family_kernels), are in
tests/test_torch_guards.py, which imports no JAX.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import gravity as jgr
from gandalf_tpu.ops import sinks as js
from gandalf_tpu.ops import sph_gravity as jsg
from gandalf_tpu_torch.check import (SINK_FAMILY_VARIANTS,
                                     nbody_kernel_inputs, sink_kernel_inputs,
                                     smooth_accretion_inputs, smooth_args)
from gandalf_tpu_torch.kernels.smoothing import VARIANTS, kernel_factory
from gandalf_tpu_torch.ops import gravity as tgr
from gandalf_tpu_torch.ops import sinks as ts
from gandalf_tpu_torch.ops import sph_gravity as tsg

torch.set_num_threads(1)

TOL = 1e-12
N_GAS = 512
N_SLOTS = 16
N_PLUMMER = 256
CASES = [(v, nd) for v in SINK_FAMILY_VARIANTS for nd in (1, 2, 3)]


def _kernels(variant, nd):
    name, tab = VARIANTS[variant]
    return jax_kernel(name, nd, tab), kernel_factory(name, nd, tab)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want), initial=0.0)
                 / max(np.max(np.abs(want), initial=0.0), 1e-300))


def _j(x):
    return jnp.asarray(x.numpy())


def _jax_sinks(st):
    return js.SinkState(**{f.name: _j(getattr(st, f.name))
                           for f in dataclasses.fields(st)})


def _jcfg(cfg):
    return js.SinkConfig(cfg.rho_sink, cfg.sink_radius, cfg.create,
                         cfg.accrete)


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]}-{c[1]}d")
def case(request):
    variant, ndim = request.param
    jk, tk = _kernels(variant, ndim)
    return (jk, tk, sink_kernel_inputs(N_GAS, N_SLOTS, "cpu",
                                       torch.float64, ndim=ndim, kern=tk),
            smooth_accretion_inputs(N_GAS, N_SLOTS, "cpu", torch.float64,
                                    ndim=ndim, kern=tk))


def _star_gas_args(inp):
    st, alive = inp["sinks"], inp["alive"]
    return (inp["r"], torch.where(alive, inp["m"], 0.0), inp["h"], st.r,
            torch.where(st.active, st.m, 0.0), st.h, st.active)


def _star_gas(jk, tk, args):
    got = tsg.star_gas_forces(tk, *args)
    want = jsg.star_gas_forces(jk, *map(_j, args))
    return {name: _rel(g, w) for name, g, w in zip(
        ("a_gas", "gpot_gas", "a_star", "gpot_star"), got, want)}


def test_star_gas_forces_match_jax(case):
    """K16 plain: both sides, dead gas massless, inactive slots pulling
    no gas, pairs either side of kernrange and of two table points."""
    jk, tk, inp, _ = case
    st = inp["sinks"]
    # the straddling gas 8-13 around star 4: s either side of kernrange,
    # of kernrange / 10 and of 7 kernrange / 10
    s = (torch.linalg.norm(inp["r"][8:14] - st.r[4], dim=1)
         / (0.5 * (inp["h"][8:14] + st.h[4]))).numpy()
    targets = np.repeat([1.0, 0.1, 0.7], 2) * tk.kernrange
    assert np.all((s < targets)[::2]) and np.all((s > targets)[1::2])
    errs = _star_gas(jk, tk, _star_gas_args(inp))
    assert max(errs.values()) <= TOL, errs


def _softened(jk, tk, r, v, m, h):
    errs = {}
    for jerk in (True, False):
        got = tgr.direct_softened(r, v, m, h, tk, jerk)
        want = jgr.direct_softened(_j(r), _j(v), _j(m), _j(h), jk, jerk)
        for f in ("a", "adot", "gpot"):
            if f == "adot" and not jerk:
                assert not bool(got.adot.any())
                continue
            errs[f"{f}_{jerk}"] = _rel(getattr(got, f), getattr(want, f))
    return errs


def test_direct_softened_matches_jax(case):
    """K14 plain with and without the jerk: the gas as stars (pairs in
    and beyond the support, massless dead stars) and, at ndim 2 and 3,
    the N-body shape: a Plummer cluster's first ndim components with a
    coincident pair."""
    jk, tk, inp, _ = case
    ndim = inp["r"].shape[1]
    m = torch.where(inp["alive"], inp["m"], 0.0)
    errs = _softened(jk, tk, inp["r"], inp["v"], m, inp["h"])
    assert max(errs.values()) <= TOL, errs
    if ndim > 1:
        (r, v, m, h), _ = nbody_kernel_inputs(N_PLUMMER, "cpu",
                                              torch.float64)
        errs = _softened(jk, tk, r[:, :ndim].contiguous(),
                         v[:, :ndim].contiguous(), m, h)
        assert max(errs.values()) <= TOL, errs


def test_smooth_accretion_matches_jax(case):
    """K20 plain, both launches: claims exactly, dm, the per-slot sums
    and the sink update within 1e-12 (W and wpot the kernel's, W on its
    s^2 grid), gas going whole and in part."""
    jk, tk, _, inp = case
    cfg, st = inp["cfg"], inp["sinks"]
    dm, sums = ts.smooth_accretion_sums(*smooth_args(tk, inp))
    J = lambda k: _j(inp[k])  # noqa: E731
    jdm, jsums = js.smooth_accretion_sums(
        _jcfg(cfg), _jax_sinks(st), J("r"), J("v"), J("m"), J("rho"),
        J("sound"), J("m"), J("alive"), J("dt"), jk, inp["mmean"],
        alpha_ss=inp["alpha_ss"])
    jclaim = np.asarray(jsums["claim"])
    claim = sums["claim"].numpy()
    np.testing.assert_array_equal(
        claim, np.where(jclaim.any(1), jclaim.argmax(1), -1))
    errs = {"dm": _rel(dm, jdm)}
    for k in ("menc", "macc", "taccrete", "dmdt"):
        errs[k] = _rel(sums[k], jsums[k])
    new, m_gas, alive_new = ts.apply_smooth_accretion(
        st, inp["r"], inp["v"], inp["m"], dm, sums["claim"], inp["alive"])
    jnew, jm, jalive = js.apply_smooth_accretion(
        _jax_sinks(st), J("r"), J("v"), J("m"), jdm, jsums["claim"],
        J("alive"))
    for f in ("r", "v", "r0", "v0", "m", "angmom"):
        errs[f"sink_{f}"] = _rel(getattr(new, f), getattr(jnew, f))
    errs["m_gas"] = _rel(m_gas, jm)
    assert max(errs.values()) <= TOL, errs
    np.testing.assert_array_equal(alive_new.numpy(), np.asarray(jalive))
    m = inp["m"].numpy()
    got = claim >= 0
    assert int((dm.numpy()[got] == m[got]).sum()) > 0
    assert int(((dm.numpy() > 0) & (dm.numpy() < m)).sum()) > 0
    # gas 14 just inside star 4's claim edge, 15 just outside it (unless
    # a nearer star holds either)
    assert claim[15] != 4


# ---------------------------------------------------------------------------
# Pairs near a table point
# ---------------------------------------------------------------------------

NEAR_N = 24


def _near_chain():
    """NEAR_N stars on a line at positions in units u = 1/64 (every
    position and separation exact), the gaps alternately u and 2u, and h
    = u / 0.6: every pair in the M4's support has s = 0.6, 1.2 or 1.8
    within an ulp or two, each a point of the tabulated M4's s grid (step
    0.002), and s^2 = 0.36 or 1.44 a point of its s^2 grid (step
    0.004)."""
    u = 1.0 / 64
    gaps = np.where(np.arange(NEAR_N) % 2 == 0, u, 2 * u)
    r = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])[:, None]
    return r, u / 0.6


def _near_grid(s, step):
    """Pairs with s within 4 ulps of a multiple of step."""
    q = s / step
    return int(np.sum(np.abs(q - np.round(q))
                      <= 4 * np.finfo(float).eps * np.maximum(q, 1.0)))


def test_tabulated_pairs_near_a_table_point():
    """The tabulated M4 on _near_chain: K14 (the chain as stars), K16
    (the chain's even members as gas, its odd ones as slots) and K20's
    sums (the same, each slot claiming within 2 h) take the JAX package's
    table points: within 1e-12 of its outputs, while h moved by 8 ulps
    either way moves them by far more."""
    jk, tk = _kernels("m4_tab", 1)
    r, h_near = _near_chain()
    d = np.abs(r[:, 0, None] - r[None, :, 0])
    s = d[(d > 0) & (d / h_near < jk.kernrange)] / h_near
    assert s.size > 0
    assert _near_grid(s, jk.kernrange / tk.table_res) == s.size
    assert _near_grid(s * s, jk.kernrange ** 2 / tk.table_res) == s.size
    rng = np.random.default_rng(5)
    N = NEAR_N
    f64 = dict(dtype=torch.float64)
    v = torch.tensor(0.1 * rng.standard_normal((N, 1)), **f64)
    m = torch.tensor(np.full(N, 1.0 / N), **f64)
    rt = torch.tensor(r, **f64)
    gas, slot = slice(0, N, 2), slice(1, N, 2)
    act = torch.ones((N // 2,), dtype=torch.bool)
    sinks = ts.make_sinks(r[slot], v[slot].numpy(), np.full(N // 2, 0.01),
                          np.full(N // 2, h_near), dtype=torch.float64)
    cfg = ts.SinkConfig(rho_sink=1.0, sink_radius=2.0, create=False,
                        accrete=True)
    rho = torch.tensor(1.0 + rng.random(N // 2), **f64)
    sound = torch.tensor(0.5 + rng.random(N // 2), **f64)
    alive = torch.ones((N // 2,), dtype=torch.bool)
    dt = torch.tensor(0.01, **f64)

    def outputs(h, ref):
        hh = torch.full((N,), h, **f64)
        k14 = tgr.direct_softened(rt, v, m, hh, tk, True)
        sg_args = (rt[gas], m[gas], hh[gas], rt[slot], m[slot], hh[slot],
                   act)
        k16 = tsg.star_gas_forces(tk, *sg_args)
        sk = sinks.replace(h=hh[slot])
        k20 = ts.smooth_accretion_sums(cfg, sk, rt[gas], v[gas], m[gas],
                                       rho, sound, alive, dt, tk, 1.0 / N)
        got = torch.cat([x.reshape(-1) for x in (*k14, *k16)]
                        + [k20[0], k20[1]["menc"], k20[1]["taccrete"]])
        if not ref:
            return got, None
        j14 = jgr.direct_softened(_j(rt), _j(v), _j(m), _j(hh), jk, True)
        j16 = jsg.star_gas_forces(jk, *map(_j, sg_args))
        jdm, jsums = js.smooth_accretion_sums(
            _jcfg(cfg), _jax_sinks(sk), _j(rt[gas]), _j(v[gas]),
            _j(m[gas]), _j(rho), _j(sound), _j(rho), _j(alive), _j(dt), jk,
            1.0 / N)
        want = np.concatenate(
            [np.asarray(x).reshape(-1) for x in (*j14, *j16)]
            + [np.asarray(jdm), np.asarray(jsums["menc"]),
               np.asarray(jsums["taccrete"])])
        return got, want

    got, want = outputs(h_near, True)
    assert _rel(got, want) <= TOL
    for ulps in (8, -8):
        moved, _ = outputs(h_near * (1.0 + ulps * np.finfo(float).eps),
                           False)
        assert _rel(moved, want) > 1e3 * TOL, ulps


# ---------------------------------------------------------------------------
# The gaussian: fault F23
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tab", [0, 1])
def test_gaussian_refused_before_any_input_f23(tab):
    """K14, K16 and K20's sums refuse the gaussian, direct or tabulated,
    naming fault F23, before they read any input (every input None)."""
    from gandalf_tpu_torch import _ext

    kern = kernel_factory("gaussian", 3, tab)
    before = dict(_ext.LAUNCHES)
    for call in (lambda: _ext.direct_softened(None, None, None, None, True,
                                              kern=kern),
                 lambda: _ext.star_gas_forces(*[None] * 7, kern=kern),
                 lambda: _ext.smooth_accretion_sums(
                     *[None] * 13, 1.0, 0.1, 0.01, 0.01, kern=kern)):
        with pytest.raises(NotImplementedError, match="fault F23"):
            call()
    assert _ext.LAUNCHES == before


@pytest.mark.parametrize("tab", [0, 1])
def test_jax_gaussian_star_gas_is_zero_f23(tab):
    """Fault F23 with slots, shown on the JAX package: its gaussian wgrav
    and wpot are zero, so star_gas_forces returns exactly zero a_gas,
    a_star, gpot_gas and gpot_star for pairs inside the support (h raised
    until every pair is), where the quintic's are not; beyond the support
    the direct gaussian gives zero too, the tabulated one the table's
    Newtonian far form: its gpot_star is the Newtonian sum over the pairs
    at s >= 3 alone."""
    inp = sink_kernel_inputs(256, 16, "cpu", torch.float64, ndim=3)
    args = _star_gas_args(inp)
    inside = (*args[:2], args[2] + 10.0, *args[3:])
    jk = jax_kernel("gaussian", 3, tab)
    for x in jsg.star_gas_forces(jk, *map(_j, inside)):
        assert not np.asarray(x).any()
    for x in jsg.star_gas_forces(jax_kernel("quintic", 3, tab),
                                 *map(_j, inside)):
        assert np.abs(np.asarray(x)).max() > 0
    r, m, h, rs, _, hs, _ = (x.numpy() for x in args)
    # a coincident pair takes |dr| = 1, as the JAX form takes it
    d = np.linalg.norm(rs[None, :, :] - r[:, None, :], axis=-1)
    d = np.where(d > 0, d, 1.0)
    s = d / (0.5 * (h[:, None] + hs[None, :]))
    assert (s < 3.0).any() and (s >= 3.0).any()
    out = jsg.star_gas_forces(jk, *map(_j, args))
    if not tab:
        for x in out:
            assert not np.asarray(x).any()
        return
    far = np.where(s >= 3.0, m[:, None] / d, 0.0)
    np.testing.assert_allclose(np.asarray(out[3]), far.sum(0), rtol=1e-12,
                               atol=0.0)
