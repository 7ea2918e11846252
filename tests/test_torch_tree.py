"""Port parity: the KD-bucket Barnes-Hut tree (planners, K4-K7 plain
versions) against gandalf_tpu/ops/tree.py, float64 on the CPU.

Inputs are made with numpy from a seed: the jittered lattice of the
benchmark at 8^3 and 16^3 (periodic unit box) and the Plummer-like
cluster of tests/test_tree.py (N = 3000, seed 5, open).  Both packages
get the same gather map and TreeSpec, so each stage is compared on the
same inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import tree as jt
from gandalf_tpu_torch.check import jittered_box_ic, slice_params
from gandalf_tpu_torch.convert import tree_spec_from_jax
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import tree as tt

torch.set_num_threads(1)

TOL = 1e-10
TOL_BUILD = 1e-12
PEXT = [1.0, 1.0, 1.0]


def _box(n_side):
    ic = jittered_box_ic(slice_params(n_side, self_gravity=1), n_side)
    rng = np.random.default_rng(3)
    N = len(ic["m"])
    h = ic["h"] * (1.0 + 0.2 * rng.random(N))
    zh = -0.5 * rng.random(N) / h ** 4
    return ic["r"], ic["m"], h, zh, PEXT


def _cluster():
    # tests/test_tree.py's Plummer-ish cluster
    rng = np.random.default_rng(5)
    N = 3000
    r = rng.standard_normal((N, 3))
    r *= (1.0 + (rng.random(N) * 2) ** 2)[:, None] / 3.0
    m = rng.random(N) * (2.0 / N)
    h = 0.05 * (1.0 + rng.random(N))
    zh = -0.5 * rng.random(N) / h ** 4
    return r, m, h, zh, None


CASES = {"box8": lambda: _box(8), "box16": lambda: _box(16),
         "cluster": _cluster}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    r, m, h, zh, pext = CASES[request.param]()
    gmap = jt.plan_buckets_kd(r, 32)
    return dict(name=request.param, r=r, m=m, h=h, zh=zh, pext=pext,
                gmap=gmap, jspec=jt.plan_tree_for_buckets(gmap, 0.1))


def _jax_sorted(c, spec=None):
    """gandalf_tpu's gather (1e15 in empty slots) and unwrap."""
    spec = spec or c["jspec"]
    flat = jnp.asarray(c["gmap"].reshape(-1))
    safe = jnp.maximum(flat, 0)
    in_map = flat >= 0
    r_s = jnp.where(in_map[:, None], jnp.asarray(c["r"])[safe], 1e15)
    if c["pext"] is not None:
        r_s = jt.unwrap_to_buckets(spec, r_s, in_map, c["pext"])
    m_s = jnp.where(in_map, jnp.asarray(c["m"])[safe], 0.0)
    h_s = jnp.where(in_map, jnp.asarray(c["h"])[safe], 1.0)
    zh_s = jnp.where(in_map, jnp.asarray(c["zh"])[safe], 0.0)
    return r_s, m_s, h_s, zh_s, in_map


def _port_tables(c, spec):
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    return tt.gather_to_buckets(spec, t(c["gmap"]), t(c["r"]), t(c["m"]),
                                t(c["h"]), t(c["zh"]), c["pext"])


def _scaled(got, want, rows):
    want = np.asarray(want)[rows]
    return np.max(np.abs(np.asarray(got)[rows] - want)) / np.max(
        np.abs(want))


def test_planners_match_jax(case):
    """plan_buckets_kd and the walk statistics of the C++ planner, and
    plan_tree_for_buckets, as the JAX package calls them."""
    r, h, gmap = case["r"], case["h"], case["gmap"]
    assert np.array_equal(tt.plan_buckets_kd(r, 32), gmap)
    flat = gmap.ravel()
    assert np.array_equal(np.sort(flat[flat >= 0]), np.arange(len(r)))
    got = tt.walk_stats_levels_native(r, gmap, 0.1, h=h, sample=4096)
    want = jt.walk_stats_levels_native(r, gmap, 0.1, h=h, sample=4096)
    assert got[:3] == want[:3]
    assert np.array_equal(got[3], want[3])
    for kw in ({}, {"near_cap": 64, "frontier": 96, "quadrupole": False}):
        tspec = tt.plan_tree_for_buckets(gmap, 0.1, **kw)
        jspec = jt.plan_tree_for_buckets(gmap, 0.1, **kw)
        assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
        assert tree_spec_from_jax(jspec) == tspec
    grown = tt.grow_tree_caps(dataclasses.replace(
        tspec, frontier_levels=tuple(int(w) for w in want[3])))
    assert dataclasses.asdict(grown) == dataclasses.asdict(jt.grow_tree_caps(
        dataclasses.replace(jspec, frontier_levels=tuple(
            int(w) for w in want[3]))))


def test_gather_matches_jax(case):
    """K4 plain: the JAX gather plus unwrap_to_buckets, exactly."""
    spec = tree_spec_from_jax(case["jspec"])
    ptab, alive = _port_tables(case, spec)
    r_s, m_s, h_s, zh_s, in_map = _jax_sorted(case)
    al = alive.numpy()
    assert np.array_equal(al, np.asarray(in_map))
    assert np.array_equal(ptab[:, :3].numpy()[al], np.asarray(r_s)[al])
    for col, want in ((3, m_s), (4, h_s), (5, zh_s)):
        assert np.array_equal(ptab[:, col].numpy(), np.asarray(want))


def test_build_matches_jax(case):
    """K5 plain: every level of build_tree within 1e-12 of the level's
    scale of the field (for the quadrupole max m*|half|^2, since a
    near-uniform cell's traceless quadrupole is a cancellation)."""
    spec = tree_spec_from_jax(case["jspec"])
    ptab, alive = _port_tables(case, spec)
    ctab = tt.build_tree(spec, ptab, alive).numpy()
    r_s, m_s, _, _, in_map = _jax_sorted(case)
    tree = jt.build_tree(case["jspec"], r_s, m_s, in_map)
    for ell in range(spec.depth + 1):
        rows = ctab[(1 << ell) - 1:(1 << (ell + 1)) - 1]
        m = np.asarray(tree.m[ell])
        live = m > 0
        half = np.asarray(tree.half[ell])
        q = np.asarray(tree.quad[ell])
        q6 = np.stack([q[:, i, j] for i, j in tt._TRI], -1)
        fields = {"m": (rows[:, :1], m[:, None]),
                  "com": (rows[:, 1:4], np.asarray(tree.com[ell])),
                  "half": (rows[:, 4:7], half),
                  "q": (rows[:, 7:13], q6),
                  "centre": (rows[:, 13:16], np.asarray(tree.centre[ell]))}
        for name, (got, want) in fields.items():
            scale = (np.max(m * np.sum(half * half, -1)) if name == "q"
                     else np.max(np.abs(want[live])))
            err = np.max(np.abs(got[live] - want[live])) / scale
            assert err <= TOL_BUILD, (ell, name, err)
            # empty cells carry the same far sentinel
            assert np.array_equal(got[~live], want[~live]), (ell, name)


@pytest.mark.parametrize("smoothed", [True, False])
def test_tree_gravity_matches_jax(case, smoothed):
    """K6 + K7 plain (tree_gravity) against JAX's tree_gravity on the
    same spec and inputs: with h and zh (the smoothed near field) and
    without (Newtonian)."""
    spec = tree_spec_from_jax(case["jspec"])
    ptab, alive = _port_tables(case, spec)
    ctab = tt.build_tree(spec, ptab, alive)
    kern = kernel_factory("m4", 3) if smoothed else None
    a, gpot, ovf = tt.tree_gravity(spec, ctab, ptab, alive, kern)
    r_s, m_s, h_s, zh_s, in_map = _jax_sorted(case)
    tree = jt.build_tree(case["jspec"], r_s, m_s, in_map)
    if smoothed:
        res, jovf = jt.tree_gravity(case["jspec"], tree, r_s, m_s, in_map,
                                    h_s, jax_kernel("m4", 3), zh_s)
    else:
        res, jovf = jt.tree_gravity(case["jspec"], tree, r_s, m_s, in_map)
    assert bool(ovf) == bool(jovf) is False
    al = alive.numpy()
    assert _scaled(a.numpy(), res.a, al) <= TOL
    assert _scaled(gpot.numpy(), res.gpot, al) <= TOL
    # an empty slot gets nothing
    assert not a.numpy()[~al].any()


def test_tree_gravity_grouped_matches_jax(case):
    """The pass end to end, particle order in and out."""
    spec = tree_spec_from_jax(case["jspec"])
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    kern = kernel_factory("m4", 3)
    a, gpot, ovf = tt.tree_gravity_grouped(
        spec, t(case["gmap"]), t(case["r"]), t(case["m"]), t(case["h"]),
        kern, t(case["zh"]), case["pext"])
    ja, jg, jovf = jt.tree_gravity_grouped(
        case["jspec"], jnp.asarray(case["gmap"]), jnp.asarray(case["r"]),
        jnp.asarray(case["m"]), jnp.asarray(case["h"]), jax_kernel("m4", 3),
        zh=jnp.asarray(case["zh"]), periodic_extent=case["pext"])
    assert bool(ovf) == bool(jovf) is False
    every = np.ones(len(case["m"]), bool)
    assert _scaled(a.numpy(), ja, every) <= TOL
    assert _scaled(gpot.numpy(), jg, every) <= TOL


@pytest.mark.parametrize("cap", ["near", "level"])
def test_forced_overflow_matches_jax(cap):
    """A near cap, or one level's frontier cap, too small for the walk:
    both packages raise the overflow flag."""
    c = dict(zip(("r", "m", "h", "zh", "pext"), _box(16)))
    c["gmap"] = jt.plan_buckets_kd(c["r"], 32)
    jspec = jt.plan_tree_for_buckets(c["gmap"], 0.1)
    if cap == "near":
        jspec = dataclasses.replace(jspec, near_cap=8)
    else:
        fl = [min(jspec.frontier, 1 << ell) for ell in range(jspec.depth + 1)]
        fl[4] = 4
        jspec = dataclasses.replace(jspec, frontier_levels=tuple(fl))
    c["jspec"] = jspec
    spec = tree_spec_from_jax(jspec)
    ptab, alive = _port_tables(c, spec)
    ctab = tt.build_tree(spec, ptab, alive)
    _, _, ovf = tt.tree_gravity(spec, ctab, ptab, alive)
    r_s, m_s, _, _, in_map = _jax_sorted(c)
    tree = jt.build_tree(jspec, r_s, m_s, in_map)
    _, jovf = jt.tree_gravity(jspec, tree, r_s, m_s, in_map)
    assert bool(ovf) and bool(jovf)


def test_close_pair_f2_f6():
    """ROADMAP faults F2 and F6: two distinct particles 1e-3 h apart, at
    float32-representable positions so that r_j - r_i is exact.  In
    float64 the port equals the JAX package up to the JAX package's own
    cancellation there: its m/d^3 terms cancel to a force (h/d)^3 = 1e9
    times smaller, which leaves ~2e-16 * 1e9 = 2e-7 relative error, so
    the two agree within 1e-6.  In float32 the port, which
    evaluates the pair once with the softened formula, stays within 1e-5
    of the float64 force; the JAX package's float32 value, where the
    Newtonian 1/d^3 and its subtraction cancel, is recorded beside it.
    Coincident distinct particles get no pair force or potential."""
    d = 2.0 ** -13                    # 1e-3 h at h = 1/8
    r = np.array([[0.5, 0.5, 0.5], [0.5 + d, 0.5, 0.5]])
    m = np.array([0.5, 0.25])
    h = np.array([0.125, 0.125])
    zh = np.array([-3.0, -5.0])
    gmap = jt.plan_buckets_kd(r, 32)
    jspec = jt.plan_tree_for_buckets(gmap, 0.1)
    spec = tree_spec_from_jax(jspec)
    kern, jkern = kernel_factory("m4", 3), jax_kernel("m4", 3)

    def port(dtype, rr=r):
        t = lambda x: torch.tensor(x, dtype=dtype)  # noqa: E731
        a, gpot, ovf = tt.tree_gravity_grouped(
            spec, torch.tensor(gmap), t(rr), t(m), t(h), kern, t(zh))
        assert not bool(ovf)
        return a.double().numpy(), gpot.double().numpy()

    def jax(dtype):
        j = lambda x: jnp.asarray(np.asarray(x, dtype))  # noqa: E731
        a, gpot, _ = jt.tree_gravity_grouped(jspec, jnp.asarray(gmap), j(r),
                                             j(m), j(h), jkern, zh=j(zh))
        return np.asarray(a, np.float64), np.asarray(gpot, np.float64)

    a64, g64 = port(torch.float64)
    ja64, jg64 = jax(np.float64)
    np.testing.assert_allclose(a64, ja64, rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(g64, jg64, rtol=1e-10, atol=0.0)
    # the softened pair force is attractive along x
    assert a64[0, 0] > 0.0 > a64[1, 0]
    a32, g32 = port(torch.float32)
    err32 = np.max(np.abs(a32 - a64)) / np.max(np.abs(a64))
    assert err32 <= 1e-5
    assert np.max(np.abs(g32 - g64)) / np.max(np.abs(g64)) <= 1e-5
    ja32, _ = jax(np.float32)
    jerr32 = np.max(np.abs(ja32 - a64)) / np.max(np.abs(a64))
    print(f"close pair, float32 force error: port {err32:.2e}, "
          f"gandalf_tpu {jerr32:.2e}")
    # F2: coincident distinct particles, no cancellation floor needed
    a0, g0 = port(torch.float64, np.array([r[0], r[0]]))
    assert not a0.any() and not g0.any()


def _cluster_gravity(theta_sqd, quadrupole):
    """The port's plain tree (Newtonian, float32) and its direct-sum
    twin (float64) on tests/test_tree.py's cluster."""
    from gandalf_tpu_torch.ops.sph_gravity import direct_sph_gravity

    r, m, _, _, _ = _cluster()
    gmap = tt.plan_buckets_kd(r, 32)
    # caps from the measured walk demand, as the simulation sizes them
    near_max, front_max, _, _ = tt.walk_stats_levels_native(
        r, gmap, theta_sqd, sample=4096)
    spec = tt.plan_tree_for_buckets(
        gmap, theta_sqd, quadrupole=quadrupole, near_cap=near_max + 16,
        frontier=front_max + 32)
    a, gpot, ovf = tt.tree_gravity_grouped(
        spec, torch.tensor(gmap), torch.tensor(r, dtype=torch.float32),
        torch.tensor(m, dtype=torch.float32))
    assert not bool(ovf)
    a_ref, g_ref = direct_sph_gravity(None, torch.tensor(r),
                                      torch.tensor(m))
    err = (np.linalg.norm(a.double().numpy() - a_ref.numpy(), axis=-1)
           / np.linalg.norm(a_ref.numpy(), axis=-1))
    return err, gpot.double().numpy(), g_ref.numpy()


def test_float32_monopole_accuracy():
    """tests/test_tree.py's gates on the port's float32 plain path."""
    err, _, _ = _cluster_gravity(0.1, False)
    assert np.median(err) < 3e-3
    assert err.mean() < 1e-2


def test_float32_quadrupole_beats_monopole():
    errs = {q: _cluster_gravity(0.3, q)[0].mean() for q in (False, True)}
    assert errs[True] < 0.5 * errs[False]


def test_float32_theta_controls_error():
    errs = [_cluster_gravity(th, False)[0].mean() for th in (0.5, 0.2, 0.05)]
    assert errs[0] > errs[1] > errs[2]


def test_float32_potential_accuracy():
    _, gpot, g_ref = _cluster_gravity(0.1, True)
    assert np.median(np.abs(gpot - g_ref) / g_ref) < 1e-3
