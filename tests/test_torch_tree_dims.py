"""Port parity: the KD-bucket Barnes-Hut tree at ndim 1 and 2 (K4-K7's
plain versions) against gandalf_tpu/ops/tree.py, float64 on the CPU.

Inputs are made with numpy from a seed: jittered lattices, a centrally
condensed 2D disc (812 particles, open) and 1D rod (300, open), a
24^2 periodic square and a periodic 1D ring of 160 (K4's per-bucket
unwrap).  Both packages get the same gather map and TreeSpec.  (Points
drawn at random put pairs at 1e-4 h, where the JAX package's near field,
whose distances come from a dot-product expansion, loses digits: a
random disc of 1,200 parts from the port at 6e-11, a random rod at 9e-9;
ROADMAP queue 3, faults F2 and F6.)

- K4 (the gather with unwrap_to_buckets) exactly, K5 (build_tree, the
  quadrupole 3 sum m dr dr^T - tr I, not traceless below 3D) within
  1e-12 of each level's scale of each field;
- the whole pass, tree_gravity_grouped, within 1e-12 of the largest |a|
  and |gpot| in each walk option: the quadrupole with the grad-h zeta
  term, Newtonian pairs, the monopole, the gadget2 and eigenmac MACs,
  both fast multipoles, the MFV zeta mode and the quintic kernel;
- tree_gravity_active over every other bucket (the block tick's walk);
- the JAX package's own tree against its all-pairs sum on the 2D and 1D
  spheres of sphere_block_params at setup, hydro forces off (1,528 and
  200 particles), the accuracy chip_smoke.py's 2D gates refer to;
- (on the card, K4-K7 at ndim 1 and 2 against their plain versions:
  tests/test_torch_guards.py, which imports no JAX.)"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import tree as jt
from gandalf_tpu.ops.sph_gravity import direct_sph_gravity
from gandalf_tpu_torch.check import disc_params
from gandalf_tpu_torch.convert import tree_spec_from_jax
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import tree as tt
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

torch.set_num_threads(1)

TOL = 1e-12
THETA_SQD = 0.3


def _fields(rng, r):
    N = len(r)
    m = (0.5 + rng.random(N)) / N
    h = 0.04 * (1.0 + rng.random(N))
    zh = -0.5 * rng.random(N) / h ** 4
    return m, h, zh


def _disc():
    # a jittered square lattice inside the unit disc, drawn toward the
    # centre (812 particles)
    rng = np.random.default_rng(11)
    n = 32
    x = (np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                  -1).reshape(-1, 2) + 0.5) / n - 0.5
    x = x[np.sum(x * x, 1) < 0.25]
    x = x + 0.2 / n * rng.standard_normal(x.shape)
    r = x * (0.3 + np.sum(x * x, 1, keepdims=True))
    return (r, *_fields(rng, r), None)


def _rod():
    # a jittered 1D lattice drawn toward the centre (300 particles)
    rng = np.random.default_rng(12)
    n = 300
    x = ((np.arange(n)[:, None] + 0.5) / n - 0.5
         + 0.2 / n * rng.standard_normal((n, 1)))
    r = x * (0.3 + x * x)
    return (r, *_fields(rng, r), None)


def _square():
    rng = np.random.default_rng(13)
    n = 24
    x = (np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                  -1).reshape(-1, 2) + 0.5) / n
    r = np.mod(x + 0.25 / n * rng.standard_normal(x.shape), 1.0)
    return (r, *_fields(rng, r), [1.0, 1.0])


def _ring():
    rng = np.random.default_rng(14)
    n = 160
    r = np.mod((np.arange(n)[:, None] + 0.5) / n
               + 0.3 / n * rng.standard_normal((n, 1)), 1.0)
    return (r, *_fields(rng, r), [1.0])


CASES = {"disc2": _disc, "rod1": _rod, "square2": _square, "ring1": _ring}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    r, m, h, zh, pext = CASES[request.param]()
    gmap = jt.plan_buckets_kd(r, 32)
    return dict(name=request.param, r=r, m=m, h=h, zh=zh, pext=pext,
                gmap=gmap, jspec=jt.plan_tree_for_buckets(gmap, THETA_SQD))


def _jax_sorted(c):
    """gandalf_tpu's gather (1e15 in empty slots) and unwrap."""
    flat = jnp.asarray(c["gmap"].reshape(-1))
    safe = jnp.maximum(flat, 0)
    in_map = flat >= 0
    r_s = jnp.where(in_map[:, None], jnp.asarray(c["r"])[safe], 1e15)
    if c["pext"] is not None:
        r_s = jt.unwrap_to_buckets(c["jspec"], r_s, in_map, c["pext"])
    m_s = jnp.where(in_map, jnp.asarray(c["m"])[safe], 0.0)
    h_s = jnp.where(in_map, jnp.asarray(c["h"])[safe], 1.0)
    zh_s = jnp.where(in_map, jnp.asarray(c["zh"])[safe], 0.0)
    return r_s, m_s, h_s, zh_s, in_map


def _t(x):
    return torch.tensor(np.asarray(x))


def _port_tables(c, spec):
    return tt.gather_to_buckets(spec, _t(c["gmap"]), _t(c["r"]), _t(c["m"]),
                                _t(c["h"]), _t(c["zh"]), c["pext"])


def _scaled(got, want):
    want = np.asarray(want)
    return np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want))


def test_layouts():
    """The tables' columns in 1-3 dims (csrc/tree.cuh's Layout<NDIM>)."""
    for nd, (pcols, ccols, fast) in {3: (6, 16, 13), 2: (5, 10, 7),
                                     1: (4, 5, 3)}.items():
        lay = tt.layout(nd)
        assert (lay.pcols, lay.ccols, lay.fast_cols) == (pcols, ccols, fast)
        assert lay.c_cen + nd == lay.ccols
    assert tt.tri(2) == ((0, 0), (0, 1), (1, 1)) and tt.tri(3) == tt._TRI


def test_gather_matches_jax(case):
    """K4 plain: the JAX gather plus unwrap_to_buckets, exactly."""
    spec = tree_spec_from_jax(case["jspec"])
    nd = case["r"].shape[1]
    ptab, alive = _port_tables(case, spec)
    assert ptab.shape == (spec.n_pad, nd + 3)
    r_s, m_s, h_s, zh_s, in_map = _jax_sorted(case)
    al = alive.numpy()
    assert np.array_equal(al, np.asarray(in_map))
    assert np.array_equal(ptab[:, :nd].numpy()[al], np.asarray(r_s)[al])
    for col, want in ((nd, m_s), (nd + 1, h_s), (nd + 2, zh_s)):
        assert np.array_equal(ptab[:, col].numpy(), np.asarray(want))


def test_build_matches_jax(case):
    """K5 plain: every level of build_tree within 1e-12 of the level's
    scale of the field (the quadrupole against max m |half|^2)."""
    spec = tree_spec_from_jax(case["jspec"])
    nd = case["r"].shape[1]
    lay = tt.layout(nd)
    ptab, alive = _port_tables(case, spec)
    ctab = tt.build_tree(spec, ptab, alive).numpy()
    assert ctab.shape == ((2 << spec.depth) - 1, lay.ccols)
    r_s, m_s, _, _, in_map = _jax_sorted(case)
    tree = jt.build_tree(case["jspec"], r_s, m_s, in_map)
    for ell in range(spec.depth + 1):
        rows = ctab[(1 << ell) - 1:(1 << (ell + 1)) - 1]
        m = np.asarray(tree.m[ell])
        live = m > 0
        half = np.asarray(tree.half[ell])
        q = np.asarray(tree.quad[ell])
        fields = {
            "m": (rows[:, :1], m[:, None]),
            "com": (rows[:, lay.c_com:lay.c_com + nd],
                    np.asarray(tree.com[ell])),
            "half": (rows[:, lay.c_half:lay.c_half + nd], half),
            "q": (rows[:, lay.c_q:lay.c_q + lay.nq],
                  np.stack([q[:, i, j] for i, j in lay.tri], -1)),
            "centre": (rows[:, lay.c_cen:lay.c_cen + nd],
                       np.asarray(tree.centre[ell]))}
        for name, (got, want) in fields.items():
            scale = (np.max(m * np.sum(half * half, -1)) if name == "q"
                     else np.max(np.abs(want[live])))
            err = np.max(np.abs(got[live] - want[live])) / scale
            assert err <= TOL, (ell, name, err)
            assert np.array_equal(got[~live], want[~live]), (ell, name)


# walk options: (TreeSpec fields, kernel, zeta scaling, MAC inputs)
OPTIONS = {
    "quadrupole": ({}, "m4", "sph", False),
    "newtonian": ({}, None, "sph", False),
    "monopole": ({"quadrupole": False}, "m4", "sph", False),
    "gadget2": ({"mac": "gadget2", "macerror": 1e-3}, "m4", "sph", True),
    "eigenmac": ({"mac": "eigenmac", "macerror": 1e-3}, "m4", "sph", True),
    "fast_monopole": ({"quadrupole": False, "fast": True}, "m4", "sph",
                      False),
    "fast_quadrupole": ({"fast": True}, "m4", "sph", False),
    "mfv_zeta": ({}, "m4", "mfv", False),
    "quintic": ({}, "quintic", "sph", False),
}
OPTION_CASES = ([("disc2", o) for o in OPTIONS]
                + [("rod1", o) for o in OPTIONS]
                + [("square2", "quadrupole"), ("ring1", "quadrupole")])


@pytest.mark.parametrize("name,option", OPTION_CASES,
                         ids=[f"{c}-{o}" for c, o in OPTION_CASES])
def test_grouped_matches_jax(name, option):
    """The pass end to end (K4-K7 plain), particle order in and out, in
    one walk option, against the JAX package's tree_gravity_grouped on
    the same spec and inputs."""
    r, m, h, zh, pext = CASES[name]()
    nd = r.shape[1]
    gmap = jt.plan_buckets_kd(r, 32)
    over, kname, zeta, mac_inputs = OPTIONS[option]
    jspec = dataclasses.replace(jt.plan_tree_for_buckets(gmap, THETA_SQD),
                                **over)
    spec = tree_spec_from_jax(jspec)
    rng = np.random.default_rng(5)
    amag = 0.5 + rng.random(len(m)) if mac_inputs else None
    gprev = 1.0 + rng.random(len(m)) if mac_inputs else None
    kern = kernel_factory(kname, nd) if kname else None
    jkern = jax_kernel(kname, nd) if kname else None
    kw = {}
    if option == "gadget2":
        kw = {"amag": amag}
    elif option == "eigenmac":
        kw = {"gpot_prev": gprev}
    a, gpot, ovf = tt.tree_gravity_grouped(
        spec, _t(gmap), _t(r), _t(m), _t(h) if kern else None, kern,
        _t(zh) if kern else None, pext, zeta_scaling=zeta,
        **{k: _t(v) for k, v in kw.items()})
    ja, jg, jovf = jt.tree_gravity_grouped(
        jspec, jnp.asarray(gmap), jnp.asarray(r), jnp.asarray(m),
        jnp.asarray(h) if kern else None, jkern,
        zh=jnp.asarray(zh) if kern else None, periodic_extent=pext,
        zeta_scaling=zeta, **{k: jnp.asarray(v) for k, v in kw.items()})
    assert bool(ovf) == bool(jovf) is False
    assert a.shape == (len(m), nd)
    assert _scaled(a.numpy(), ja) <= TOL, _scaled(a.numpy(), ja)
    assert _scaled(gpot.numpy(), jg) <= TOL, _scaled(gpot.numpy(), jg)


@pytest.mark.parametrize("name", ["disc2", "rod1"])
def test_active_matches_jax(name):
    """tree_gravity_active over every other bucket (K6 and K7's list
    mode) against the JAX package's, rows of unlisted buckets zero."""
    r, m, h, zh, pext = CASES[name]()
    nd = r.shape[1]
    gmap = jt.plan_buckets_kd(r, 32)
    jspec = jt.plan_tree_for_buckets(gmap, THETA_SQD)
    spec = tree_spec_from_jax(jspec)
    ids = np.arange(0, spec.n_leaves, 2, dtype=np.int32)
    a, gpot, ovf = tt.tree_gravity_active(
        spec, _t(gmap), _t(r), _t(m), _t(h), kernel_factory("m4", nd),
        _t(zh), _t(ids), pext)
    ja, jg, jovf = jt.tree_gravity_active(
        jspec, jnp.asarray(gmap), jnp.asarray(r), jnp.asarray(m),
        jnp.asarray(h), jax_kernel("m4", nd), zh=jnp.asarray(zh),
        group_ids=jnp.asarray(ids), periodic_extent=pext)
    assert bool(ovf) == bool(jovf) is False
    listed = np.zeros(len(m), bool)
    rows = gmap[ids].reshape(-1)
    listed[rows[rows >= 0]] = True
    assert not a.numpy()[~listed].any() and listed.any() and \
        not listed.all()
    assert _scaled(a.numpy(), ja) <= TOL
    assert _scaled(gpot.numpy(), jg) <= TOL


# the JAX tree's error against its all-pairs sum, |da| / mean |a| per
# particle, at setup of the sphere at ndim 2 and 1 with hydro forces off:
# the median's bound, read from the JAX package's runs (2D median 3.6e-4,
# max 1.9e-3; 1D median 1.0e-3, max 4.3e-3), and rms|da| / rms|a|, the
# metric of check.gravity_accuracy and of chip_smoke.py's 2D gates
ACCURACY = {2: (1500, 1528, 1e-3), 1: (200, 200, 3e-3)}


@pytest.mark.parametrize("ndim", [2, 1])
def test_jax_tree_accuracy_below_3d(ndim):
    """The JAX package's quadrupole tree (geometric MAC, theta^2 0.1,
    the plan of its controller) against its own all-pairs sum,
    direct_sph_gravity, on the sphere's state at setup (the port's
    controller makes the state: the two agree to 1e-9 at setup,
    tests/test_torch_gravity_dims_sim.py)."""
    n_target, n, bound = ACCURACY[ndim]
    p = disc_params(n_target, ndim)
    p.set("hydro_forces", 0)
    sim = GradhSphSimulation(p, device="cpu", dtype=torch.float64)
    sim.SetupSimulation()
    s = sim.state
    assert s.N == n
    jspec = jt.TreeSpec(**dataclasses.asdict(sim.treespec))
    f = {k: jnp.asarray(getattr(s, k).numpy())
         for k in ("r", "m", "h", "zeta", "hfactor")}
    jkern = jax_kernel("m4", ndim)
    a_t, _, ovf = jt.tree_gravity_grouped(
        jspec, jnp.asarray(s.bucket_map.numpy()), f["r"], f["m"], f["h"],
        jkern, zh=f["zeta"] * f["hfactor"])
    assert not bool(ovf)
    ref = np.asarray(direct_sph_gravity(jkern, f["r"], f["m"], f["h"],
                                        f["zeta"], f["hfactor"]).a)
    da = np.asarray(a_t) - ref
    err = np.linalg.norm(da, axis=1) / np.mean(np.linalg.norm(ref, axis=1))
    rms = float(np.sqrt(np.sum(da * da) / np.sum(ref * ref)))
    print(f"gandalf_tpu tree at ndim {ndim}, N = {n}: |da| / mean |a| "
          f"median {np.median(err):.3e}, max {err.max():.3e}; "
          f"rms|da| / rms|a| {rms:.3e}")
    assert np.median(err) <= bound


@pytest.mark.slow
def test_jax_tree_accuracy_2d_at_65k():
    """The JAX package's tree on the 2D disc at 65,601 particles (setup,
    hydro forces off), rms|da| / rms|a| at 2,048 sampled particles
    against the all-pairs sum (the port's direct_sph_gravity in float64:
    the JAX package's holds N^2 arrays): chip_smoke.py's 2D disc gates
    are set from this reading (7.31e-4).  About a minute."""
    from gandalf_tpu_torch.ops.sph_gravity import direct_sph_gravity as dsg

    p = disc_params(65536, 2)
    p.set("hydro_forces", 0)
    sim = GradhSphSimulation(p, device="cpu", dtype=torch.float64)
    sim.SetupSimulation()
    s = sim.state
    assert s.N == 65601
    jspec = jt.TreeSpec(**dataclasses.asdict(sim.treespec))
    f = {k: jnp.asarray(getattr(s, k).numpy())
         for k in ("r", "m", "h", "zeta", "hfactor")}
    a_t, _, ovf = jt.tree_gravity_grouped(
        jspec, jnp.asarray(s.bucket_map.numpy()), f["r"], f["m"], f["h"],
        jax_kernel("m4", 2), zh=f["zeta"] * f["hfactor"])
    assert not bool(ovf)
    idx = np.sort(np.random.default_rng(0).choice(s.N, 2048, replace=False))
    ref, _ = dsg(sim.kern, s.r, s.m, s.h, s.zeta, s.hfactor,
                 targets=torch.as_tensor(idx))
    da = np.asarray(a_t)[idx] - ref.numpy()
    rms = float(np.sqrt(np.sum(da * da) / np.sum(ref.numpy() ** 2)))
    print(f"gandalf_tpu tree at ndim 2, N = 65,601: rms|da| / rms|a| "
          f"{rms:.4e}")
    assert rms <= 1e-3
