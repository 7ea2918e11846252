"""Port parity: the sink and star operators below 3D against
gandalf_tpu/ops/sinks.py, ops/sph_gravity.py and ops/gravity.py,
float64 on the CPU.

At ndim 1 and 2, on check.sink_kernel_inputs' edge cases (dead gas,
empty slots, gas on a star and on the empty slots' position, gas exactly
at a star's accretion radius, gas at equal distance from two stars,
tied densest particles) with 16 and 64 slots: the plain versions of K16
(star_gas_forces), K17 (sink_candidate, with create_sinks' slots), K18
(accretion_sums, with apply_accretion), K20's two launches
(smooth_accretion_sums and apply_smooth_accretion, on
check.smooth_accretion_inputs: gas going whole and in part; the spin
(0, 0, z) in 2D and exactly zero in 1D) and K14 in 1D
(direct_softened, with the jerk).  Sums within 1e-12 of each output's
largest value; claims, slots, indices and eaten masks exactly.

Also fault F30: a tree leaf with one live particle whose centre of mass
sum(m x) / m rounds an ulp off x, outside the leaf's zero-width box.
The JAX package's walk then takes the group's own leaf as a far cell at
~1e-17 and returns a potential of ~1e13; the port clamps each COM into
its box and agrees with the all-pairs sum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import gravity as jgr
from gandalf_tpu.ops import sinks as js
from gandalf_tpu.ops import sph_gravity as jsg
from gandalf_tpu.ops import tree as jt
from gandalf_tpu_torch.check import (sink_kernel_inputs, smooth_args,
                                     smooth_accretion_inputs)
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import gravity as tgr
from gandalf_tpu_torch.ops import sinks as ts
from gandalf_tpu_torch.ops import sph_gravity as tsg
from gandalf_tpu_torch.ops import tree as tt
from gandalf_tpu_torch.ops.sph_gravity import direct_sph_gravity

torch.set_num_threads(1)

TOL = 1e-12
N_GAS = 1024
CASES = [(nd, ns) for nd in (1, 2) for ns in (16, 64)]


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
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


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}d-{c[1]}")
def case(request):
    ndim, n_slots = request.param
    return ndim, sink_kernel_inputs(N_GAS, n_slots, "cpu", torch.float64,
                                    ndim=ndim)


def test_inputs_hold_the_edge_cases(case):
    """The edge cases at this ndim: gas 2 at star 1's accretion radius
    exactly, gas 4 at equal distance from stars 2 and 3, gas 0 on star
    0, gas 5 on the empty slots, the slot tables (Ns, ndim)."""
    ndim, inp = case
    st, r = inp["sinks"], inp["r"]
    assert r.shape == (N_GAS, ndim) and st.r.shape == (st.N, ndim)
    racc = inp["cfg"].sink_radius * st.h
    assert float(torch.linalg.norm(r[2] - st.r[1])) == float(racc[1])
    assert float(torch.linalg.norm(r[4] - st.r[2])) == float(
        torch.linalg.norm(r[4] - st.r[3]))
    assert torch.equal(r[0], st.r[0])
    assert torch.equal(r[5], st.r[-1]) and not bool(st.active[-1])
    assert st.angmom.shape == (st.N, 3)


def test_star_gas_forces_match_jax(case):
    """K16 plain: both sides, dead gas massless, inactive slots pulling
    no gas, a pair on a star and on the empty slots."""
    ndim, inp = case
    st, alive = inp["sinks"], inp["alive"]
    m_live = torch.where(alive, inp["m"], 0.0)
    m_star = torch.where(st.active, st.m, 0.0)
    args = (inp["r"], m_live, inp["h"], st.r, m_star, st.h, st.active)
    got = tsg.star_gas_forces(kernel_factory("m4", ndim), *args)
    want = jax.jit(lambda *a: jsg.star_gas_forces(jax_kernel("m4", ndim),
                                                  *a))(*map(_j, args))
    for name, g, w in zip(("a_gas", "gpot_gas", "a_star", "gpot_star"),
                          got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= TOL, name
    assert got[0].shape == (N_GAS, ndim)


def test_sink_candidate_and_creation_match_jax(case):
    """K17 plain: the packed row (2 ndim + 3 wide) and index of the
    densest alive particle (3 and 7 tie: 3; 1 is denser but dead), no
    eligible particle (index 0, score -inf), and create_sinks' slots and
    alive mask."""
    ndim, inp = case
    cfg = inp["cfg"]
    targs = [inp[k] for k in ("r", "v", "m", "h", "rho")]
    cand, gi = ts.sink_candidate(cfg, *targs, inp["alive"])
    jargs = [_j(x) for x in targs]
    jcand, jgi = js.sink_candidate(_jcfg(cfg), *jargs, _j(inp["alive"]))
    assert cand.shape == (2 * ndim + 3,)
    assert int(gi) == int(jgi) == 3
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    none = dataclasses.replace(cfg, rho_sink=float("inf"))
    cand_n, gi_n = ts.sink_candidate(none, *targs, inp["alive"])
    assert int(gi_n) == 0 and float(cand_n[-1]) == -np.inf
    # creation into the first free slot
    new, alive = ts.create_sinks(cfg, inp["sinks"], *targs, inp["alive"])
    jnew, jalive = js.create_sinks(_jcfg(cfg), _jax_sinks(inp["sinks"]),
                                   *jargs, None, _j(inp["alive"]))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
    for f in ("r", "v", "a", "r0", "v0", "a0", "m", "h", "active"):
        np.testing.assert_array_equal(getattr(new, f).numpy(),
                                      np.asarray(getattr(jnew, f)), f)


def test_accretion_sums_match_jax(case):
    """K18 plain: per-slot dm, dmom, dmr (Ns, ndim) within 1e-12 and the
    eaten mask exactly (gas 2 at star 1's r_acc is not star 1's, gas 4
    is eaten, the dead are not); then apply_accretion."""
    ndim, inp = case
    cfg, st = inp["cfg"], inp["sinks"]
    args = (inp["r"], inp["v"], inp["m"], inp["alive"])
    dm, dmom, dmr, eaten = ts.accretion_sums(cfg, st, *args)
    want = js.accretion_sums(_jcfg(cfg), _jax_sinks(st), *map(_j, args))
    np.testing.assert_array_equal(eaten.numpy(), np.asarray(want[3]))
    for name, g, w in zip(("dm", "dmom", "dmr"), (dm, dmom, dmr), want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= TOL, name
    e = eaten.numpy()
    assert e[4] and not e[~inp["alive"].numpy()].any()
    assert e.sum() > 1
    # gas 2 lies on star 1's radius: eaten only if another star holds it
    d2 = torch.linalg.norm(st.r - inp["r"][2], dim=1)
    inside = (d2 < cfg.sink_radius * st.h) & st.active
    assert not bool(inside[1]) and e[2] == bool(inside.any())
    new = ts.apply_accretion(st, dm, dmom, dmr)
    jnew = js.apply_accretion(_jax_sinks(st), *want[:3])
    for f in ("r", "v", "r0", "v0", "m"):
        assert _rel(getattr(new, f), getattr(jnew, f)) <= TOL, f


@pytest.mark.parametrize("n_slots", [16, 64])
@pytest.mark.parametrize("ndim", [1, 2])
def test_smooth_accretion_matches_jax(ndim, n_slots):
    """K20 plain, both launches: claims exactly, dm and the per-slot
    sums within 1e-12 (W normalised in ndim), gas going whole and in
    part; the sink update's r, v, r0, v0 (Ns, ndim), m and angmom (Ns,
    3): (0, 0, z) in 2D, exactly zero in 1D, as the JAX package's
    clamped index gives."""
    inp = smooth_accretion_inputs(N_GAS, n_slots, "cpu", torch.float64,
                                  ndim=ndim)
    kern = kernel_factory("m4", ndim)
    cfg, st = inp["cfg"], inp["sinks"]
    dm, sums = ts.smooth_accretion_sums(*smooth_args(kern, inp))
    jkern = jax_kernel("m4", ndim)

    @jax.jit
    def jax_sums(sinks, r, v, m, rho, sound, alive, dt):
        return js.smooth_accretion_sums(
            _jcfg(cfg), sinks, r, v, m, rho, sound, m, alive, dt, jkern,
            inp["mmean"], alpha_ss=inp["alpha_ss"])

    J = lambda k: _j(inp[k])  # noqa: E731
    jdm, jsums = jax_sums(_jax_sinks(st), J("r"), J("v"), J("m"), J("rho"),
                          J("sound"), J("alive"), J("dt"))
    jclaim = np.asarray(jsums["claim"])
    claim = sums["claim"].numpy()
    np.testing.assert_array_equal(
        claim, np.where(jclaim.any(1), jclaim.argmax(1), -1))
    assert _rel(dm, jdm) <= TOL
    for k in ("menc", "macc", "taccrete", "dmdt"):
        assert _rel(sums[k], jsums[k]) <= TOL, k
    m = inp["m"].numpy()
    got = claim >= 0
    # gas 4 is as far from star 2 as from star 3: the lower slot takes it
    # unless a wider star (h 0.04) holds it nearer
    d4 = torch.linalg.norm(st.r - inp["r"][4], dim=1)
    nearer = (d4 < d4[2]) & (d4 < cfg.sink_radius * st.h) & st.active
    assert claim[4] == (int(torch.argmax(torch.where(nearer, -d4, -1e30)))
                        if bool(nearer.any()) else 2)
    assert int((dm.numpy()[got] == m[got]).sum()) > 0
    assert int(((dm.numpy() > 0) & (dm.numpy() < m)).sum()) > 0
    new, m_gas, alive_new = ts.apply_smooth_accretion(
        st, inp["r"], inp["v"], inp["m"], dm, sums["claim"], inp["alive"])
    jnew, jm, jalive = jax.jit(js.apply_smooth_accretion)(
        _jax_sinks(st), J("r"), J("v"), J("m"), jdm, jsums["claim"],
        J("alive"))
    for f in ("r", "v", "r0", "v0", "m", "angmom"):
        assert getattr(new, f).shape == getattr(jnew, f).shape, f
        assert _rel(getattr(new, f), getattr(jnew, f)) <= TOL, f
    assert _rel(m_gas, jm) <= TOL
    np.testing.assert_array_equal(alive_new.numpy(), np.asarray(jalive))
    spin = new.angmom.numpy()
    assert not spin[:, :2].any()
    if ndim == 2:
        assert np.abs(spin[:, 2]).max() > 0
    else:
        assert not spin.any() and not np.asarray(jnew.angmom).any()


def test_direct_softened_1d_matches_jax():
    """K14 plain in 1D, with and without the jerk, on the slots of
    sink_kernel_inputs (a star pair at 1/32 apart, softened)."""
    inp = sink_kernel_inputs(64, 16, "cpu", torch.float64, ndim=1)
    st = inp["sinks"]
    n = int(st.active.sum())
    r, v, m, h = st.r[:n], st.v[:n], st.m[:n], st.h[:n]
    for jerk in (True, False):
        got = tgr.direct_softened(r, v, m, h, kernel_factory("m4", 1), jerk)
        want = jgr.direct_softened(_j(r), _j(v), _j(m), _j(h),
                                   jax_kernel("m4", 1), jerk)
        for f in ("a", "adot", "gpot"):
            if f == "adot" and not jerk:
                assert not bool(got.adot.any())
                continue
            assert _rel(getattr(got, f), getattr(want, f)) <= TOL, (f, jerk)


def _lone_particle_tree():
    """A 2D set of 2 buckets of 32: bucket 0 with one live particle
    whose sum(m y) / m rounds an ulp off y (the rest dead), bucket 1 with
    32 live ones a unit away."""
    m0, y0 = 0.0026041666666666665, 0.387207607105763
    assert (m0 * y0) / m0 != y0
    rng = np.random.default_rng(3)
    r = np.concatenate([np.array([[0.4781051781502588, y0]]),
                        0.4 + 0.2 * rng.random((31, 2)),
                        1.5 + 0.2 * rng.random((32, 2))])
    m = np.full(64, m0)
    h = np.full(64, 0.1)
    alive = np.ones(64, bool)
    alive[1:32] = False
    m[~alive] = 0.0
    gmap = np.arange(64, dtype=np.int32).reshape(2, 32)
    return r, m, h, alive, gmap


def test_lone_particle_leaf_fault_f30():
    """F30 on the JAX package: the lone particle's own leaf is taken as a
    far cell and its potential is ~1e13; the port's clamped COM keeps it
    near, and both the potential and the acceleration agree with the
    all-pairs sum."""
    r, m, h, alive, gmap = _lone_particle_tree()
    spec = tt.plan_tree(64)
    spec = dataclasses.replace(spec, theta_sqd=0.1)
    assert spec.n_leaves == 2 and spec.leaf_size == 32
    jspec = jt.TreeSpec(**dataclasses.asdict(spec))
    _, jgpot, _ = jt.tree_gravity_grouped(
        jspec, jnp.asarray(gmap), jnp.asarray(r), jnp.asarray(m),
        alive=jnp.asarray(alive))
    assert float(jgpot[0]) > 1e12
    t = torch.tensor
    a, gpot, ovf = tt.tree_gravity_grouped(
        spec, t(gmap), t(r), t(m), alive=t(alive))
    assert not bool(ovf)
    live = t(alive)
    a_ref, p_ref = direct_sph_gravity(None, t(r)[live], t(m)[live])
    assert abs(float(gpot[0]) - float(p_ref[0])) <= 1e-3 * float(p_ref[0])
    assert float(torch.abs(a[0] - a_ref[0]).max()) \
        <= 1e-3 * float(torch.abs(a_ref[0]).max())
