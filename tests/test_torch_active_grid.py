"""Port parity: the active-subset hydro pass (plain K8 and K9) and the
active-group tree walk (K4, K5, then K6 and K7 over a group list) against
gandalf_tpu's active_hydro_pass and tree_gravity_active (float64, CPU).

States: a small sphere in an open box (the cold_sphere_block
configuration at about 500 particles) and the 8^3 periodic box, each
after the port's bootstrap, with positions nudged and levels scattered
by a numpy seed so that h must iterate and levelneib must rise.  Each
goes through both packages for a random quarter of the particles and
for all of them, with hydro forces on and off.  make_case and
check_active_pass also build and check the 1D and 2D states
(tests/test_torch_block_dims.py: the block Sod tube and the small
KHI).  Also records the JAX
package's tree accuracy on the block configuration's sphere at 4224
particles, which chip_smoke.py's block accuracy gate refers to."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import forces as jforces
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.ops import tree as jtree
from gandalf_tpu.ops.active_grid import active_hydro_pass as jax_pass
from gandalf_tpu.ops.eos import Adiabatic as JaxAdiabatic
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu.state import make_sph_state as jax_state
from gandalf_tpu_torch.check import (block_sod_params, jittered_box_ic,
                                     khi_params, slice_params,
                                     sphere_block_params)
from gandalf_tpu_torch.convert import grid_spec_from_jax
from gandalf_tpu_torch.ops.active_grid import active_hydro_pass
from gandalf_tpu_torch.ops.sph_gravity import direct_sph_gravity
from gandalf_tpu_torch.ops.tree import tree_gravity_active
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation
from test_torch_block_sim import _unlisted_pads

torch.set_num_threads(1)

TOL = 1e-10
FIELDS = ("h", "rho", "invomega", "zeta", "hfactor", "u", "pressure",
          "sound", "a", "dudt", "div_v")


def _sim(kind):
    """The port's simulation after its (block) bootstrap, float64: the
    sphere, the 8^3 box, the block Sod tube (1D, 320 particles) or the
    small KHI (2D, 1,664)."""
    ic = None
    if kind == "sphere":
        p = sphere_block_params(500)
    elif kind == "box":
        p = slice_params(8)
        p.set("Nlevels", 4)
        ic = jittered_box_ic(p, 8)
    elif kind == "tube":
        p = block_sod_params(4)
    else:
        p = khi_params(1, nlevels=3)
    sim = GradhSphSimulation(p, device="cpu", dtype=torch.float64)
    sim.SetupSimulation(ic)
    return sim


def make_case(kind):
    """(port simulation, nudged port state, JAX state, JAX grid spec,
    JAX kernel, viscosity, EOS) of state `kind` (_sim)."""
    sim = _sim(kind)
    s = sim.state
    rng = np.random.default_rng(7)
    N, nd = s.N, s.ndim
    r = s.r + torch.tensor(0.05 * rng.standard_normal((N, nd))) * s.h[:, None]
    s = s.replace(r=sim.box.wrap(r), level=torch.tensor(
        rng.integers(0, 4, N).astype(np.int32)))
    s = s.replace(levelneib=s.level.clone())
    fields = {f.name: jnp.asarray(getattr(s, f.name).numpy())
              for f in dataclasses.fields(s)
              if getattr(s, f.name) is not None}
    js = dataclasses.replace(jax_state(*(np.asarray(fields[k]) for k in
                                         ("r", "v", "m", "h", "u"))),
                             **fields)
    box = sim.box
    jbox = JaxBox(box.ndim, box.boxmin, box.boxmax, box.lhs, box.rhs)
    jspec = jg.plan_grid27(jbox, s.r.numpy(), float(s.h.max()) * 1.3, 2.0)
    tspec = grid_spec_from_jax(jspec)
    v = sim.visc
    jvisc = jforces.ArtificialViscosity(v.avisc, v.acond, v.alpha_visc,
                                        v.alpha_visc_min, v.beta_visc)
    return dict(kind=kind, sim=sim, s=s, js=js, jspec=jspec, tspec=tspec,
                jkern=jax_kernel("m4", nd, 0), jvisc=jvisc,
                jeos=JaxAdiabatic(gamma=sim.eos.gamma), rng=rng)


@pytest.fixture(scope="module", params=["sphere", "box"])
def case(request):
    return make_case(request.param)


def _subset(c, which):
    N = c["s"].N
    if which == "all":
        return np.arange(N, dtype=np.int32)
    rng = np.random.default_rng(11)
    return np.sort(rng.choice(N, N // 4, replace=False)).astype(np.int32)


def check_active_pass(c, which, hydro):
    """The active pass (plain K8, K9) of the particles `which` through
    both packages on case c: every field within TOL of its largest value,
    levelneib and the overflow flag equal, only the listed rows changed
    and some neighbours' levels raised."""
    sim = c["sim"]
    idx = _subset(c, which)
    N = c["s"].N
    # the JAX pass takes the list padded to N rows (one compiled program
    # for both subsets), its pads outside the list (fault F7)
    val = np.arange(N) < len(idx)
    padded = _unlisted_pads(np.resize(idx, N), val, idx, N)
    key = ("jax_pass", hydro)
    if key not in c:
        c[key] = jax.jit(lambda s, i, v: jax_pass(
            c["jkern"], c["jvisc"], c["jspec"], c["jeos"], sim.h_fac,
            sim.h_converge, s, i, v, hydro_forces=hydro))
    js2, jovf = c[key](c["js"], jnp.asarray(padded), jnp.asarray(val))
    ts2, tovf = active_hydro_pass(sim.kern, sim.visc, c["tspec"], sim.eos,
                                  sim.h_fac, sim.h_converge, c["s"],
                                  torch.tensor(idx), hydro_forces=hydro)
    for f in FIELDS:
        want = np.asarray(getattr(js2, f))
        got = getattr(ts2, f).numpy()
        err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0)
        assert err <= TOL, (c["kind"], which, f, err)
    lneib = ts2.levelneib.numpy()
    np.testing.assert_array_equal(lneib, np.asarray(js2.levelneib))
    assert bool(tovf) == bool(jovf)
    # the pass changed only the listed rows, and raised some neighbours
    others = np.setdiff1d(np.arange(c["s"].N), idx)
    np.testing.assert_array_equal(ts2.h.numpy()[others],
                                  c["s"].h.numpy()[others])
    assert np.any(lneib != c["s"].levelneib.numpy())


@pytest.mark.parametrize("hydro", [True, False], ids=["hydro", "no_hydro"])
@pytest.mark.parametrize("which", ["quarter", "all"])
def test_active_hydro_pass_matches_jax(case, which, hydro):
    check_active_pass(case, which, hydro)


def test_tree_gravity_active_matches_jax():
    """K4 and K5 over all buckets, K6 and K7 over a random group list, on
    the sphere (open box): listed groups' rows within 1e-10 of max|a|,
    zero elsewhere, as in the JAX package."""
    sim = _sim("sphere")
    s = sim.state
    spec = sim.treespec
    G = spec.n_leaves
    gids = np.sort(np.random.default_rng(5).choice(G, G // 4,
                                                   replace=False))
    zh = s.zeta * s.hfactor
    a, gpot, ovf = tree_gravity_active(spec, s.bucket_map, s.r, s.m, s.h,
                                       sim.kern, zh,
                                       torch.tensor(gids, dtype=torch.int32))
    jspec = jtree.TreeSpec(**dataclasses.asdict(spec))
    ja, jgpot, jovf = jtree.tree_gravity_active(
        jspec, jnp.asarray(s.bucket_map.numpy()), jnp.asarray(s.r.numpy()),
        jnp.asarray(s.m.numpy()), jnp.asarray(s.h.numpy()),
        jax_kernel("m4", 3, 0), zh=jnp.asarray(zh.numpy()),
        group_ids=jnp.asarray(gids, jnp.int32))
    ja, jgpot = np.asarray(ja), np.asarray(jgpot)
    scale = np.max(np.abs(ja))
    assert scale > 0.0
    assert np.max(np.abs(a.numpy() - ja)) <= TOL * scale
    assert np.max(np.abs(gpot.numpy() - jgpot)) \
        <= TOL * np.max(np.abs(jgpot))
    assert bool(ovf) == bool(jovf) is False
    listed = np.zeros(s.N, bool)
    gmap = s.bucket_map.numpy()[gids].reshape(-1)
    listed[gmap[gmap >= 0]] = True
    assert 0 < listed.sum() < s.N
    assert not a.numpy()[~listed].any() and not gpot.numpy()[~listed].any()
    assert np.all(gpot.numpy()[listed] > 0.0)


def test_jax_tree_accuracy_on_a_larger_sphere():
    """The JAX package's tree against the direct sum on the
    cold_sphere_block bootstrap state at 4224 particles (132 buckets, so
    the MAC accepts far cells), quadrupole and monopole: the readings
    chip_smoke.py's block accuracy gate sits between."""
    sim = GradhSphSimulation(sphere_block_params(4000), device="cpu",
                             dtype=torch.float64)
    sim.SetupSimulation()
    s = sim.state
    ref, _ = direct_sph_gravity(sim.kern, s.r, s.m, s.h, s.zeta,
                                s.hfactor)
    ref = ref.numpy()
    gmap, zh = jnp.asarray(s.bucket_map.numpy()), s.zeta * s.hfactor
    err = {}
    for quad in (True, False):
        spec = dataclasses.replace(sim.treespec, quadrupole=quad)
        a, _, ovf = jtree.tree_gravity_grouped(
            jtree.TreeSpec(**dataclasses.asdict(spec)), gmap,
            *(jnp.asarray(x.numpy()) for x in (s.r, s.m, s.h)),
            jax_kernel("m4", 3, 0), zh=jnp.asarray(zh.numpy()))
        assert not bool(ovf)
        da = np.asarray(a) - ref
        err[quad] = float(np.sqrt(np.sum(da * da) / np.sum(ref * ref)))
    print(f"gandalf_tpu cold_sphere_block N={s.N} float64 bootstrap: "
          f"rms|da|/rms|a| quadrupole {err[True]:.3e}, monopole "
          f"{err[False]:.3e}")
    assert s.N == 4224
    assert err[True] <= 5e-4 < 1e-3 <= err[False]
