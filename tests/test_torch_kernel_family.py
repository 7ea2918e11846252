"""Port parity: the quintic, gaussian and tabulated SPH kernels on the
grad-h grid and tree path against gandalf_tpu's (float64, CPU, plain
versions of K2, K3, K7, K8 and K9), and the refusals around them.

Every kernel function of the four variants the grid path runs (quintic,
gaussian, M4 and quintic tabulated) and of the tabulated gaussian, in
1-3 dims; the hydro pass in 1D (the Sod tube), 2D (the small KHI) and 3D
(a jittered periodic box); the tree's pass with the quintic and the
tabulated M4; one compacted block tick with the quintic; a few
GradhSphSimulation steps per variant (with tree gravity where the
kernel has softened gravity); the Sedov IC's h and u with the quintic.
Inputs are made with numpy from a seed.  Also the refusals: a non-M4
kernel wherever the port's kernels hold M4 only (MFV, N-body, sinks and
stars, dust, SM2012, cd2010) and the gaussian with self-gravity
(ROADMAP fault F23), which the JAX package runs with a tree that loses
the gravity of every pair in a support leaf (shown here), and the JAX
package's quintic gravity kernels' jump at the support's end (fault
F24, kept for parity).  The kernels against their plain versions on
the card: ``tests/test_torch_guards.py``, which imports no JAX."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import forces as jforces
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.ops import tree as jt
from gandalf_tpu.ops.eos import Adiabatic as JaxAdiabatic
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.ic import generate_ic as jax_generate_ic
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu.state import make_sph_state as jax_state
from gandalf_tpu_torch.check import (family_params, jittered_box_ic,
                                     khi_params, nbody_params, slice_params,
                                     sod_params, sphere_block_params)
from gandalf_tpu_torch.convert import (grid_spec_from_jax, state_from_numpy,
                                       tree_spec_from_jax)
from gandalf_tpu_torch.kernels.smoothing import VARIANTS, kernel_factory
from gandalf_tpu_torch.ops import forces as tforces
from gandalf_tpu_torch.ops import sph_grid27 as tg
from gandalf_tpu_torch.ops import tree as tt
from gandalf_tpu_torch.ops.eos import Adiabatic
from gandalf_tpu_torch.sim.ic import generate_ic
from gandalf_tpu_torch.sim.simulation import (GradhSphSimulation,
                                              SimulationBase)
from gandalf_tpu_torch.state import DomainBox
from test_torch_block_sim import repoint_pads

torch.set_num_threads(1)

TOL_FN = 1e-14
TOL = 1e-10
TOL_SIM = 1e-9
H_FAC, H_CONV = 1.2, 0.01

# the variants the grid path's tests run
GRID_VARIANTS = ("quintic", "gaussian", "m4_tab", "quintic_tab")


def _kernels(variant, ndim):
    name, tab = VARIANTS[variant]
    return kernel_factory(name, ndim, tab), jax_kernel(name, ndim, tab)


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kernel_functions_match_jax(variant, ndim):
    """Every function of s on [0, 3.5] (through the support's end and
    the gravity kernels' far forms) and of s^2, and the constants."""
    tk, jk = _kernels(variant, ndim)
    assert tk.variant == variant
    assert (tk.kernrange, tk.kernnorm, tk.kernnormdrag) == (
        jk.kernrange, jk.kernnorm, jk.kernnormdrag)
    s = np.linspace(0.0, 3.5, 3501)
    for fn, x in [(f, s) for f in ("w0", "w1", "womega", "wzeta", "wgrav",
                                   "wpot", "wdrag")] + [
            (f, s * s) for f in ("w0_s2", "womega_s2", "wzeta_s2")]:
        got = getattr(tk, fn)(torch.as_tensor(x)).numpy()
        want = np.asarray(getattr(jk, fn)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=TOL_FN, atol=TOL_FN,
                                   err_msg=f"{variant} {ndim}D {fn}")


# ---------------------------------------------------------------------------
# The hydro pass (K2, K3) in 1, 2 and 3 dims
# ---------------------------------------------------------------------------

CASES = {1: lambda: sod_params(128, 32), 2: lambda: khi_params(1),
         3: lambda: slice_params(6)}


def _case(ndim, kernrange, seed=3):
    """IC jittered by 0.1 spacings (numpy generator `seed`), the JAX and
    port boxes, and both grid plans at `kernrange`."""
    p = CASES[ndim]()
    ic = generate_ic(p, None)
    box = DomainBox.from_params(p)
    args = (box.ndim, box.boxmin, box.boxmax, box.lhs, box.rhs)
    rng = np.random.default_rng(seed)
    spacing = min(box.size) / (6.0 if ndim == 3 else 32.0)
    lo, size = np.asarray(box.boxmin), np.asarray(box.size)
    ic["r"] = lo + np.mod(ic["r"] + 0.1 * spacing
                          * rng.standard_normal(ic["r"].shape) - lo, size)
    ic["v"] = ic["v"] + 0.05 * rng.standard_normal(ic["v"].shape)
    h_max = float(ic["h"].max()) * 1.3
    jbox, tbox = JaxBox(*args), DomainBox(*args)
    return (ic, jbox, tbox, jg.plan_grid27(jbox, ic["r"], h_max, kernrange),
            tg.plan_grid27(tbox, ic["r"], h_max, kernrange))


def _err(got, want, relative):
    got, want = np.asarray(got), np.asarray(want)
    if relative:
        return np.max(np.abs(got - want) / np.abs(want))
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("variant", GRID_VARIANTS)
def test_hydro_pass_matches_jax(variant, ndim):
    """hydro_pass_grid27 (K1-K3's plain versions and the torch glue) with
    mm97 viscosity and Wadsley conductivity, from one state."""
    tk, jk = _kernels(variant, ndim)
    ic, jbox, tbox, jspec, tspec = _case(ndim, tk.kernrange)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    js = jax_state(ic["r"], ic["v"], ic["m"], ic["h"], ic["u"])
    alpha = np.random.default_rng(2).uniform(0.1, 1.0, len(ic["m"]))
    js = js.replace(alpha=jnp.asarray(alpha))
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js)
              if getattr(js, f.name) is not None}
    ts = state_from_numpy(fields, dtype=torch.float64)
    kw = dict(alpha_visc=1.0, alpha_visc_min=0.1, beta_visc=2.0)
    jvisc = jforces.ArtificialViscosity(
        avisc=jforces._AVISC_CODES["mon97mm97"],
        acond=jforces._ACOND_CODES["wadsley2008"], **kw)
    tvisc = tforces.ArtificialViscosity(
        avisc=tforces._AVISC_CODES["mon97mm97"],
        acond=tforces._ACOND_CODES["wadsley2008"], **kw)
    args = (H_FAC, H_CONV, True)
    jout = jg.hydro_pass_grid27(jk, jvisc, jbox, jspec,
                                JaxAdiabatic(gamma=1.4), *args, js)
    tout = tg.hydro_pass_grid27(tk, tvisc, tbox, tspec,
                                Adiabatic(gamma=1.4), *args, ts)
    for field in ("h", "rho", "invomega", "hfactor", "u", "pressure",
                  "sound"):
        assert _err(getattr(tout, field).numpy(), getattr(jout, field),
                    True) <= TOL, field
    for field in ("a", "dudt", "div_v") + (
            () if variant.startswith("gaussian") else ("zeta",)):
        assert _err(getattr(tout, field).numpy(), getattr(jout, field),
                    False) <= TOL, field
    if variant.startswith("gaussian"):      # its wzeta is zero
        assert not tout.zeta.any() and not np.asarray(jout.zeta).any()
    assert bool(tout.neib_overflow) == bool(jout.neib_overflow) is False


# ---------------------------------------------------------------------------
# The tree (K4-K7) with the quintic and the tabulated M4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["quintic", "m4_tab"])
def test_tree_gravity_matches_jax(variant):
    """tree_gravity_grouped on a jittered 16^3 box with h from 1 to 1.5
    lattice spacings and the zeta term, particle order in and out; the
    support tier holds (3/2)^3 times as many pairs as with M4."""
    tk, jk = _kernels(variant, 3)
    ic = jittered_box_ic(slice_params(16, self_gravity=1), 16)
    rng = np.random.default_rng(3)
    N = len(ic["m"])
    h = ic["h"] * (1.0 + 0.5 * rng.random(N))
    zh = -0.5 * rng.random(N) / h ** 4
    gmap = jt.plan_buckets_kd(ic["r"], 32)
    jspec = jt.plan_tree_for_buckets(gmap, 0.1)
    # room for every near leaf in the support tier: at kernrange 3 it
    # holds about 3.4 times M4's leaves
    jspec = dataclasses.replace(jspec, support_cap=jspec.near_cap)
    spec = tree_spec_from_jax(jspec)
    pext = [1.0, 1.0, 1.0]
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    a, gpot, ovf = tt.tree_gravity_grouped(
        spec, t(gmap), t(ic["r"]), t(ic["m"]), t(h), tk, t(zh), pext)
    ja, jgp, jovf = jt.tree_gravity_grouped(
        jspec, jnp.asarray(gmap), jnp.asarray(ic["r"]), jnp.asarray(ic["m"]),
        jnp.asarray(h), jk, zh=jnp.asarray(zh), periodic_extent=pext)
    assert bool(ovf) == bool(jovf) is False
    assert _err(a.numpy(), ja, False) <= TOL
    assert _err(gpot.numpy(), jgp, False) <= TOL


# ---------------------------------------------------------------------------
# The controller: steps per variant, one compacted block tick
# ---------------------------------------------------------------------------

def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _assert_same(jsim, tsim, fields, where):
    for f in fields:
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0)
        assert err <= TOL_SIM, f"{where}: {f} differs by {err:.3e} of max"
    for f in ("t", "dt"):
        want = float(getattr(jsim.state, f))
        got = float(getattr(tsim.state, f))
        assert abs(got - want) <= TOL_SIM * abs(want), f"{where}: {f}"


# tree gravity where the kernel has softened gravity (not the gaussian)
STEP_CASES = {"quintic": 1, "gaussian": 0, "m4_tab": 1, "quintic_tab": 0}


@pytest.mark.parametrize("variant", list(STEP_CASES))
def test_steps_match_jax(variant):
    """Two global steps of the jittered 6^3 box (the bench
    configuration) through both GradhSphSimulations, from one staged
    IC, with the quintic and the tabulated M4 also self-gravitating."""
    grav = STEP_CASES[variant]

    def params():
        return family_params(variant,
                             slice_params(6, 1.0, self_gravity=grav))

    ic = jittered_box_ic(params(), 6)
    jsim = JaxSim(_jax_params(params()))
    jsim.restart_data = {k: v.copy() for k, v in ic.items()}
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(params(), device="cpu", dtype=torch.float64)
    tsim.SetupSimulation({k: v.copy() for k, v in ic.items()})
    assert tsim.kern.variant == variant
    assert grid_spec_from_jax(jsim.gridspec) == tsim.gridspec
    fields = ("r", "v", "u", "h", "rho") + (("gpot",) if grav else ())
    _assert_same(jsim, tsim, fields, "bootstrap")
    for i in range(2):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _assert_same(jsim, tsim, fields, f"step {i + 1}")
    if grav:
        assert tree_spec_from_jax(jsim.treespec) == tsim.treespec


def test_block_tick_matches_jax():
    """The cold sphere (about 300 particles, Nlevels 4, tree gravity)
    with the quintic: the bootstrap and one compacted tick (K8, K9 and
    the group-list K6/K7 plain versions) through both controllers."""
    def params():
        return family_params("quintic", sphere_block_params(300, tend=1.0))

    ic = generate_ic(params(), None)
    ic = {k: ic[k] for k in ("r", "v", "m", "h", "u")}
    jsim = JaxSim(_jax_params(params()))
    jsim.restart_data = {k: v.copy() for k, v in ic.items()}
    # the pads point outside the list, not at particle 0 (fault F7)
    repoint_pads(jsim)
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(params(), device="cpu", dtype=torch.float64)
    tsim.SetupSimulation({k: v.copy() for k, v in ic.items()})
    assert tsim.use_block and tsim.kern.variant == "quintic"
    fields = ("r", "v", "u", "h", "rho", "gpot")
    _assert_same(jsim, tsim, fields, "bootstrap")
    jsim.main_loop_step()
    tsim.main_loop_step()
    _assert_same(jsim, tsim, fields, "tick 1")
    np.testing.assert_array_equal(tsim.state.level.numpy(),
                                  np.asarray(jsim.state.level))
    assert 0 < tsim.active_rows


def test_sedov_ic_with_quintic_matches_jax():
    """The Sedov IC's kernel-shaped hot region (sim/ic.py) with the
    quintic: h and u as the JAX package's generator makes them."""
    p = sod_params(64, 16)
    p.set("ic", "sedov")
    p.set("ndim", 2)
    for k, v in (("Nlattice1[0]", 16), ("Nlattice1[1]", 16),
                 ("boxmin[1]", 0.0), ("boxmax[1]", 1.0),
                 ("boxmin[0]", 0.0), ("boxmax[0]", 1.0)):
        p.set(k, v)
    p.set("kernel", "quintic")
    p.set("smooth_ic", 1)
    want = jax_generate_ic(_jax_params(p), None)
    got = generate_ic(p, None)
    for f in ("r", "m", "h", "u"):
        np.testing.assert_allclose(got[f], np.asarray(want[f]), rtol=1e-14,
                                   atol=0.0, err_msg=f)
    assert np.ptp(got["u"]) > 0.0


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def _refused(p, match, setup_ic=None):
    sim = SimulationBase.factory(p, "cpu", torch.float64)
    with pytest.raises(NotImplementedError, match=match):
        if setup_ic is None:
            sim.process_parameters()
        else:
            sim.SetupSimulation(setup_ic)
    return sim


@pytest.mark.parametrize("variant", ["gaussian", "gaussian_tab"])
def test_gaussian_with_self_gravity_refused_f23(variant):
    _refused(family_params(variant, slice_params(6, self_gravity=1)),
             "F23")


def _mfv():
    from gandalf_tpu_torch.check import mfv_params
    return mfv_params(6, self_gravity=0)


def _sm2012():
    from gandalf_tpu_torch.check import sm2012_params
    return sm2012_params(slice_params(6))


def _sinks():
    p = slice_params(6)
    p.set("sink_particles", 1)
    return p


def _dust():
    from gandalf_tpu_torch.check import dustybox_params
    return dustybox_params(16, 1)


def _cd2010():
    p = slice_params(6)
    p.set("time_dependent_avisc", "cd2010")
    return p


REFUSED = {"mfv": _mfv, "nbody": lambda: nbody_params(16),
           "sinks": _sinks, "dust": _dust, "sm2012": _sm2012,
           "cd2010": _cd2010}


@pytest.mark.parametrize("variant", ["quintic", "m4_tab", "gaussian"])
@pytest.mark.parametrize("case", list(REFUSED))
def test_non_m4_kernels_refused_where_kernels_hold_m4(case, variant):
    """A kernel other than the direct M4 in every controller that once
    held M4 only: N-body (K14), sinks and stars (K14, K16, K20), the
    meshless finite-volume kernels, the Cullen & Dehnen switch (K21), the
    gas-dust drag (K23, K24) and SM2012 (K25, K26) take the whole family:
    the controller sets up and steps with the variant.  The gaussian's
    softened gravity is zero in the JAX package, so N-body softening and
    sinks refuse it before setup, naming fault F23."""
    p = family_params(variant, REFUSED[case]())
    if variant == "gaussian" and case in ("nbody", "sinks"):
        _refused(p, "F23")
        return
    sim = SimulationBase.factory(p, "cpu", torch.float64)
    sim.SetupSimulation()
    sim.main_loop_step()
    assert sim.kern.variant == variant
    if case == "mfv":
        assert torch.isfinite(sim.state.Qcons0).all()
    elif case == "nbody":
        s = sim.state
        for f in ("r", "v", "a", "adot", "gpot"):
            assert torch.isfinite(getattr(s, f)).all(), f
        assert sim.Nsteps == 1
    else:
        s = sim.state
        for f in ("r", "v", "u", "h", "rho", "alpha"):
            assert torch.isfinite(getattr(s, f)).all(), f
        assert sim.Nsteps == 1


@pytest.mark.parametrize("variant", ["quintic", "gaussian"])
def test_stars_in_the_ic_refused_with_quintic(variant):
    """Stars handed in with the IC (the hybrid Plummer route) take the
    sink kernels: with the quintic the run sets up and steps (at 256 gas
    particles: fewer leave the quintic's h pinned at a clamp); the
    gaussian, whose softened gravity is zero (fault F23), is refused at
    setup, before any pass."""
    from gandalf_tpu_torch.check import plummer_stars_params
    p = family_params(variant, plummer_stars_params(256, 2))
    p.set("sink_particles", 0)
    p.set("create_sinks", 0)
    ic = generate_ic(p, None)
    assert "star" in ic
    if variant == "gaussian":
        sim = _refused(p, "F23", ic)
        assert sim.state is None
        return
    sim = SimulationBase.factory(p, "cpu", torch.float64)
    sim.SetupSimulation(ic)
    sim.main_loop_step()
    assert sim.kern.variant == "quintic"
    s = sim.state
    assert int(s.sinks.active.sum()) == 2
    for f in ("r", "v", "u", "h", "rho"):
        assert torch.isfinite(getattr(s, f)).all(), f
    assert torch.isfinite(s.sinks.a[s.sinks.active]).all()


def test_jax_gaussian_tree_loses_support_gravity_f23():
    """ROADMAP fault F23 on the JAX package: its gaussian wgrav and wpot
    are zero, so the tree's support tier subtracts the Newtonian term of
    every pair in a support leaf and adds nothing back.  On a small cloud
    (256 particles, 8 buckets, h = 0.01, far below the spacing, so the
    softening itself changes almost nothing) the tree misses the
    all-pairs Newtonian sum by O(1), where the quintic's and M4's agree
    with it to rounding."""
    rng = np.random.default_rng(7)
    N = 256
    r = rng.standard_normal((N, 3))
    m = np.full(N, 1.0 / N)
    h = np.full(N, 0.01)
    gmap = jt.plan_buckets_kd(r, 32)
    jspec = jt.plan_tree_for_buckets(gmap, 0.1)
    jspec = dataclasses.replace(jspec, support_cap=jspec.near_cap)
    d = r[None, :, :] - r[:, None, :]
    d2 = np.sum(d * d, -1)
    np.fill_diagonal(d2, np.inf)
    a_newton = np.sum(m[None, :, None] * d / d2[..., None] ** 1.5, 1)

    def rel(name):
        a, _, ovf = jt.tree_gravity_grouped(
            jspec, jnp.asarray(gmap), jnp.asarray(r), jnp.asarray(m),
            jnp.asarray(h), jax_kernel(name, 3), zh=jnp.zeros(N))
        assert not bool(ovf)
        da = np.asarray(a) - a_newton
        return np.sqrt(np.sum(da * da) / np.sum(a_newton * a_newton))

    assert rel("gaussian") > 0.5
    assert rel("quintic") < 1e-10
    assert rel("m4") < 1e-10


def test_jax_quintic_gravity_jumps_at_support_f24():
    """ROADMAP fault F24 on the JAX package: its quintic gravity kernels
    carry the factor c = 12/359 (gandalf_tpu/kernels/smoothing.py:273),
    so inside the support they are 360/359 of what joins the Newtonian
    far forms: wpot and wgrav jump by 1/359 of 1/s and 1/s^2 at s = 3,
    where M4's join to rounding; and its wzeta is -(359/12) times
    d(s wpot)/ds, the h-derivative of the softened potential that M4's
    wzeta equals.  The port keeps the JAX values."""
    for name, jump in (("quintic", 1.0 / 359.0), ("m4", 0.0)):
        jk = jax_kernel(name, 3)
        r = 2.0 if name == "m4" else 3.0
        s = jnp.asarray([r - 1e-12, r])
        pot, grav = np.asarray(jk.wpot(s)), np.asarray(jk.wgrav(s))
        assert abs(pot[0] * r - 1.0 - jump) < 1e-9, (name, pot)
        assert abs(grav[0] * r * r - 1.0 - jump) < 1e-9, (name, grav)
        tk = kernel_factory(name, 3)
        np.testing.assert_allclose(
            tk.wpot(torch.tensor(np.asarray(s))).numpy(), pot, rtol=TOL_FN)
        # wzeta against d(s wpot)/ds (a central difference) inside
        x = np.linspace(0.1, r - 0.1, 57)
        x = x[np.abs(x - np.round(x)) > 0.01]       # off the breakpoints
        e = 1e-6
        spot = lambda y: y * np.asarray(jk.wpot(jnp.asarray(y)))  # noqa
        deriv = (spot(x + e) - spot(x - e)) / (2.0 * e)
        zeta = np.asarray(jk.wzeta(jnp.asarray(x)))
        want = -359.0 / 12.0 if name == "quintic" else 1.0
        np.testing.assert_allclose(zeta, want * deriv,
                                   atol=1e-6 * np.max(np.abs(zeta)))
