"""Port parity: the plain versions of the meshless finite-volume kernels
K10-K12 (gandalf_tpu_torch/ops/mfv_grid27.py) against gandalf_tpu's
density_mfv_grid27, gradients_mfv_grid27 and fluxes_mfv_grid27 on the
jittered 8^3 box, and K7's MFV zeta mode against tree_gravity_grouped
(..., zeta_scaling="mfv"), float64.

Each stage takes the JAX package's outputs of the stage before, so every
kernel is compared on the same inputs; results are compared in particle
order.  Tolerance 1e-10 of each output's largest value (only the order
of the sums differs; 1e-10 leaves room for the h iteration, where a
particle within rounding of the convergence test may take one more
step)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import mfv as jm
from gandalf_tpu.ops import mfv_grid27 as jmg
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.ops import tree as jt
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu_torch.check import jittered_box_ic, mfv_params
from gandalf_tpu_torch.convert import grid_spec_from_jax, tree_spec_from_jax
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import mfv as tm
from gandalf_tpu_torch.ops import mfv_grid27 as tmg
from gandalf_tpu_torch.ops import sph_grid27 as tg
from gandalf_tpu_torch.ops import tree as tt
from gandalf_tpu_torch.ops.active_grid import dense_ids

torch.set_num_threads(1)

TOL = 1e-10
H_FAC, H_CONV, GAMMA = 1.2, 0.01, 1.4


def _t(x):
    return torch.tensor(np.array(x))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if got.dtype == bool:
        assert np.array_equal(got, want)
        return
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)
    assert err <= tol, f"{err:.3e}"


@pytest.fixture(scope="module")
def box():
    """The 8^3 box: IC, the JAX grid plan and binning, the port's slot
    map, and the JAX package's density and gradient passes."""
    n = 8
    ic = jittered_box_ic(mfv_params(n), n)
    jbox = JaxBox(3, (0.0,) * 3, (1.0,) * 3, (1,) * 3, (1,) * 3)
    jspec = jg.plan_grid27(jbox, ic["r"], float(ic["h"].max()) * 1.3, 2.0)
    spec = grid_spec_from_jax(jspec)
    r = jnp.asarray(ic["r"])
    b = jg.bin_particles(jspec, r)
    fill = jg.dense_fill_mask(jspec, b)

    def d(x):
        return jg.to_dense(jspec, b, jnp.asarray(x))

    def back(x):
        return np.asarray(jg.from_dense(jspec, b, x))

    hmax = jg.hmax_of(jspec, 2.0)
    # an uneven h start, so that the iteration takes several steps
    h0 = ic["h"] * (1.0 + 0.6 * np.random.default_rng(1).random(len(r)))
    dens = jmg.density_mfv_grid27(jax_kernel("m4", 3), jspec, H_FAC, H_CONV,
                                  d(r), d(ic["m"]), d(h0), fill, hmax)
    rng = np.random.default_rng(2)
    u = ic["u"] * (1.0 + 0.2 * rng.random(len(r)))
    rho = back(dens.rho)
    W = np.concatenate([ic["v"], rho[:, None],
                        (GAMMA - 1.0) * (rho * u)[:, None]], -1)
    sound = np.sqrt(GAMMA * (GAMMA - 1.0) * u)
    fields = {"h": back(dens.h), "ndens": back(dens.ndens),
              "hfactor": back(dens.hfactor), "W": W, "sound": sound}
    grads = jmg.gradients_mfv_grid27(
        jax_kernel("m4", 3), jspec,
        {"r": d(r), "h": d(fields["h"]), "ndens": d(fields["ndens"]),
         "Wprim": d(W), "sound": d(sound)}, fill, limiter="gizmo")
    tb = tg.bin_particles(spec, _t(ic["r"]))
    return dict(ic=ic, h0=h0, jspec=jspec, spec=spec, b=b, fill=fill, d=d,
                back=back, hmax=hmax, dens=dens, fields=fields, grads=grads,
                ids_d=dense_ids(spec, tb), rng=rng)


def test_density_matches_jax(box):
    """K10 plain and its finish: h, ndens, rho, invomega, zeta, hfactor
    and the overflow flag."""
    ic = box["ic"]
    sums = tmg.density_sums(kernel_factory("m4", 3), box["spec"], H_FAC,
                            H_CONV, box["hmax"], box["ids_d"], _t(ic["r"]),
                            _t(ic["m"]), _t(box["h0"]))
    assert bool(sums[3].all())
    got = tmg.density_finish(H_FAC, box["hmax"], _t(ic["m"]), *sums)
    for f in ("h", "ndens", "rho", "invomega", "zeta", "hfactor"):
        _close(getattr(got, f), box["back"](getattr(box["dens"], f)))
    assert bool(got.overflow) == bool(box["dens"].overflow) is False


def test_density_overflow_matches_jax(box):
    """An hmax too small for the particles' h: both flag overflow."""
    ic, d = box["ic"], box["d"]
    hmax = 0.5 * float(ic["h"].min())
    jd = jmg.density_mfv_grid27(jax_kernel("m4", 3), box["jspec"], H_FAC,
                                H_CONV, d(ic["r"]), d(ic["m"]), d(ic["h"]),
                                box["fill"], hmax)
    sums = tmg.density_sums_plain(kernel_factory("m4", 3), box["spec"],
                                  H_FAC, H_CONV, hmax, box["ids_d"],
                                  _t(ic["r"]), _t(ic["m"]), _t(ic["h"]))
    got = tmg.density_finish(H_FAC, hmax, _t(ic["m"]), *sums)
    assert bool(got.overflow) == bool(jd.overflow) is True
    _close(got.h, box["back"](jd.h))


def _grad_packed(fl):
    return torch.cat([_t(fl["h"])[:, None], _t(fl["ndens"])[:, None],
                      _t(fl["W"]), _t(fl["sound"])[:, None]], -1)


def test_gradients_match_jax(box):
    """K11 plain: B, the gradients, the cell alphas, vsig_max and the
    bad-gradient flag."""
    got = tmg.gradients(kernel_factory("m4", 3), box["spec"], box["ids_d"],
                        _t(box["ic"]["r"]), _grad_packed(box["fields"]))
    want = box["grads"]
    for f in ("B", "grad", "alpha_slope", "vsig_max", "bad"):
        _close(getattr(got, f), box["back"](getattr(want, f)))


@pytest.mark.parametrize("zero_mass_flux", [True, False])
def test_fluxes_match_jax(box, zero_mass_flux):
    """K12 plain: dQdt and rdmdt_dot with the MUSCL half step over dt and
    a0, from the JAX package's gradients with a few bad-gradient
    fallbacks forced."""
    fl, g = box["fields"], box["grads"]
    back, d = box["back"], box["d"]
    N = len(fl["h"])
    a0 = 0.05 * box["rng"].standard_normal((N, 3))
    bad = back(g.bad).copy()
    bad[::7] = True
    B, grad, alpha = back(g.B), back(g.grad), back(g.alpha_slope)
    dt = 2e-3
    jcfg = jm.MfvConfig(gamma=GAMMA, zero_mass_flux=zero_mass_flux)
    want = jmg.fluxes_mfv_grid27(
        jax_kernel("m4", 3), jcfg, box["jspec"], jnp.asarray(dt),
        {"r": d(box["ic"]["r"]), "h": d(fl["h"]), "ndens": d(fl["ndens"]),
         "hfactor": d(fl["hfactor"]), "Wprim": d(fl["W"]),
         "sound": d(fl["sound"]), "a0": d(a0), "B": d(B), "grad": d(grad),
         "alpha_slope": d(alpha), "bad": d(bad.astype(np.float64))},
        box["fill"])
    packed = tmg.pack_flux_fields(*map(_t, (fl["h"], fl["ndens"], fl["W"],
                                            fl["sound"], a0, B, grad, alpha,
                                            bad)))
    got = tmg.fluxes(kernel_factory("m4", 3),
                     tm.MfvConfig(gamma=GAMMA, zero_mass_flux=zero_mass_flux),
                     box["spec"], torch.tensor(dt, dtype=torch.float64),
                     box["ids_d"], _t(box["ic"]["r"]), packed)
    _close(got.dQdt, back(want.dQdt))
    _close(got.rdmdt_dot, back(want.rdmdt_dot))
    if zero_mass_flux:
        assert not got.dQdt[:, 3].any()


def _gravity_case(name):
    if name == "box16":
        ic = jittered_box_ic(mfv_params(16), 16)
        rng = np.random.default_rng(3)
        r, m = ic["r"], ic["m"].copy()
        h = ic["h"] * (1.0 + 0.2 * rng.random(len(m)))
        pext = [1.0, 1.0, 1.0]
    else:
        rng = np.random.default_rng(5)
        r = rng.standard_normal((3000, 3))
        r *= (1.0 + (rng.random(3000) * 2) ** 2)[:, None] / 3.0
        m = rng.random(3000) * (2.0 / 3000)
        m[::50] = 0.0       # massless partners: no zeta term from them
        h = 0.05 * (1.0 + rng.random(3000))
        pext = None
    zh = -0.5 * rng.random(len(m)) / h ** 4
    return r, m, h, zh, pext


@pytest.mark.parametrize("case", ["box16", "cluster"])
def test_tree_mfv_zeta_matches_jax(case):
    """K4-K7 plain with zeta_scaling "mfv" against the JAX package's
    tree_gravity_grouped, a and gpot within 1e-10 of their maxima; the
    MFV term differs from the SPH one."""
    r, m, h, zh, pext = _gravity_case(case)
    gmap = jt.plan_buckets_kd(r, 32)
    jspec = jt.plan_tree_for_buckets(gmap, 0.1)
    spec = tree_spec_from_jax(jspec)
    kern = kernel_factory("m4", 3)
    got = {}
    for mode in ("mfv", "sph"):
        got[mode] = tt.tree_gravity_grouped(
            spec, _t(gmap), _t(r), _t(m), _t(h), kern, _t(zh), pext,
            zeta_scaling=mode)
    want = jt.tree_gravity_grouped(
        jspec, jnp.asarray(gmap), jnp.asarray(r), jnp.asarray(m),
        jnp.asarray(h), jax_kernel("m4", 3), zh=jnp.asarray(zh),
        periodic_extent=pext, zeta_scaling="mfv")
    assert bool(got["mfv"][2]) == bool(want[2]) is False
    _close(got["mfv"][0], want[0])
    _close(got["mfv"][1], want[1])
    diff = (got["mfv"][0] - got["sph"][0]).abs().max()
    assert float(diff) > 1e-6 * float(got["mfv"][0].abs().max())
