"""Port parity: the plain versions of the meshless finite-volume kernels
K10, K11, K31, K12 and K7's MFV zeta mode with the quintic, gaussian and
tabulated smoothing kernels, float64, against gandalf_tpu.

The inputs: a jittered periodic lattice in [0, 1]^ndim (numpy generator
`SEED`; 48, 12^2 and 8^3 particles at ndim 1, 2 and 3), masses, an uneven
h start, velocities and energies from the same generator.  h_fac is
2.1 / kernrange (the number density's h about 0.7 spacings for the
kernels of range 3, 1.05 for the tabulated M4): the support, 2.1
spacings for every kernel, fits a grid of three or more cells a dim and
holds enough neighbours for a well-conditioned gradient matrix.  The JAX
functions run with jax.disable_jit(): the same operations, without a
compile of each kernel's while and map bodies.  For each
variant of kernels.smoothing.VARIANTS (quintic, gaussian, m4_tab,
quintic_tab, gaussian_tab) at each ndim:

- K10 and its finish against density_mfv_grid27;
- K11 against gradients_mfv_grid27 under the Gizmo limiter (its cell
  alphas), and its extrema through K31's sweep (tvdscalar in 1D and 3D,
  springel2009 in 2D) against the same function under that limiter;
- K12 against fluxes_mfv_grid27 in its six modes (HLLC, exact, RK2,
  block, the cell alphas, zeroslope), three in 1D, two in 2D and one in
  3D for each variant, taken in turn so that each variant meets all six
  and each ndim meets all six over the variants;
- in 3D, K4-K7 with K7's MFV zeta mode against tree_gravity_grouped
  (zeta_scaling "mfv"), but with the gaussian (fault F23).

Each stage takes the JAX package's outputs of the stage before, so each
kernel is compared on the same inputs; results in particle order.
Tolerance 1e-12 of each output's largest value (only the order of the
sums differs, and the tabulated kernels' indices come from the same
d^2)."""

import functools

import jax
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
from gandalf_tpu_torch.convert import grid_spec_from_jax, tree_spec_from_jax
from gandalf_tpu_torch.kernels.smoothing import VARIANTS, kernel_factory
from gandalf_tpu_torch.ops import mfv as tm
from gandalf_tpu_torch.ops import mfv_grid27 as tmg
from gandalf_tpu_torch.ops import sph_grid27 as tg
from gandalf_tpu_torch.ops import tree as tt
from gandalf_tpu_torch.ops.active_grid import dense_ids

torch.set_num_threads(1)

TOL = 1e-12
SEED = 11
# h_fac kernrange: the support in lattice spacings
SUPPORT, H_CONV, GAMMA = 2.1, 0.01, 1.4
SIDES = {1: 48, 2: 12, 3: 8}
# K12's modes (ops.mfv.MfvConfig fields; "block" adds dt_own and start)
FLUX_MODES = {
    "hllc": {},
    "exact": {"riemann": "exact"},
    "rk2": {"time_scheme": "rk2"},
    "block": {"block": True},
    "cell": {"slope_limiter": "tvdscalar"},
    "zeroslope": {"riemann": "exact", "slope_limiter": "zeroslope"}}
CASES = [(v, nd) for v in VARIANTS for nd in (1, 2, 3)]


def _flux_cases():
    """(variant, ndim, mode): three modes in 1D, two in 2D, one in 3D,
    taken in turn from the variant's offset, so that each variant meets
    every mode."""
    names = list(FLUX_MODES)
    out = []
    for iv, v in enumerate(VARIANTS):
        k = iv
        for nd, count in ((1, 3), (2, 2), (3, 1)):
            for _ in range(count):
                out.append((v, nd, names[k % 6]))
                k += 1
    return out


def _kernels(variant, nd):
    name, tab = VARIANTS[variant]
    return jax_kernel(name, nd, tab), kernel_factory(name, nd, tab)


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


@functools.lru_cache(maxsize=None)
def _case(variant, nd):
    """The lattice of one (variant, ndim), its JAX grid plan and binning,
    the port's slot map, and the JAX package's density and gradient
    passes with the variant's kernel (built once, for every test of the
    case)."""
    jk, tk = _kernels(variant, nd)
    h_fac = SUPPORT / jk.kernrange
    n = SIDES[nd]
    N = n ** nd
    rng = np.random.default_rng(SEED + nd)
    axes = np.meshgrid(*[(np.arange(n) + 0.5) / n] * nd, indexing="ij")
    r = np.stack([a.reshape(-1) for a in axes], -1)
    r = np.mod(r + 0.15 / n * rng.standard_normal(r.shape), 1.0)
    m = (1.0 + 0.3 * rng.random(N)) / N
    h0 = h_fac / n * (1.0 + 0.5 * rng.random(N))
    jbox = JaxBox(nd, (0.0,) * nd, (1.0,) * nd, (1,) * nd, (1,) * nd)
    # the plan's h guess: room for h above h_fac spacings, yet three
    # cells a dim in 3D
    jspec = jg.plan_grid27(jbox, r, (1.2 if nd == 3 else 1.5) * h_fac / n,
                           jk.kernrange)
    spec = grid_spec_from_jax(jspec)
    assert min(spec.ncells) >= 3
    b = jg.bin_particles(jspec, jnp.asarray(r))
    fill = jg.dense_fill_mask(jspec, b)

    def d(x):
        return jg.to_dense(jspec, b, jnp.asarray(x))

    def back(x):
        return np.asarray(jg.from_dense(jspec, b, x))

    hmax = jg.hmax_of(jspec, jk.kernrange)
    with jax.disable_jit():
        dens = jmg.density_mfv_grid27(jk, jspec, h_fac, H_CONV, d(r),
                                      d(m), d(h0), fill, hmax)
    assert not bool(dens.overflow)
    u = 1.5 * (1.0 + 0.2 * rng.random(N))
    v = 0.3 * rng.standard_normal((N, nd))
    rho = back(dens.rho)
    W = np.concatenate([v, rho[:, None],
                        (GAMMA - 1.0) * (rho * u)[:, None]], -1)
    sound = np.sqrt(GAMMA * (GAMMA - 1.0) * u)
    fields = {"h": back(dens.h), "ndens": back(dens.ndens),
              "hfactor": back(dens.hfactor), "W": W, "sound": sound}
    gdense = {"r": d(r), "h": d(fields["h"]), "ndens": d(fields["ndens"]),
              "Wprim": d(W), "sound": d(sound)}
    with jax.disable_jit():
        grads = jmg.gradients_mfv_grid27(jk, jspec, gdense, fill,
                                         limiter="gizmo")
    ids_d = dense_ids(spec, tg.bin_particles(spec, _t(r)))
    return dict(variant=variant, nd=nd, jk=jk, tk=tk, h_fac=h_fac, r=r,
                m=m, h0=h0,
                jspec=jspec, spec=spec, fill=fill, d=d, back=back,
                hmax=hmax, dens=dens, fields=fields, gdense=gdense,
                grads=grads, ids_d=ids_d)


@pytest.fixture(params=CASES, ids=[f"{v}-{nd}d" for v, nd in CASES])
def case(request):
    return _case(*request.param)


def _grad_packed(fl):
    return torch.cat([_t(fl["h"])[:, None], _t(fl["ndens"])[:, None],
                      _t(fl["W"]), _t(fl["sound"])[:, None]], -1)


def test_density_matches_jax(case):
    """K10 plain and its finish: h, ndens, rho, invomega, zeta, hfactor,
    every particle converged, no overflow."""
    c = case
    sums = tmg.density_sums(c["tk"], c["spec"], c["h_fac"], H_CONV,
                            c["hmax"], c["ids_d"], _t(c["r"]), _t(c["m"]),
                            _t(c["h0"]))
    assert bool(sums[3].all())
    got = tmg.density_finish(c["h_fac"], c["hmax"], _t(c["m"]), *sums,
                             ndim=c["nd"])
    for f in ("h", "ndens", "rho", "invomega", "zeta", "hfactor"):
        _close(getattr(got, f), c["back"](getattr(c["dens"], f)))
    assert bool(got.overflow) == bool(c["dens"].overflow) is False


def test_gradients_and_sweep_match_jax(case):
    """K11 plain under the Gizmo limiter (B, the gradients, the cell
    alphas, vsig_max, the bad flag), then with K31's sweep from K11's
    extrema: tvdscalar in 1D and 3D, springel2009 in 2D (its alphas)."""
    c = case
    packed = _grad_packed(c["fields"])
    got = tmg.gradients(c["tk"], c["spec"], c["ids_d"], _t(c["r"]), packed)
    for f in ("B", "grad", "alpha_slope", "vsig_max", "bad"):
        _close(getattr(got, f), c["back"](getattr(c["grads"], f)))
    lim = "springel2009" if c["nd"] == 2 else "tvdscalar"
    with jax.disable_jit():
        want = jmg.gradients_mfv_grid27(c["jk"], c["jspec"], c["gdense"],
                                        c["fill"], limiter=lim)
    got = tmg.gradients(c["tk"], c["spec"], c["ids_d"], _t(c["r"]), packed,
                        lim)
    _close(got.alpha_slope, c["back"](want.alpha_slope))
    assert float(got.alpha_slope.min()) < 1.0


@pytest.mark.parametrize("variant,nd,mode", _flux_cases(),
                         ids=[f"{v}-{nd}d-{m}" for v, nd, m in _flux_cases()])
def test_fluxes_match_jax(variant, nd, mode):
    """K12 plain in `mode`: dQdt and rdmdt_dot (in block mode also the
    committed dQ and rdmdt) from the JAX package's gradients, with a few
    bad-gradient fallbacks forced and a0 from the generator."""
    c = _case(variant, nd)
    fl, g, back, d = c["fields"], c["grads"], c["back"], c["d"]
    N = len(fl["h"])
    rng = np.random.default_rng(SEED + 10 * nd)
    a0 = 0.05 * rng.standard_normal((N, nd))
    bad = back(g.bad).copy()
    bad[::7] = True
    B, grad, alpha = back(g.B), back(g.grad), back(g.alpha_slope)
    dt = 2e-3
    over = dict(FLUX_MODES[mode])
    block = over.pop("block", False)
    dense = {"r": d(c["r"]), "h": d(fl["h"]), "ndens": d(fl["ndens"]),
             "hfactor": d(fl["hfactor"]), "Wprim": d(fl["W"]),
             "sound": d(fl["sound"]), "a0": d(a0), "B": d(B),
             "grad": d(grad), "alpha_slope": d(alpha),
             "bad": d(bad.astype(np.float64))}
    kw = {}
    if block:
        dt_own = dt * 2.0 ** -rng.integers(0, 3, N)
        start = rng.random(N) < 0.4
        dense["dt_own"] = d(dt_own)
        dense["start"] = d(start.astype(np.float64))
        kw = dict(dt_own=_t(dt_own), start=_t(start))
    with jax.disable_jit():
        want = jmg.fluxes_mfv_grid27(c["jk"],
                                     jm.MfvConfig(gamma=GAMMA, **over),
                                     c["jspec"], jnp.asarray(dt), dense,
                                     c["fill"])
    packed = tmg.pack_flux_fields(
        *map(_t, (fl["h"], fl["ndens"], fl["W"], fl["sound"], a0, B, grad,
                  alpha, bad)), **kw)
    got = tmg.fluxes(c["tk"], tm.MfvConfig(gamma=GAMMA, **over), c["spec"],
                     torch.tensor(dt, dtype=torch.float64), c["ids_d"],
                     _t(c["r"]), packed, block=block)
    fields = ("dQdt", "rdmdt_dot") + (("dQ", "rdmdt") if block else ())
    for f in fields:
        _close(getattr(got, f), back(getattr(want, f)))
    assert float(torch.abs(got.dQdt).max()) > 0.0


@pytest.mark.parametrize("variant", [v for v in VARIANTS
                                     if not v.startswith("gaussian")])
def test_tree_mfv_zeta_matches_jax(variant):
    """K4-K7 plain with zeta_scaling "mfv" against the JAX package's
    tree_gravity_grouped on the 3D lattice with uneven h and masses, a
    few massless partners and a zeta term: a and gpot within 1e-12 of
    their maxima."""
    jk, tk = _kernels(variant, 3)
    n = SIDES[3]
    N = n ** 3
    rng = np.random.default_rng(SEED + 30)
    r = rng.random((N, 3))
    m = (1.0 + rng.random(N)) / N
    m[::50] = 0.0
    h = 1.5 * SUPPORT / jk.kernrange / n * (1.0 + rng.random(N))
    zh = -0.5 * rng.random(N) / h ** 4
    gmap = jt.plan_buckets_kd(r, 32)
    jspec = jt.plan_tree_for_buckets(gmap, 0.1)
    spec = tree_spec_from_jax(jspec)
    got = tt.tree_gravity_grouped(spec, _t(gmap), _t(r), _t(m), _t(h), tk,
                                  _t(zh), None, zeta_scaling="mfv")
    want = jt.tree_gravity_grouped(
        jspec, jnp.asarray(gmap), jnp.asarray(r), jnp.asarray(m),
        jnp.asarray(h), jk, zh=jnp.asarray(zh), periodic_extent=None,
        zeta_scaling="mfv")
    assert bool(got[2]) == bool(want[2]) is False
    _close(got[0], want[0])
    _close(got[1], want[1])
