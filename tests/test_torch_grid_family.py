"""Port parity: the plain versions of the Cullen & Dehnen switch (K21),
the gas-dust drag (K23, K24) and Saitoh & Makino SPH (K25, K26) with the
quintic, gaussian and tabulated smoothing kernels, float64, against
gandalf_tpu.

For each variant of kernels.smoothing.VARIANTS (quintic, gaussian,
m4_tab, quintic_tab, gaussian_tab) at ndim 1, 2 and 3, on inputs made
with numpy from a seed:

- K21 through ops/forces.py:cullen_dehnen_dense against the JAX
  package's on a jittered periodic lattice (48, 12^2 and 8^3 particles)
  with 5% dead, h about 2.1 / kernrange spacings, so that every kernel
  sees about as many neighbours (in 3D on two cells a dim: a cell is at
  least the support, so no pair is met twice);
- K23 and K24 through ops/dust.py:drag_pass_grid against the JAX
  package's on check.dust_kernel_fields' state (400 particles,
  alternately gas and dust, per-row dt with tau on both sides of 1e-3, a
  coincident pair, 5% dead); the drag law and the test-particle mode
  taken in turn, so that each variant meets several laws and both modes;
- K25 and K26 through ops/sm2012.py:sm2012_hydro_pass_grid against the
  JAX package's on the lattice, mon97 and per-particle alpha in turn.

The JAX passes of one kind and ndim run as one jitted program for all
five variants (the binning and candidate gathers, which do not depend on
the kernel, compile once), on grid plans made for kernrange 3.
Tolerance 1e-12 of each output's largest value: only the order of the
sums differs, and the plain versions sum d^2 in the CUDA kernels' order,
which is the JAX package's on the CPU, so a tabulated kernel's indices
come from the same d^2.

Tabulated pairs near a table point: on a 1D chain whose h puts every
pair within an ulp or two of a point of the tabulated M4's s grid,
K21, K23, K24 and K26's plain forms index the same point as the JAX
package's (the outputs agree to 1e-12; a pair one table step apart moves
W' by ~1e-3 of itself), and moving h by a few ulps moves the outputs by
far more, so the comparison would see a flip.  Fault F34 shown on the
JAX package: its jitted programs multiply by the table step's rounded
reciprocal.  wdrag of each variant against the JAX package's at every
table point's neighbours.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import dust as jdust
from gandalf_tpu.ops import forces as jforces
from gandalf_tpu.ops import sm2012 as jsm
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.state import FLAG_DEAD
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu.state import make_sph_state as jax_state
from gandalf_tpu_torch.check import dust_kernel_fields
from gandalf_tpu_torch.convert import grid_spec_from_jax
from gandalf_tpu_torch.kernels.smoothing import VARIANTS, kernel_factory
from gandalf_tpu_torch.ops import dust as tdust
from gandalf_tpu_torch.ops import forces as tforces
from gandalf_tpu_torch.ops import sm2012 as tsm
from gandalf_tpu_torch.state import DomainBox
from gandalf_tpu_torch.state import make_sph_state as torch_state

torch.set_num_threads(1)

TOL = 1e-12
SEED = 23
# h_fac kernrange: the support in lattice spacings
SUPPORT, H_CONV, GAMMA = 2.1, 0.01, 1.4
SIDES = {1: 48, 2: 12, 3: 8}
# every variant's grid plan is made for the largest kernrange (the
# quintic's and the gaussian's 3): the JAX package's eager operations
# then meet the same shapes for every variant of an ndim
PLAN_RANGE = 3.0
LAWS = (("fixed", 2.0), ("density", 1.0), ("epstein", 1.5), ("lp12", 3.0))
CASES = [(v, nd) for v in VARIANTS for nd in (1, 2, 3)]
DRAG_OUTPUTS = ("a_drag", "dudt", "sound", "div_v")
# particles of the 1D chain of pairs near a table point
NEAR_N = 32


def _kernels(variant, nd):
    name, tab = VARIANTS[variant]
    return jax_kernel(name, nd, tab), kernel_factory(name, nd, tab)


def _scaled(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


def _boxes(nd):
    codes = ((1,) * nd, (1,) * nd)          # periodic on every side
    return (JaxBox(nd, (0.0,) * nd, (1.0,) * nd, *codes),
            DomainBox(nd, (0.0,) * nd, (1.0,) * nd, *codes))


@functools.lru_cache(maxsize=None)
def _lattice(nd, seed):
    """A jittered periodic lattice in [0, 1)^nd (SIDES[nd] a side) and
    the fields of its particles: v, a, m, u, alpha, rho, sound, an h
    factor in [1, 1.3] and 5% dead."""
    n = SIDES[nd]
    N = n ** nd
    rng = np.random.default_rng(seed + nd)
    axes = np.meshgrid(*[(np.arange(n) + 0.5) / n] * nd, indexing="ij")
    r = np.stack([a.reshape(-1) for a in axes], -1)
    r = np.mod(r + 0.15 / n * rng.standard_normal(r.shape), 1.0)
    alive = rng.random(N) > 0.05
    return {"r": r, "v": 0.1 * rng.standard_normal((N, nd)),
            "a": rng.standard_normal((N, nd)),
            "m": (1.0 + 0.3 * rng.random(N)) / N,
            "u": 1.0 + rng.random(N), "alpha": rng.uniform(0.1, 1.0, N),
            "rho": 1.0 + 0.1 * rng.random(N),
            "sound": 1.0 + rng.random(N),
            "hscale": 1.0 + 0.3 * rng.random(N), "alive": alive}


def _visc(module, avisc):
    return module.ArtificialViscosity(avisc=module._AVISC_CODES[avisc],
                                      alpha_visc=1.0, alpha_visc_min=0.1,
                                      beta_visc=2.0)


def _jax_cullen_dehnen(jk, jspec, args):
    """gandalf_tpu's cullen_dehnen_dense over bin_particles(discard =
    ~alive), one jitted program."""
    @jax.jit
    def switch(*x):
        b = jg.bin_particles(jspec, x[0], discard=~x[-1])
        return jforces.cullen_dehnen_dense(
            jk, _visc(jforces, "mon97mm97"), jspec, b, *x)

    return switch(*map(jnp.asarray, args))


# ---------------------------------------------------------------------------
# K21
# ---------------------------------------------------------------------------

def _cd_args(variant, ndim):
    """K21's inputs for one variant: the lattice with h = SUPPORT /
    kernrange spacings (scattered), alpha at alpha_visc_min as in a
    run."""
    f = _lattice(ndim, SEED)
    h = SUPPORT / _kernels(variant, ndim)[0].kernrange / SIDES[ndim] \
        * f["hscale"]
    return (f["r"], f["v"], f["a"], f["m"], h, f["rho"], f["sound"],
            h ** -(ndim + 1), np.full_like(h, 0.1), f["alive"])


@functools.lru_cache(maxsize=None)
def _jax_cd_all(ndim):
    """The grid plan and gandalf_tpu's cullen_dehnen_dense for every
    variant, one jitted program: the binning and the shifted views, which
    do not depend on the kernel, are compiled once."""
    f = _lattice(ndim, SEED)
    h_big = SUPPORT / PLAN_RANGE / SIDES[ndim] * f["hscale"].max()
    jspec = jg.plan_grid27(_boxes(ndim)[0], f["r"], h_big * 1.05,
                           PLAN_RANGE)

    @jax.jit
    def switches(all_args):
        out = {}
        for v, x in all_args.items():
            b = jg.bin_particles(jspec, x[0], discard=~x[-1])
            out[v] = jforces.cullen_dehnen_dense(
                _kernels(v, ndim)[0], _visc(jforces, "mon97mm97"), jspec,
                b, *x)
        return out

    res = switches({v: tuple(map(jnp.asarray, _cd_args(v, ndim)))
                    for v in VARIANTS})
    return jspec, {v: tuple(map(np.asarray, x)) for v, x in res.items()}


@pytest.mark.parametrize("variant,ndim", CASES)
def test_cullen_dehnen_family_matches_jax(variant, ndim):
    _, tk = _kernels(variant, ndim)
    jspec, want = _jax_cd_all(ndim)
    assert min(jspec.ncells) >= 2
    args = _cd_args(variant, ndim)
    ja, jd = want[variant]
    ta, td = tforces.cullen_dehnen_dense(
        tk, _visc(tforces, "mon97mm97"), grid_spec_from_jax(jspec),
        *map(torch.tensor, args))
    assert _scaled(ta, ja) <= TOL
    assert _scaled(td, jd) <= TOL
    # the switch fired somewhere and left the dead alone
    alpha, alive = args[8], args[9]
    assert (ja > alpha + 1e-12).any()
    assert (ja[~alive] == alpha[~alive]).all()


# ---------------------------------------------------------------------------
# K23, K24
# ---------------------------------------------------------------------------

def _drag_states(f):
    N, _ = f["r"].shape
    js = jax_state(f["r"], f["v"], np.full(N, 1.0 / N), f["h"], np.ones(N))
    ts = torch_state(f["r"], f["v"], np.full(N, 1.0 / N), f["h"],
                     np.ones(N), dtype=torch.float64)
    kw = {k: f[k] for k in ("rho", "sound", "a", "a0", "h")}
    js = js.replace(**{k: jnp.asarray(v) for k, v in kw.items()},
                    ptype=jnp.asarray(f["ptype"], jnp.int32),
                    flags=jnp.asarray(f["flags"]))
    ts = ts.replace(**{k: torch.tensor(v) for k, v in kw.items()},
                    ptype=torch.tensor(f["ptype"], dtype=torch.int32),
                    flags=torch.tensor(f["flags"]))
    return js, ts


def _jax_drag(jk, law, jspec, dt, js, tp):
    """gandalf_tpu's drag_pass_grid, one jitted program."""
    return jax.jit(lambda d, s: jdust.drag_pass_grid(
        jk, law, jspec, d, s, s.alive, tp))(jnp.asarray(dt), js)


def _drag_case(variant, ndim):
    """(law, coeff), test_particle of the case: taken in turn."""
    k = list(VARIANTS).index(variant) * 3 + ndim
    return LAWS[k % len(LAWS)], k % 3 == 0


@functools.lru_cache(maxsize=None)
def _jax_drag_all(ndim):
    """The state, its grid plan and gandalf_tpu's drag_pass_grid with
    every variant (each with its case's law and mode), one jitted
    program: the candidate gather is compiled once."""
    f = dust_kernel_fields(400, ndim, seed=SEED)
    jspec = jg.plan_grid27(_boxes(ndim)[0], f["r"], f["h"].max() * 1.1,
                           PLAN_RANGE)
    js, _ = _drag_states(f)

    @jax.jit
    def passes(dt, s):
        out = {}
        for v in VARIANTS:
            (law, coeff), tp = _drag_case(v, ndim)
            out[v] = jdust.drag_pass_grid(
                _kernels(v, ndim)[0], jdust.DragLaw(law, coeff, True),
                jspec, dt, s, s.alive, tp)
        return out

    return f, jspec, passes(jnp.asarray(f["dt"]), js)


@pytest.mark.parametrize("variant,ndim", CASES)
def test_drag_family_matches_jax(variant, ndim):
    _, tk = _kernels(variant, ndim)
    (law, coeff), tp = _drag_case(variant, ndim)
    f, jspec, want = _jax_drag_all(ndim)
    _, ts = _drag_states(f)
    got, _ = tdust.drag_pass_grid(
        tk, tdust.DragLaw(law, coeff, True), grid_spec_from_jax(jspec),
        _boxes(ndim)[1], torch.tensor(f["dt"]), ts, ts.alive, tp)
    for name in DRAG_OUTPUTS:
        assert _scaled(getattr(got, name),
                       getattr(want[variant], name)) <= TOL, name
    assert float(torch.abs(got.a_drag).max()) > 0.0
    if not tp:
        assert float(torch.abs(got.dudt).max()) > 0.0


def test_wdrag_family_matches_jax():
    """wdrag of each variant against the JAX package's in 1-3 dims, on a
    ramp through the support and at each table point's neighbours (one
    ulp either side), zero from kernrange on."""
    for variant in VARIANTS:
        for ndim in (1, 2, 3):
            jk, tk = _kernels(variant, ndim)
            s = np.linspace(0.0, jk.kernrange * 1.1, 777)
            if tk.table_res:
                grid = np.arange(tk.table_res + 1) * (jk.kernrange
                                                      / tk.table_res)
                s = np.concatenate([s, grid, np.nextafter(grid, 0.0),
                                    np.nextafter(grid, 10.0)])
            with jax.disable_jit():
                want = np.asarray(jk.wdrag(jnp.asarray(s)))
            got = tk.wdrag(torch.tensor(s)).numpy()
            assert _scaled(got, want) <= 1e-14, (variant, ndim)
            assert (got[s >= jk.kernrange] == 0.0).all()


# ---------------------------------------------------------------------------
# K25, K26
# ---------------------------------------------------------------------------

def _sm2012_states(f, h):
    N, nd = f["r"].shape
    m = np.where(f["alive"], f["m"], 0.0)
    flags = np.where(f["alive"], 0, FLAG_DEAD).astype(np.int32)
    js = jax_state(f["r"], f["v"], m, h, f["u"])
    js = js.replace(alpha=jnp.asarray(f["alpha"]), flags=jnp.asarray(flags))
    ts = torch_state(f["r"], f["v"], m, h, f["u"], dtype=torch.float64)
    ts = ts.replace(alpha=torch.tensor(f["alpha"]),
                    flags=torch.tensor(flags))
    return js, ts


def _sm2012_case(variant, ndim):
    """h_fac, the starting h and the viscosity (mon97 or per-particle
    alpha, in turn) of the case."""
    f = _lattice(ndim, SEED + 7)
    h_fac = SUPPORT / _kernels(variant, ndim)[0].kernrange
    avisc = ("mon97", "mon97mm97")[list(VARIANTS).index(variant) % 2]
    return f, h_fac, h_fac / SIDES[ndim] * f["hscale"], avisc


@functools.lru_cache(maxsize=None)
def _jax_sm2012_all(ndim):
    """The grid plan (room for h above h_fac spacings) and gandalf_tpu's
    sm2012_hydro_pass_grid with every variant, one jitted program."""
    f = _lattice(ndim, SEED + 7)
    jspec = jg.plan_grid27(_boxes(ndim)[0], f["r"],
                           (1.2 if ndim == 3 else 1.5) * SUPPORT
                           / PLAN_RANGE / SIDES[ndim], PLAN_RANGE)

    @jax.jit
    def passes(states):
        out = {}
        for v, s in states.items():
            _, h_fac, _, avisc = _sm2012_case(v, ndim)
            out[v] = jsm.sm2012_hydro_pass_grid(
                _kernels(v, ndim)[0], _visc(jforces, avisc), GAMMA, jspec,
                h_fac, H_CONV, s, s.alive, True)
        return out

    states = {}
    for v in VARIANTS:
        f, _, h0, _ = _sm2012_case(v, ndim)
        states[v] = _sm2012_states(f, h0)[0]
    return jspec, passes(states)


@pytest.mark.parametrize("variant,ndim", CASES)
def test_sm2012_family_matches_jax(variant, ndim):
    """The whole pass, plain K25 then K26, against the JAX package's
    gather path: h, rho, q, hfactor, a, du/dt and div v."""
    _, tk = _kernels(variant, ndim)
    f, h_fac, h0, avisc = _sm2012_case(variant, ndim)
    jspec, want = _jax_sm2012_all(ndim)
    assert min(jspec.ncells) >= 2
    jout, jq = want[variant]
    _, ts = _sm2012_states(f, h0)
    assert not bool(ts.alive.all())
    tout, tq = tsm.sm2012_hydro_pass_grid(
        tk, _visc(tforces, avisc), GAMMA, grid_spec_from_jax(jspec), h_fac,
        H_CONV, ts, ts.alive, True)
    live = ts.alive.numpy()
    assert _scaled(tq.numpy()[live], np.asarray(jq)[live]) <= TOL
    for name in ("h", "rho", "hfactor", "a", "dudt", "div_v"):
        assert _scaled(getattr(tout, name), getattr(jout, name)) <= TOL, name
    assert not bool(tout.neib_overflow)
    assert not bool(jout.neib_overflow)


# ---------------------------------------------------------------------------
# Pairs near a table point
# ---------------------------------------------------------------------------

def _near_chain():
    """NEAR_N particles in a periodic 1D box of NEAR_N * 3/2 units u =
    1/64 (every position and separation exact), the gaps alternately u
    and 2u, and h = u / 0.6: every pair within the M4 support has s =
    0.6, 1.2 or 1.8 within an ulp or two, each a point of the tabulated
    M4's s grid (step 0.002)."""
    u = 1.0 / 64
    gaps = np.where(np.arange(NEAR_N) % 2 == 0, u, 2 * u)
    r = (np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) + 0.5 * u)[:, None]
    return r, u / 0.6, NEAR_N * 1.5 * u


def _near_grid(s, step):
    """Pairs with s within 4 ulps of a multiple of step."""
    q = s / step
    return int(np.sum(np.abs(q - np.round(q))
                      <= 4 * np.finfo(float).eps * np.maximum(q, 1.0)))


def test_tabulated_pairs_near_a_table_point():
    """The tabulated M4 on _near_chain: K21, K23 with K24 and K26's plain
    forms against the JAX package's, outputs within 1e-12, so every pair
    takes the same table point; with h moved by 8 ulps either way the
    outputs move by far more, so the comparison sees a pair that takes
    the next point.  (The tabulated quintic and gaussian's steps, 0.003,
    meet fault F34 in the JAX package's jitted programs:
    test_jitted_table_lookup_multiplies_by_the_reciprocal_f34.)"""
    jk, tk = _kernels("m4_tab", 1)
    step = jk.kernrange / tk.table_res
    r, h_near, L = _near_chain()
    d = np.abs(r[:, 0, None] - r[None, :, 0])
    d = np.minimum(d, L - d)
    s = d[(d > 0) & (d * (1.0 / h_near) < jk.kernrange)] * (1.0 / h_near)
    assert s.size > 0 and _near_grid(s, step) == s.size
    rng = np.random.default_rng(SEED)
    N = NEAR_N
    v, a = 0.1 * rng.standard_normal((N, 1)), rng.standard_normal((N, 1))
    m, u = np.full(N, 1.0 / N), 1.0 + rng.random(N)
    rho, sound = 1.0 + 0.1 * rng.random(N), 1.0 + rng.random(N)
    alpha = np.full(N, 0.1)
    codes = ((1,), (1,))
    jbox = JaxBox(1, (0.0,), (L,), *codes)
    tbox = DomainBox(1, (0.0,), (L,), *codes)

    def k21(h, ref=True):
        hh = np.full(N, h)
        args = (r, v, a, m, hh, rho, sound, hh ** -2, alpha,
                np.ones(N, bool))
        jspec = jg.plan_grid27(jbox, r, h_near * 1.05, jk.kernrange)
        want = _jax_cullen_dehnen(jk, jspec, args) if ref else ()
        got = tforces.cullen_dehnen_dense(
            tk, _visc(tforces, "mon97mm97"), grid_spec_from_jax(jspec),
            *map(torch.tensor, args))
        return torch.cat(got), ref and np.concatenate(want)

    def drag(h, ref=True):
        f = {"r": r, "v": v, "a": a, "a0": 0.5 * a, "h": np.full(N, h),
             "rho": rho, "sound": sound,
             "ptype": np.where(np.arange(N) % 2 == 0, 0, 3),
             "dt": np.full(N, 0.01), "flags": np.zeros(N, np.int32)}
        jspec = jg.plan_grid27(jbox, r, h_near * 1.1, jk.kernrange)
        js, ts = _drag_states(f)
        got, _ = tdust.drag_pass_grid(
            tk, tdust.DragLaw("fixed", 2.0, True),
            grid_spec_from_jax(jspec), tbox, torch.tensor(f["dt"]), ts,
            ts.alive, False)
        if not ref:
            return torch.cat([got.a_drag[:, 0], got.dudt]), None
        want = _jax_drag(jk, jdust.DragLaw("fixed", 2.0, True), jspec,
                         f["dt"], js, False)
        return (torch.cat([got.a_drag[:, 0], got.dudt]),
                np.concatenate([np.asarray(want.a_drag)[:, 0],
                                np.asarray(want.dudt)]))

    def k26(h, ref=True):
        # the all-pairs view of the periodic chain: dr = r_j - r_i
        # min-imaged, each row's neighbours every particle
        dr = r[None, :, :] - r[:, None, :]
        dr = dr - L * np.round(dr / L)
        hh = np.full(N, h)
        fields = {"v": v, "u": u, "h": hh, "rho": rho, "q": rho * u,
                  "hfactor": hh ** -2, "sound": sound, "alpha": alpha}
        nb = {k: np.ascontiguousarray(np.broadcast_to(x[None],
                                                      (N,) + x.shape))
              for k, x in dict(fields, m=m).items()}
        rows = [fields[k] for k in ("v", "u", "h", "rho", "q", "hfactor",
                                    "sound", "alpha")]
        mask = np.ones((N, N), bool)
        got = tsm.sm2012_forces_view(
            tk, _visc(tforces, "mon97mm97"), GAMMA,
            *map(torch.tensor, rows), torch.tensor(dr),
            {k: torch.tensor(x) for k, x in nb.items()}, torch.tensor(mask))
        if not ref:
            return torch.cat([got.a[:, 0], got.dudt]), None
        want = jax.jit(lambda *x: jsm.sm2012_forces_view(
            jk, _visc(jforces, "mon97mm97"), GAMMA, *x[:8], x[8], x[9],
            x[10]))(*map(jnp.asarray, rows), jnp.asarray(dr),
                    {k: jnp.asarray(x) for k, x in nb.items()},
                    jnp.asarray(mask))
        return (torch.cat([got.a[:, 0], got.dudt]),
                np.concatenate([np.asarray(want.a)[:, 0],
                                np.asarray(want.dudt)]))

    for form in (k21, drag, k26):
        got, want = form(h_near)
        assert _scaled(got, want) <= TOL, form.__name__
        # h a few ulps off moves pairs across their table points
        moved = [form(h_near * (1.0 + k * np.finfo(float).eps), False)[0]
                 for k in (-8, 8)]
        assert max(_scaled(x, got.numpy()) for x in moved) > 1e3 * TOL, \
            form.__name__


@pytest.mark.parametrize("variant", ["quintic_tab", "gaussian_tab"])
def test_jitted_table_lookup_multiplies_by_the_reciprocal_f34(variant):
    """ROADMAP fault F34, shown on the JAX package: its table lookup
    floor(s / step) step, with step = kernrange / res = 0.003, is written
    as a division, and evaluated so (as the port's plain versions and
    CUDA kernels evaluate it) it puts s = 1.2 (= 400 step, rounded) on
    table point 400; XLA's simplifier turns the division by the constant
    into a product with its rounded reciprocal in every jitted program
    (every pass of the JAX package's runs), which puts it on point 399.
    A pair that lies within an ulp of a table point can therefore take
    the next point in the JAX package's runs only."""
    jk, tk = _kernels(variant, 1)
    s = np.array([1.2])
    with jax.disable_jit():
        eager = np.asarray(jk.w1(jnp.asarray(s)))
    jitted = np.asarray(jax.jit(jk.w1)(jnp.asarray(s)))
    port = tk.w1(torch.tensor(s)).numpy()
    base = tk.base.w1
    step = jk.kernrange / tk.table_res
    at = {k: float(base(torch.tensor([k * step], dtype=torch.float64))[0])
          for k in (399, 400)}
    assert np.floor(s[0] / step) == 400.0
    assert np.floor(s[0] * (1.0 / step)) == 399.0
    assert port[0] == eager[0] == at[400]
    # the jitted program's own rounding of the polynomial: within 1e-14
    assert abs(jitted[0] - at[399]) <= 1e-14 * abs(at[399])
    assert abs(at[399] - at[400]) > 1e-4 * abs(at[400])
