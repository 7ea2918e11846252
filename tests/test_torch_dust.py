"""Port parity: the gas-dust drag (K23, K24) on the grid, float64 on the
CPU against gandalf_tpu.

- The plain versions of K23 and K24 through the port's drag_pass_grid
  against gandalf_tpu/ops/dust.py:drag_pass_grid on the same state
  (tests/test_dense_kernels.py:_random_state, 400 particles, alternately
  gas and dust, generalised to 1 and 2 dims) and the same grid plan:
  every law in two-fluid and test-particle mode with the energy term on
  and off, in 3D with each particle's own dt; 1 and 2 dims with a
  scalar and a per-row dt; per-row dt on both sides of tau = 1e-3; a
  scalar dt of 0 (the bootstrap's instantaneous force); a coincident
  gas-dust pair and dead particles.  Each output within 1e-12 of its
  largest |value|.
- Mirror walls: both layouts of tests/test_grid_mirror.py in 3D and the
  1D column, where a gas particle gathers the payloads of dust images
  (the port's gather) and the JAX package scatters a dust particle's
  deposit onto gas images and redirects it to their parents; and a dust
  particle within one cell of a wall whose gas partner's h exceeds its
  own.
- wdrag against gandalf_tpu/kernels/smoothing.py:88.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import dust as jdust
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu.state import make_sph_state as jax_state
from gandalf_tpu_torch.check import (MIRROR_DIM0, MIRROR_MIXED,
                                     dust_kernel_fields, mirror_params)
from gandalf_tpu_torch.convert import grid_spec_from_jax
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import dust as tdust
from gandalf_tpu_torch.state import DUST_TYPE, GAS_TYPE, PERIODIC, DomainBox
from gandalf_tpu_torch.state import make_sph_state as torch_state

torch.set_num_threads(1)

TOL = 1e-12
OUTPUTS = ("a_drag", "dudt", "sound", "div_v")
LAWS = {"fixed": 2.0, "density": 1.0, "epstein": 1.5, "lp12": 3.0}


def _random_state(ndim=3, N=400, seed=3, walls=None):
    """tests/test_dense_kernels.py:_random_state(dust=True) in `ndim`
    dims, as check.dust_kernel_fields builds it for the card."""
    return dust_kernel_fields(N, ndim, seed, walls)


def _boxes(ndim, walls):
    if walls is None:
        codes = ((PERIODIC,) * ndim, (PERIODIC,) * ndim)
        return (JaxBox(ndim, (0.0,) * ndim, (1.0,) * ndim, *codes),
                DomainBox(ndim, (0.0,) * ndim, (1.0,) * ndim, *codes))
    p = mirror_params(8, ndim, walls)
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(p, table))
    return JaxBox.from_params(jp), DomainBox.from_params(p)


def _states(f):
    N, ndim = f["r"].shape
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


def _compare(f, law, tp, dt, walls=None):
    """JAX drag_pass_grid against the port's plain path on state f with
    scalar dt (a float) or per-row dt ("rows"); returns the port's
    result and the JAX one as numpy."""
    N, ndim = f["r"].shape
    jbox, tbox = _boxes(ndim, walls)
    jspec = jg.plan_grid27(jbox, f["r"], f["h"].max() * 1.1, 2.0)
    js, ts = _states(f)
    dt_np = f["dt"] if dt == "rows" else np.float64(dt)
    kw = {"box": jbox} if walls else {}

    @jax.jit
    def jax_pass(dt_j, s):
        return jdust.drag_pass_grid(jax_kernel("m4", ndim), law, jspec, dt_j,
                                    s, s.alive, tp, **kw)

    want = jax_pass(jnp.asarray(dt_np), js)
    tlaw = tdust.DragLaw(law.law, law.coeff, law.use_energy_term)
    got, _ = tdust.drag_pass_grid(kernel_factory("m4", ndim), tlaw,
                                  grid_spec_from_jax(jspec), tbox,
                                  torch.tensor(dt_np), ts, ts.alive, tp)
    for name in OUTPUTS:
        x = getattr(got, name).numpy()
        y = np.asarray(getattr(want, name))
        scale = max(np.max(np.abs(y)), 1e-300)
        assert np.max(np.abs(x - y)) / scale <= TOL, name
    return got, want


@pytest.mark.parametrize("energy", [True, False])
@pytest.mark.parametrize("tp", [False, True])
@pytest.mark.parametrize("law", sorted(LAWS))
def test_drag_3d_per_row_dt(law, tp, energy):
    f = _random_state(3)
    got, _ = _compare(f, jdust.DragLaw(law, LAWS[law], energy), tp, "rows")
    a = got.a_drag.numpy()
    dust = f["ptype"] == DUST_TYPE
    live = f["flags"] == 0
    assert np.abs(a[dust & live]).max() > 0.0
    # dead particles get nothing; test particles leave the gas alone
    assert not np.abs(a[~live]).any()
    if tp:
        assert not np.abs(a[~dust]).any()
    if energy and not tp:
        assert np.abs(got.dudt.numpy()[~dust & live]).max() > 0.0
    else:
        assert not got.dudt.numpy().any()


@pytest.mark.parametrize("dt", ["rows", 0.02])
@pytest.mark.parametrize("tp", [False, True])
@pytest.mark.parametrize("ndim", [1, 2])
def test_drag_low_dims(ndim, tp, dt):
    _compare(_random_state(ndim), jdust.DragLaw("epstein", 1.5, True), tp,
             dt)


@pytest.mark.parametrize("law", ["fixed", "lp12"])
def test_drag_3d_scalar_dt(law):
    _compare(_random_state(3), jdust.DragLaw(law, LAWS[law], True), False,
             0.05)


def test_tau_straddles_the_series_branch():
    """Per-row dt puts tau = dt / t_s on both sides of 1e-3 (fixed law,
    t_s = 1/2); dt = 0 is the bootstrap's instantaneous drag force."""
    f = _random_state(3)
    tau = f["dt"] * LAWS["fixed"]
    assert (tau < 1e-3).sum() > 20 and (tau > 1e-3).sum() > 20
    law = jdust.DragLaw("fixed", LAWS["fixed"], True)
    _compare(f, law, False, "rows")
    got, _ = _compare(f, law, False, 0.0)
    assert np.abs(got.a_drag.numpy()).max() > 0.0


def test_coincident_pair_is_skipped():
    """Particles 0 (gas) and 1 (dust) coincide: the pair adds nothing
    (d^2 = 0), and moving 1 away changes both rows."""
    f = _random_state(3)
    law = jdust.DragLaw("epstein", 1.5, True)
    got0, _ = _compare(f, law, False, "rows")
    g = dict(f)
    g["r"] = f["r"].copy()
    g["r"][1] += 0.3 * f["h"][0]
    got1, _ = _compare(g, law, False, "rows")
    assert not np.allclose(got0.a_drag.numpy()[:2], got1.a_drag.numpy()[:2])


@pytest.mark.parametrize("ndim,walls", [(3, MIRROR_DIM0), (3, MIRROR_MIXED),
                                        (1, MIRROR_DIM0)],
                         ids=["dim0", "mixed", "column"])
def test_drag_mirror_walls(ndim, walls):
    """The images' deposits: the JAX package scatters a dust particle's
    share onto its gas candidates, images included, and redirects an
    image's to its parent; the port's gas particles gather the payloads
    of the dust and its images."""
    f = _random_state(ndim, walls=walls)
    got, _ = _compare(f, jdust.DragLaw("epstein", 1.5, True), False, "rows",
                      walls=walls)
    assert np.abs(got.dudt.numpy()).max() > 0.0


def test_gather_equals_scatter_near_a_wall():
    """A dust particle within one cell of a mirror wall, its gas partner
    (with an h larger than the dust's) nearer the wall: the gas
    particle's heating holds the deposit of the dust particle and of its
    image, and equals the JAX package's scatter with the redirect."""
    f = _random_state(3, walls=MIRROR_DIM0)
    dust, gas = 3, 4
    assert f["ptype"][dust] == DUST_TYPE and f["ptype"][gas] == GAS_TYPE
    f["flags"][[dust, gas]] = 0
    f["r"][dust] = [0.02, 0.5, 0.5]
    f["r"][gas] = [0.008, 0.5, 0.51]
    f["h"][dust], f["h"][gas] = 0.05, 0.09
    f["v"][dust] = [0.3, 0.0, 0.0]
    law = jdust.DragLaw("fixed", 2.0, True)
    got, _ = _compare(f, law, False, "rows", walls=MIRROR_DIM0)
    # without the wall, the gas particle gathers less: the image's share
    # is part of what the JAX redirect gives it
    g = dict(f)
    got_open, _ = _compare(g, law, False, "rows")
    assert got.dudt.numpy()[gas] != got_open.dudt.numpy()[gas]
    assert got.dudt.numpy()[gas] != 0.0


def test_wdrag_matches_jax():
    s = np.linspace(0.0, 2.5, 501)
    for ndim in (1, 2, 3):
        want = np.asarray(jax_kernel("m4", ndim).wdrag(jnp.asarray(s)))
        got = kernel_factory("m4", ndim).wdrag(torch.tensor(s)).numpy()
        assert np.max(np.abs(got - want)) <= 1e-15 * np.max(np.abs(want))
        assert got[-1] == 0.0 and got[0] == 0.0
