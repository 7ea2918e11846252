"""Port parity: the structured 27-shift grid hydro pass against
gandalf_tpu's (float64, CPU, plain versions of K1-K3).

Inputs are made with numpy from a seed and go through both packages;
the dense tensors the JAX code builds are handed to the port, so each
stage is compared on the same inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import forces as jforces
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.ops.eos import Adiabatic as JaxAdiabatic
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu.state import make_sph_state as jax_state
from gandalf_tpu_torch.check import jittered_box_ic, slice_params
from gandalf_tpu_torch.convert import grid_spec_from_jax, state_from_numpy
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import forces as tforces
from gandalf_tpu_torch.ops import sph_grid27 as tg
from gandalf_tpu_torch.ops.eos import Adiabatic
from gandalf_tpu_torch.state import DomainBox

torch.set_num_threads(1)

TOL = 1e-10
H_FAC, H_CONV = 1.2, 0.01


def _box(periodic=True):
    code = 1 if periodic else 0
    args = (3, (0.0,) * 3, (1.0,) * 3, (code,) * 3, (code,) * 3)
    return JaxBox(*args), DomainBox(*args)


def _ic(n_side, seed=42):
    return jittered_box_ic(slice_params(n_side), n_side, seed)


def _plans(n_side, periodic=True):
    ic = _ic(n_side)
    jbox, tbox = _box(periodic)
    h_max = float(ic["h"].max()) * 1.3
    jspec = jg.plan_grid27(jbox, ic["r"], h_max, 2.0)
    tspec = tg.plan_grid27(tbox, ic["r"], h_max, 2.0)
    return ic, jspec, tspec


def _t(x):
    return torch.tensor(np.array(x))


def _n(x):
    return np.asarray(x)


@pytest.mark.parametrize("n_side,ncells", [(8, 2), (16, 5)])
def test_plan_matches_jax(n_side, ncells):
    _, jspec, tspec = _plans(n_side)
    assert tspec.ncells == (ncells,) * 3
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert grid_spec_from_jax(jspec) == tspec
    assert tg.hmax_of(tspec, 2.0) == jg.hmax_of(jspec, 2.0)


def test_plan_matches_jax_open_box():
    _, jspec, tspec = _plans(8, periodic=False)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)


@pytest.mark.parametrize("k_cell", [None, 4])
@pytest.mark.parametrize("n_side", [8, 16])
def test_binning_matches_jax_exactly(n_side, k_cell):
    ic, jspec, tspec = _plans(n_side)
    if k_cell is not None:      # too small for every cell: both overflow
        jspec = dataclasses.replace(jspec, k_cell=k_cell)
        tspec = dataclasses.replace(tspec, k_cell=k_cell)
    jb = jg.bin_particles(jspec, jnp.asarray(ic["r"]))
    tb = tg.bin_particles(tspec, _t(ic["r"]))
    np.testing.assert_array_equal(tb.cell_of.numpy(), _n(jb.cell_of))
    np.testing.assert_array_equal(tb.slot_of.numpy(), _n(jb.slot_of))
    assert bool(tb.overflow) == bool(jb.overflow) == (k_cell is not None)
    if k_cell is None:
        x = np.random.default_rng(1).standard_normal((len(ic["m"]), 3))
        jd = jg.to_dense(jspec, jb, jnp.asarray(x))
        td = tg.to_dense(tspec, tb, _t(x))
        np.testing.assert_array_equal(td.numpy(), _n(jd))
        np.testing.assert_array_equal(tg.dense_fill_mask(tspec, tb).numpy(),
                                      _n(jg.dense_fill_mask(jspec, jb)))
        np.testing.assert_array_equal(tg.from_dense(tspec, tb, td).numpy(),
                                      x)


def _dense_inputs(n_side, periodic=True):
    ic, jspec, tspec = _plans(n_side, periodic)
    jb = jg.bin_particles(jspec, jnp.asarray(ic["r"]))
    d = lambda x: jg.to_dense(jspec, jb, jnp.asarray(x))  # noqa: E731
    dense = {"r": d(ic["r"]), "v": d(ic["v"]), "m": d(ic["m"]),
             "h": d(ic["h"]), "u": d(ic["u"])}
    return ic, jspec, tspec, jb, dense, jg.dense_fill_mask(jspec, jb)


def _assert_rel(got, want, fill, name):
    got, want = np.asarray(got)[fill], np.asarray(want)[fill]
    err = np.max(np.abs(got - want) / np.abs(want))
    assert err <= TOL, f"{name}: relative error {err:.3e}"


def _assert_scaled(got, want, fill, name):
    got, want = np.asarray(got)[fill], np.asarray(want)[fill]
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= TOL, f"{name}: error {err:.3e} of max"


@pytest.mark.parametrize("n_side,periodic", [(8, True), (16, True),
                                             (8, False)])
def test_density_matches_jax(n_side, periodic):
    _, jspec, tspec, _, dense, fill = _dense_inputs(n_side, periodic)
    hmax = jg.hmax_of(jspec, 2.0)
    jd = jg.density_grid27(jax_kernel("m4", 3), jspec, H_FAC, H_CONV,
                           dense["r"], dense["m"], dense["h"], fill, hmax)
    td = tg.density_grid27(kernel_factory("m4", 3), tspec, H_FAC, H_CONV,
                           _t(dense["r"]), _t(dense["m"]), _t(dense["h"]),
                           _t(fill), hmax)
    f = np.asarray(fill)
    for name in ("h", "rho", "invomega", "hfactor"):
        _assert_rel(getattr(td, name).numpy(), getattr(jd, name), f, name)
    _assert_scaled(td.zeta.numpy(), jd.zeta, f, "zeta")
    # an open box's edge particles run past 0.99 hmax: both flag it
    assert bool(td.overflow) == bool(jd.overflow) == (not periodic)


DISSIPATION = [("mon97", "none"), ("mon97", "wadsley2008"),
               ("none", "none"), ("mon97mm97", "price2008")]


@pytest.mark.parametrize("avisc,acond", DISSIPATION)
def test_forces_match_jax(avisc, acond):
    ic, jspec, tspec, jb, dense, fill = _dense_inputs(8)
    hmax = jg.hmax_of(jspec, 2.0)
    jk = jax_kernel("m4", 3)
    jd = jg.density_grid27(jk, jspec, H_FAC, H_CONV, dense["r"], dense["m"],
                           dense["h"], fill, hmax)
    u, press, sound = JaxAdiabatic(gamma=1.4).thermal_update(
        jnp.maximum(jd.rho, 1e-30), dense["u"])
    alpha = np.random.default_rng(2).uniform(0.1, 1.0, len(ic["m"]))
    fields = {"r": dense["r"], "v": dense["v"], "m": dense["m"],
              "h": jd.h, "rho": jd.rho, "u": u, "pressure": press,
              "sound": sound, "invomega": jd.invomega,
              "hfactor": jd.hfactor,
              "alpha": jg.to_dense(jspec, jb, jnp.asarray(alpha))}
    kw = dict(alpha_visc=1.0, alpha_visc_min=0.1, beta_visc=2.0)
    jvisc = jforces.ArtificialViscosity(
        avisc=jforces._AVISC_CODES[avisc],
        acond=jforces._ACOND_CODES[acond], **kw)
    tvisc = tforces.ArtificialViscosity(
        avisc=tforces._AVISC_CODES[avisc],
        acond=tforces._ACOND_CODES[acond], **kw)
    jout = jg.forces_grid27(jk, jvisc, jspec, fields, fill)
    tout = tg.forces_grid27(kernel_factory("m4", 3), tvisc, tspec,
                            {k: _t(x) for k, x in fields.items()}, _t(fill))
    f = np.asarray(fill)
    for name, got, want in zip(("a", "dudt", "div_v", "dalphadt"),
                               tout, jout):
        if name == "dalphadt" and avisc != "mon97mm97":
            assert not np.any(got.numpy())
            continue
        _assert_scaled(got.numpy(), want, f, name)


@pytest.mark.parametrize("periodic", [True, False])
def test_hydro_pass_matches_jax(periodic):
    ic, jspec, tspec = _plans(8, periodic)
    jbox, tbox = _box(periodic)
    js = jax_state(ic["r"], ic["v"], ic["m"], ic["h"], ic["u"])
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js)
              if getattr(js, f.name) is not None}
    ts = state_from_numpy(fields, dtype=torch.float64)
    args = (H_FAC, H_CONV, True)
    jvisc = jforces.ArtificialViscosity()
    tvisc = tforces.ArtificialViscosity()
    jout = jg.hydro_pass_grid27(jax_kernel("m4", 3), jvisc, jbox, jspec,
                                JaxAdiabatic(gamma=1.4), *args, js)
    tout = tg.hydro_pass_grid27(kernel_factory("m4", 3), tvisc, tbox, tspec,
                                Adiabatic(gamma=1.4), *args, ts)
    every = np.ones(len(ic["m"]), bool)
    for name in ("h", "rho", "invomega", "hfactor", "u", "pressure",
                 "sound"):
        _assert_rel(getattr(tout, name).numpy(), getattr(jout, name), every,
                    name)
    for name in ("zeta", "a", "dudt", "div_v"):
        _assert_scaled(getattr(tout, name).numpy(), getattr(jout, name),
                       every, name)
    assert bool(tout.neib_overflow) == bool(jout.neib_overflow) \
        == (not periodic)
