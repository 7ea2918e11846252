"""Port parity: the grid path in 1D and 2D against gandalf_tpu's
(float64, CPU, plain versions of K1-K3), and the refusals that stay.

The inputs are the Sod tube (check.sod_params at 128 + 32 particles) and
the small Kelvin-Helmholtz instability (check.khi_params(1), 32x16 +
48x24), jittered by a numpy generator; the dense tensors the JAX code
builds are handed to the port, so each stage is compared on the same
inputs.  Then 10 controller steps of each through both packages, the
Sod tube's L1 gate in the port, periodic and between mirror walls, and
GANDALF's adsod.dat and khi.dat as written."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.kernels.smoothing import kernel_factory as jax_kernel
from gandalf_tpu.ops import forces as jforces
from gandalf_tpu.ops import sph_grid27 as jg
from gandalf_tpu.ops.eos import Adiabatic as JaxAdiabatic
from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu.state import DomainBox as JaxBox
from gandalf_tpu.state import make_sph_state as jax_state
from gandalf_tpu_torch import _ext
from gandalf_tpu_torch.check import (khi_params, mirror_params,
                                     published_params, sod_l1, sod_params)
from gandalf_tpu_torch.convert import grid_spec_from_jax, state_from_numpy
from gandalf_tpu_torch.kernels.smoothing import kernel_factory
from gandalf_tpu_torch.ops import forces as tforces
from gandalf_tpu_torch.ops import sph_grid27 as tg
from gandalf_tpu_torch.ops.eos import Adiabatic
from gandalf_tpu_torch.sim.ic import generate_ic
from gandalf_tpu_torch.sim.simulation import (GradhSphSimulation,
                                              SimulationBase)
from gandalf_tpu_torch.state import DomainBox

torch.set_num_threads(1)

TOL = 1e-10
TOL_SIM = 1e-9
H_FAC, H_CONV = 1.2, 0.01
SOD_L1_GATE = 9e-3

PARAMS = {"sod": lambda: sod_params(128, 32), "khi": lambda: khi_params(1)}


def _case(name, seed=3):
    """IC (jittered by 0.1 spacings so no pair sits on a lattice
    symmetry), the JAX and port boxes, and both plans."""
    p = PARAMS[name]()
    ic = generate_ic(p, None)
    nd = p.intparams["ndim"]
    box = DomainBox.from_params(p)
    args = (box.ndim, box.boxmin, box.boxmax, box.lhs, box.rhs)
    jbox, tbox = JaxBox(*args), DomainBox(*args)
    rng = np.random.default_rng(seed)
    spacing = min(box.size) / 32.0
    r = ic["r"] + 0.1 * spacing * rng.standard_normal(ic["r"].shape)
    lo, size = np.asarray(box.boxmin), np.asarray(box.size)
    ic["r"] = lo + np.mod(r - lo, size)
    ic["v"] = ic["v"] + 0.05 * rng.standard_normal((len(ic["m"]), nd))
    h_max = float(ic["h"].max()) * 1.3
    jspec = jg.plan_grid27(jbox, ic["r"], h_max, 2.0)
    tspec = tg.plan_grid27(tbox, ic["r"], h_max, 2.0)
    return ic, nd, jbox, tbox, jspec, tspec


def _t(x):
    return torch.tensor(np.array(x))


@pytest.mark.parametrize("name", ["sod", "khi"])
def test_plan_matches_jax(name):
    *_, jspec, tspec = _case(name)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert grid_spec_from_jax(jspec) == tspec
    assert tg.hmax_of(tspec, 2.0) == jg.hmax_of(jspec, 2.0)


@pytest.mark.parametrize("k_cell", [None, 2])
@pytest.mark.parametrize("name", ["sod", "khi"])
def test_binning_matches_jax_exactly(name, k_cell):
    ic, nd, _, _, jspec, tspec = _case(name)
    if k_cell is not None:      # too small for every cell: both overflow
        jspec = dataclasses.replace(jspec, k_cell=k_cell)
        tspec = dataclasses.replace(tspec, k_cell=k_cell)
    jb = jg.bin_particles(jspec, jnp.asarray(ic["r"]))
    tb = tg.bin_particles(tspec, _t(ic["r"]))
    np.testing.assert_array_equal(tb.cell_of.numpy(), np.asarray(jb.cell_of))
    np.testing.assert_array_equal(tb.slot_of.numpy(), np.asarray(jb.slot_of))
    assert bool(tb.overflow) == bool(jb.overflow) == (k_cell is not None)
    if k_cell is None:
        x = np.random.default_rng(1).standard_normal((len(ic["m"]), nd))
        jd = jg.to_dense(jspec, jb, jnp.asarray(x))
        td = tg.to_dense(tspec, tb, _t(x))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(
            tg.dense_fill_mask(tspec, tb).numpy(),
            np.asarray(jg.dense_fill_mask(jspec, jb)))
        np.testing.assert_array_equal(tg.from_dense(tspec, tb, td).numpy(),
                                      x)


def _dense_inputs(name):
    ic, nd, jbox, tbox, jspec, tspec = _case(name)
    jb = jg.bin_particles(jspec, jnp.asarray(ic["r"]))
    d = lambda x: jg.to_dense(jspec, jb, jnp.asarray(x))  # noqa: E731
    dense = {k: d(ic[k]) for k in ("r", "v", "m", "h", "u")}
    return ic, nd, jspec, tspec, jb, dense, jg.dense_fill_mask(jspec, jb)


def _err(got, want, fill, relative):
    got, want = np.asarray(got)[fill], np.asarray(want)[fill]
    if relative:
        return np.max(np.abs(got - want) / np.abs(want))
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("name", ["sod", "khi"])
def test_density_matches_jax(name):
    _, nd, jspec, tspec, _, dense, fill = _dense_inputs(name)
    hmax = jg.hmax_of(jspec, 2.0)
    jd = jg.density_grid27(jax_kernel("m4", nd), jspec, H_FAC, H_CONV,
                           dense["r"], dense["m"], dense["h"], fill, hmax)
    td = tg.density_grid27(kernel_factory("m4", nd), tspec, H_FAC, H_CONV,
                           _t(dense["r"]), _t(dense["m"]), _t(dense["h"]),
                           _t(fill), hmax)
    f = np.asarray(fill)
    for field in ("h", "rho", "invomega", "hfactor"):
        assert _err(getattr(td, field).numpy(), getattr(jd, field), f,
                    True) <= TOL, field
    assert _err(td.zeta.numpy(), jd.zeta, f, False) <= TOL
    assert bool(td.overflow) == bool(jd.overflow)


@pytest.mark.parametrize("avisc,acond", [("mon97", "none"),
                                         ("mon97mm97", "wadsley2008")])
@pytest.mark.parametrize("name", ["sod", "khi"])
def test_forces_match_jax(name, avisc, acond):
    ic, nd, jspec, tspec, jb, dense, fill = _dense_inputs(name)
    hmax = jg.hmax_of(jspec, 2.0)
    jk = jax_kernel("m4", nd)
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
    tout = tg.forces_grid27(kernel_factory("m4", nd), tvisc, tspec,
                            {k: _t(x) for k, x in fields.items()}, _t(fill))
    f = np.asarray(fill)
    assert tout[0].shape[-1] == nd
    for field, got, want in zip(("a", "dudt", "div_v", "dalphadt"),
                                tout, jout):
        if field == "dalphadt" and avisc != "mon97mm97":
            continue
        assert _err(got.numpy(), want, f, False) <= TOL, field


@pytest.mark.parametrize("name", ["sod", "khi"])
def test_hydro_pass_matches_jax(name):
    ic, nd, jbox, tbox, jspec, tspec = _case(name)
    js = jax_state(ic["r"], ic["v"], ic["m"], ic["h"], ic["u"])
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js)
              if getattr(js, f.name) is not None}
    ts = state_from_numpy(fields, dtype=torch.float64)
    args = (H_FAC, H_CONV, True)
    jout = jg.hydro_pass_grid27(jax_kernel("m4", nd),
                                jforces.ArtificialViscosity(), jbox, jspec,
                                JaxAdiabatic(gamma=1.4), *args, js)
    tout = tg.hydro_pass_grid27(kernel_factory("m4", nd),
                                tforces.ArtificialViscosity(), tbox, tspec,
                                Adiabatic(gamma=1.4), *args, ts)
    every = np.ones(len(ic["m"]), bool)
    for field in ("h", "rho", "invomega", "hfactor", "u", "pressure",
                  "sound"):
        assert _err(getattr(tout, field).numpy(), getattr(jout, field),
                    every, True) <= TOL, field
    for field in ("zeta", "a", "dudt", "div_v"):
        assert _err(getattr(tout, field).numpy(), getattr(jout, field),
                    every, False) <= TOL, field
    assert bool(tout.neib_overflow) == bool(jout.neib_overflow)


def _jax_params(params):
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp


def _assert_same(jsim, tsim, where):
    for f in ("r", "v", "u", "h", "rho"):
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        err = (np.max(np.abs(got - want))
               / max(np.max(np.abs(want)), 1e-300))
        assert err <= TOL_SIM, f"{where}: {f} differs by {err:.3e} of max"
    for f in ("t", "dt"):
        want = float(getattr(jsim.state, f))
        got = float(getattr(tsim.state, f))
        assert abs(got - want) <= TOL_SIM * abs(want), f"{where}: {f}"


@pytest.mark.parametrize("name", ["sod", "khi"])
def test_ten_steps_match_jax(name):
    """10 global steps of the Sod tube and the small KHI through both
    GradhSphSimulations, each package generating its own IC."""
    params = PARAMS[name]()
    jsim = JaxSim(_jax_params(params))
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(params.copy(), device="cpu",
                              dtype=torch.float64)
    tsim.SetupSimulation()
    assert grid_spec_from_jax(jsim.gridspec) == tsim.gridspec
    _assert_same(jsim, tsim, "bootstrap")
    for i in range(10):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _assert_same(jsim, tsim, f"step {i + 1}")
    assert tsim.Nsteps == jsim.Nsteps == 10


@pytest.mark.parametrize("mirror", [False, True])
def test_sod_l1_gate(mirror):
    """The Sod tube at the reference's resolution (512 + 128) to t = 0.5
    through the port's controller on the CPU: L1(vx) over -1 < x < 1
    below 9e-3 (tests/test_grid_path.py:29-43), periodic and with mirror
    walls at +-2 (no wave reaches them by t = 0.5)."""
    sim = GradhSphSimulation(sod_params(mirror=mirror), device="cpu",
                             dtype=torch.float64)
    sim.Run()
    assert sim.t == pytest.approx(0.5, abs=1e-12)
    assert sim.gridspec.mirror == (((0, 0), (0, 1)) if mirror else ())
    assert sod_l1(sim) < SOD_L1_GATE


@pytest.mark.parametrize("name", ["adsod", "khi"])
def test_published_examples_set_up(name):
    """GANDALF's examples/adsod.dat and khi.dat as written (no snapshots)
    set up and step on the CPU when asked; a few steps stay finite."""
    sim = SimulationBase.factory(published_params(name), "cpu",
                                 torch.float64)
    sim.SetupSimulation()
    sim.main_loop_steps(3)
    for f in ("r", "v", "u", "h", "rho"):
        assert torch.isfinite(getattr(sim.state, f)).all(), f
    assert sim.Nsteps >= 1


def _refused(params, item):
    sim = SimulationBase.factory(params, "cpu", torch.float64)
    with pytest.raises(NotImplementedError, match=item):
        sim.process_parameters()


@pytest.mark.parametrize("ndim", [1, 2])
def test_refusals_below_3d_name_their_items(ndim):
    """Self-gravity runs below 3D (tests/test_torch_gravity_dims_sim.py),
    but not the Ewald sum of a periodic box (ewald = 1, the default),
    which both controllers refuse with the JAX package's reason; sinks
    (item 9) stay 3D-only; block steps run below 3D
    (tests/test_torch_block_dims.py)."""
    ewald = "Ewald periodic self-gravity requires a 3D box"
    for key, value, item in (("self_gravity", 1, ewald),
                             ("create_sinks", 1, "item 9")):
        p = mirror_params(8, ndim, walls=())
        p.set(key, value)
        _refused(p, item)
    p = mirror_params(8, ndim, walls=())
    p.set("sim", "meshlessfv")
    p.set("self_gravity", 1)
    _refused(p, ewald)


def test_mirror_refusals_name_their_items():
    """Mirror walls with self-gravity, block steps or sinks are the JAX
    package's all-pairs path (item 8); MFV takes no walls."""
    for key, value, item in (("self_gravity", 1, "item 8"),
                             ("Nlevels", 3, "item 8"),
                             ("create_sinks", 1, "item 8")):
        p = mirror_params(8)
        p.set(key, value)
        _refused(p, item)
    p = mirror_params(8)
    p.set("sim", "meshlessfv")
    _refused(p, "items 8 and 10")


def test_kernels_refuse_z_slab_plans():
    """qz != 1 comes only from the distributed planner (item 13); the
    active-subset kernels (K8, K9) take 2D grids with the grid kernels'
    arguments and refuse only mirror layers (item 8)."""
    spec = tg.Grid27Spec(ndim=2, ncells=(4, 4), lo=(0.0, 0.0),
                         extents=(1.0, 1.0), k_cell=8,
                         periodic=(True, True))
    with pytest.raises(NotImplementedError, match="item 13"):
        _ext._grid_args_nd(dataclasses.replace(spec, qz=2))
    assert _ext._grid_args(spec) == _ext._grid_args_nd(spec) == (
        2, 4, 4, 1, 8, 1, 1, 0, 1.0, 1.0, 0.0)
    with pytest.raises(NotImplementedError, match="item 8"):
        _ext._grid_args(dataclasses.replace(spec, mirror=((1, 1), (0, 0))))
