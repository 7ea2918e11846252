"""Guards of the PyTorch port: no module of it imports JAX or the JAX
package (an AST scan) and running it never loads JAX, whatever
GANDALF_PRECISION says (the self-gravitating, block-timestep, MFV,
N-body and sink slices, block-stepped smooth accretion, the cd2010
switch, a dusty box, an SM2012 tube, an external potential and the
radws box and cluster with radiative feedback, a quintic box, a step
of the Spitzer sphere under each radiation scheme and the 1D and 2D
self-gravitating disc, MFV's too, included);
chip_smoke.py
refuses to run without
a GPU, a missing C++ tree planner raises, a kernel wrapper refuses CPU
tensors, and on a GPU each CUDA kernel agrees with its plain PyTorch
version.

This file imports no JAX, so its CUDA test also runs on a machine
without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_guards.py``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _env(precision=None):
    env = dict(os.environ)
    env.pop("GANDALF_PRECISION", None)
    if precision is not None:
        env["GANDALF_PRECISION"] = precision
    env["PYTHONPATH"] = str(REPO)
    return env


def _imported_roots(path: Path):
    """(line, top-level name) of every import in a source file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    """Every .py of gandalf_tpu_torch/ and chip_smoke.py: no import of
    jax or gandalf_tpu, at any depth of the file."""
    files = sorted((REPO / "gandalf_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{f.relative_to(REPO)}:{line} imports {name}"
           for f in files for line, name in _imported_roots(f)
           if name in ("jax", "jaxlib", "gandalf_tpu")]
    assert not bad, bad


def test_port_never_imports_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import gandalf_tpu_torch\n"
        "from gandalf_tpu_torch.check import jittered_box_ic, slice_params\n"
        "from gandalf_tpu_torch.sim.simulation import GradhSphSimulation\n"
        "p = slice_params(8)\n"
        "sim = GradhSphSimulation(p, device='cpu', dtype=torch.float64)\n"
        "sim.SetupSimulation(jittered_box_ic(p, 8))\n"
        "sim.main_loop_step()\n"
        "sim.main_loop_step()\n"
        "assert sim.Nsteps == 2 and sim.t > 0.0\n"
        "p = slice_params(8, self_gravity=1)\n"
        "sim = GradhSphSimulation(p, device='cpu', dtype=torch.float64)\n"
        "sim.SetupSimulation(jittered_box_ic(p, 8))\n"
        "sim.main_loop_step()\n"
        "sim.main_loop_step()\n"
        "assert sim.Nsteps == 2 and bool((sim.state.gpot > 0).all())\n"
        "from gandalf_tpu_torch.check import sphere_block_params\n"
        "sim = GradhSphSimulation(sphere_block_params(300), device='cpu',\n"
        "                         dtype=torch.float64)\n"
        "sim.SetupSimulation()\n"
        "sim.main_loop_step()\n"
        "assert sim.use_block and sim.Nsteps == 1 and sim.active_rows > 0\n"
        "from gandalf_tpu_torch.check import mfv_params\n"
        "from gandalf_tpu_torch.sim.simulation import SimulationBase\n"
        "p = mfv_params(8, self_gravity=1)\n"
        "sim = SimulationBase.factory(p, 'cpu', torch.float64)\n"
        "sim.SetupSimulation(jittered_box_ic(p, 8))\n"
        "sim.main_loop_step()\n"
        "sim.main_loop_step()\n"
        "assert sim.Nsteps == 2 and bool((sim.state.gpot > 0).all())\n"
        "from gandalf_tpu_torch.check import nbody_params\n"
        "sim = SimulationBase.factory(nbody_params(64), 'cpu')\n"
        "sim.SetupSimulation()\n"
        "sim.main_loop_step()\n"
        "assert sim.Nsteps == 1 and sim.t > 0.0\n"
        "from gandalf_tpu_torch.check import bb_params\n"
        "sim = GradhSphSimulation(bb_params(300, rho_sink=2.0e-17),\n"
        "                         device='cpu', dtype=torch.float64)\n"
        "sim.SetupSimulation()\n"
        "sim.main_loop_step()\n"
        "assert bool(sim.state.sinks.active.any())\n"
        "from gandalf_tpu_torch.check import plummer_block_params\n"
        "sim = GradhSphSimulation(plummer_block_params(128, 4),\n"
        "                         device='cpu', dtype=torch.float64)\n"
        "sim.SetupSimulation()\n"
        "sim.main_loop_step()\n"
        "assert sim.use_block and sim.smooth_accretion\n"
        "from gandalf_tpu_torch.check import sod_params\n"
        "p = sod_params(64, 16)\n"
        "p.set('time_dependent_avisc', 'cd2010')\n"
        "sim = GradhSphSimulation(p, device='cpu', dtype=torch.float64)\n"
        "sim.SetupSimulation()\n"
        "sim.main_loop_step()\n"
        "assert float(sim.state.alpha.max()) > 0.1\n"
        "from gandalf_tpu_torch.check import dustybox_params\n"
        "sim = GradhSphSimulation(dustybox_params(16, 1), device='cpu',\n"
        "                         dtype=torch.float64)\n"
        "sim.SetupSimulation()\n"
        "sim.main_loop_step()\n"
        "assert sim.has_dust and bool((sim.state.ptype == 3).any())\n"
        "from gandalf_tpu_torch.check import sm2012_params\n"
        "sim = SimulationBase.factory(sm2012_params(sod_params(64, 16)),\n"
        "                             'cpu', torch.float64)\n"
        "sim.SetupSimulation()\n"
        "sim.main_loop_step()\n"
        "assert float(sim.state.invomega.min()) == 1.0\n"
        "p = slice_params(6)\n"
        "p.set('external_potential', 'vertical')\n"
        "sim = GradhSphSimulation(p, device='cpu', dtype=torch.float64)\n"
        "sim.SetupSimulation(jittered_box_ic(p, 6))\n"
        "sim.main_loop_step()\n"
        "assert sim.Nsteps == 1\n"
        "p = slice_params(6)\n"
        "p.set('kernel', 'quintic')\n"
        "sim = GradhSphSimulation(p, device='cpu', dtype=torch.float64)\n"
        "sim.SetupSimulation(jittered_box_ic(p, 6))\n"
        "sim.main_loop_step()\n"
        "assert sim.kern.variant == 'quintic' and sim.Nsteps == 1\n"
        "from gandalf_tpu_torch.check import (plummer_stars_params,\n"
        "                                     radfb_params, radws_params)\n"
        "p = radws_params(slice_params(6, self_gravity=1))\n"
        "sim = GradhSphSimulation(p, device='cpu', dtype=torch.float64)\n"
        "sim.SetupSimulation(jittered_box_ic(p, 6))\n"
        "sim.main_loop_step()\n"
        "assert sim.use_radws_energy and sim.Nsteps == 1\n"
        "sim = GradhSphSimulation(radfb_params(plummer_stars_params(128, 4)),\n"
        "                         device='cpu', dtype=torch.float64)\n"
        "sim.SetupSimulation()\n"
        "sim.main_loop_step()\n"
        "assert sim.rad_fb and bool(torch.isfinite(sim.state.ueq).all())\n"
        "from gandalf_tpu_torch.check import spitzer_sim\n"
        "for scheme in ('ionisation', 'treeray', 'monoionisation'):\n"
        "    sim = spitzer_sim(300, scheme, 'cpu', torch.float64,\n"
        "                      Nphotonratio=1.0)\n"
        "    sim.main_loop_step()\n"
        "    assert bool((sim.state.ionfrac <= 1).all())\n"
        "from gandalf_tpu_torch.check import block_sod_params, sedov_params\n"
        "for p in (block_sod_params(3, 64, 16), sedov_params(12, 3)):\n"
        "    sim = GradhSphSimulation(p, device='cpu', dtype=torch.float64)\n"
        "    sim.SetupSimulation()\n"
        "    sim.main_loop_step()\n"
        "    assert sim.use_block and sim.ndim < 3 and sim.active_rows > 0\n"
        "from gandalf_tpu_torch.check import disc_params\n"
        "for p in (disc_params(300, 2), disc_params(300, 2, nlevels=4),\n"
        "          disc_params(300, 2, sim='mfvmuscl'), disc_params(64, 1)):\n"
        "    sim = SimulationBase.factory(p, 'cpu', torch.float64)\n"
        "    sim.SetupSimulation()\n"
        "    sim.main_loop_step()\n"
        "    assert sim.ndim < 3 and bool((sim.state.gpot > 0).all())\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'gandalf_tpu')))\n")
    # GANDALF_PRECISION makes the JAX package import JAX: set, it must
    # make no difference to the port
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_env("double"), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_defines_each_name_once():
    """chip_smoke.py's phases share one module: a second top-level
    function or constant of the same name would silently replace the
    first and break the phases that call it."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)]
    dup = sorted({n for n in names if names.count(n) > 1})
    assert not dup, dup


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_plain_versions_on_gpu(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gandalf_tpu_torch.check import (block_sod_params,
                                         compare_active_kernels,
                                         compare_kernels,
                                         compare_mfv_kernels,
                                         compare_tree_kernels,
                                         jittered_box_ic, khi_params,
                                         mfv_params, slice_params,
                                         sphere_block_params)
    from gandalf_tpu_torch.sim.simulation import (GradhSphSimulation,
                                                  SimulationBase)

    p = slice_params(16, self_gravity=1)
    sim = GradhSphSimulation(p, device="cuda", dtype=dtype)
    sim.SetupSimulation(jittered_box_ic(p, 16))
    report = compare_kernels(sim, sim.state)
    report.update(compare_tree_kernels(sim, sim.state))
    # K8, K9 and the group-list K6/K7 on the block slice's sphere, for
    # every third particle
    sim = GradhSphSimulation(sphere_block_params(2000), device="cuda",
                             dtype=dtype)
    sim.SetupSimulation()
    idx = torch.arange(0, sim.state.N, 3, dtype=torch.int32, device="cuda")
    report.update(compare_active_kernels(sim, sim.state, idx))
    # K8 and K9 at ndim 1 and 2: the block Sod tube and the small KHI
    for p in (block_sod_params(4), khi_params(1, nlevels=3)):
        sim = GradhSphSimulation(p, device="cuda", dtype=dtype)
        sim.SetupSimulation()
        idx = torch.arange(0, sim.state.N, 3, dtype=torch.int32,
                           device="cuda")
        report.update(compare_active_kernels(sim, sim.state, idx))
    # K10-K12 and K7's MFV mode on the MFV box after two steps
    p = mfv_params(16, self_gravity=1)
    sim = SimulationBase.factory(p, "cuda", dtype)
    sim.SetupSimulation(jittered_box_ic(p, 16))
    sim.main_loop_steps(2)
    report.update(compare_mfv_kernels(sim, sim.state))
    torch.cuda.synchronize()
    assert all(r["ok"] for r in report.values()), report


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mfv_option_kernels_match_plain_versions_on_gpu(dtype):
    """K10-K12 in 1D and 2D with K12 in every Riemann solver, limiter
    class, time scheme and face velocity, and K31 for both limiters,
    against their plain versions (chip_smoke.py's mfv_option_kernels at
    its small sizes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gandalf_tpu_torch.check import (compare_mfv_kernels,
                                         mfv_khi_params, mfv_sod_params)
    from gandalf_tpu_torch.ops.mfv import MfvConfig
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    report = {}
    for params in (mfv_sod_params(128, 32), mfv_khi_params(16)):
        sim = SimulationBase.factory(params, "cuda", dtype)
        sim.SetupSimulation()
        sim.main_loop_steps(2)
        cfgs = [MfvConfig(gamma=sim.mfv_cfg.gamma, riemann=rs,
                          slope_limiter=lim, time_scheme=ts,
                          static_particles=st)
                for rs in ("hllc", "exact")
                for lim in ("gizmo", "tvdscalar", "null", "zeroslope")
                for ts in ("muscl", "rk2") for st in (False, True)]
        report.update(compare_mfv_kernels(
            sim, sim.state, flux_cfgs=cfgs,
            sweeps=["tvdscalar", "springel2009"]))
    torch.cuda.synchronize()
    assert all(r["ok"] for r in report.values()), report


def _option_sims(dtype):
    """(tag, simulation) of each K6/K7 option after setup on the card:
    the Jeans box with the Ewald sum, the slab and the cylinder, the MFV
    box with it, and the 16^3 box with gadget2 (after two steps, so that
    a0 is set), eigenmac and the fast quadrupoles."""
    from gandalf_tpu_torch.check import (jeans_params, jittered_box_ic,
                                         mfv_params, slice_params)
    from gandalf_tpu_torch.sim.simulation import SimulationBase

    sims = []
    sim = SimulationBase.factory(jeans_params(16), "cuda", dtype)
    sim.SetupSimulation()
    sims.append(("jeans", sim))
    for ic, per in (("ewaldslab", "xy"), ("ewaldcylinder", "z")):
        p = jeans_params(16)
        p.set("ic", ic)
        for k, axis in enumerate("xyz"):
            p.set(f"boxmin[{k}]", -0.5)
            p.set(f"boxmax[{k}]", 0.5)
            side = "periodic" if axis in per else "open"
            p.set(f"boundary_lhs[{k}]", side)
            p.set(f"boundary_rhs[{k}]", side)
        sim = SimulationBase.factory(p, "cuda", dtype)
        sim.SetupSimulation()
        sims.append((ic, sim))
    p = mfv_params(16, self_gravity=1)
    p.set("ewald", 1)
    sim = SimulationBase.factory(p, "cuda", dtype)
    sim.SetupSimulation(jittered_box_ic(p, 16))
    sims.append(("mfv_ewald", sim))
    for key, value in (("gravity_mac", "gadget2"),
                       ("gravity_mac", "eigenmac"),
                       ("multipole", "fast_quadrupole")):
        p = slice_params(16, self_gravity=1)
        p.set(key, value)
        sim = SimulationBase.factory(p, "cuda", dtype)
        sim.SetupSimulation(jittered_box_ic(p, 16))
        sim.main_loop_steps(2)
        sims.append((value, sim))
    return sims


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tree_options_match_plain_versions_on_gpu(dtype):
    """K6 and K7 in their Ewald (fully periodic, slab, cylinder; SPH and
    MFV zeta), gadget2, eigenmac and fast-multipole modes against their
    plain versions on the card, with the group-list launches of each SPH
    option."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gandalf_tpu_torch.check import compare_tree_kernels

    report = {}
    for tag, sim in _option_sims(dtype):
        rep = compare_tree_kernels(sim, sim.state,
                                   listed=not tag.startswith("mfv"))
        report.update({f"{tag}_{k}": r for k, r in rep.items()})
    torch.cuda.synchronize()
    bad = {k: r.get("scaled_err", r) for k, r in report.items()
           if not r["ok"]}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [2, 1])
def test_tree_dims_kernels_match_plain_versions_on_gpu(ndim, dtype):
    """K4-K7 at ndim 1 and 2 against their plain versions on the card in
    every walk option of chip_smoke.py's tree_kernels_dims, on the disc
    and the rod of check.disc_params at about 1,000 particles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gandalf_tpu_torch.check import compare_tree_kernels_dims

    report = compare_tree_kernels_dims(ndim, "cuda", dtype, n_target=1000)
    bad = {k: r.get("scaled_err", r) for k, r in report.items()
           if not r["ok"]}
    assert not bad, bad


def test_tree_dims_wrappers_refuse_cpu_tensors_and_the_ewald_sum():
    """K4-K7 on 1D and 2D tables: CPU tensors raise and count no launch;
    the Ewald sum below 3D raises with the JAX package's reason, in the
    wrappers and in the plain versions' dispatch."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.ops import tree
    from gandalf_tpu_torch.ops.tree import plan_tree

    before = dict(_ext.LAUNCHES)
    spec = plan_tree(64)
    gmap = torch.arange(64, dtype=torch.int32).reshape(2, 32)
    f64 = dict(dtype=torch.float64)
    for nd in (1, 2):
        lay = tree.layout(nd)
        r = torch.rand((64, nd), **f64)
        with pytest.raises(ValueError, match="CUDA"):
            _ext.tree_gather(spec, gmap, r, r[:, 0], None, None, None)
        ptab = torch.zeros((64, lay.pcols), **f64)
        ctab = torch.zeros(((2 << spec.depth) - 1, lay.ccols), **f64)
        alive = torch.ones((64,), dtype=torch.bool)
        with pytest.raises(ValueError, match="CUDA"):
            _ext.tree_build(spec, ptab, alive)
        with pytest.raises(ValueError, match="CUDA"):
            _ext.tree_walk(spec, ctab, ptab, alive)
        with pytest.raises(NotImplementedError, match="requires a 3D box"):
            tree.tree_walk(spec, ctab, ptab, alive,
                           ewald=(None, [1.0] * nd))
        with pytest.raises(NotImplementedError, match="requires a 3D box"):
            tree.tree_near(spec, None, ctab, ptab, alive, None, None, None,
                           None, 64, ewald=(None, [1.0] * nd))
    assert _ext.LAUNCHES == before


def test_tree_option_wrappers_check_their_inputs():
    """K6 with an accuracy MAC needs its per-group factor, and K7 with
    the fast multipoles takes K6's expansions and no far potential; the
    wrappers raise before any launch."""
    import dataclasses

    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.ops.tree import plan_tree

    before = dict(_ext.LAUNCHES)
    g2 = dataclasses.replace(plan_tree(64), mac="gadget2")
    f64 = dict(dtype=torch.float64)
    rows = (2 << g2.depth) - 1
    ctab, ptab = torch.zeros((rows, 16), **f64), torch.zeros((64, 6), **f64)
    alive = torch.ones((64,), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        _ext.tree_walk(g2, ctab, ptab, alive)
    assert _ext._MACS["eigenmac"] == 2
    fast = dataclasses.replace(plan_tree(64), fast=True)
    near = torch.full((2, fast.near_cap), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        _ext.tree_near(fast, None, ctab, ptab, alive, near,
                       torch.zeros((2, 13), **f64), torch.zeros((64,), **f64),
                       torch.arange(64, dtype=torch.int32), 64)
    assert _ext.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nbody_kernels_match_plain_versions_on_gpu(dtype):
    """K13-K15 against their plain versions on the card: the 2D binary,
    and Plummer clusters of 300 and 1,000 stars (not multiples of the
    kernels' tile of 128) with one coincident pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gandalf_tpu_torch.check import (compare_nbody_kernels,
                                         nbody_kernel_inputs)

    report = {}
    for n in (2, 300, 1000):
        (r, v, m, h), kern = nbody_kernel_inputs(n, "cuda", dtype)
        for name, rep in compare_nbody_kernels(r, v, m, h, kern).items():
            report[f"{name}_{n}"] = rep
    torch.cuda.synchronize()
    assert all(r["ok"] for r in report.values()), report


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sink_kernels_match_plain_versions_on_gpu(dtype):
    """K16-K18 against their plain versions on the card: synthetic inputs
    with the edge cases (check.sink_kernel_inputs) at 1,000 gas particles
    with 16 and 64 slots, then a Boss-Bodenheimer cloud of about 3,000
    particles after two steps (two sinks, their eaten gas dead), with K4
    in its alive mode and K5-K7 over the dead particles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gandalf_tpu_torch.check import (bb_params, compare_sink_kernels,
                                         compare_tree_kernels,
                                         sim_sink_inputs, sink_kernel_inputs)
    from gandalf_tpu_torch.kernels.smoothing import kernel_factory
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    report = {}
    for ns in (16, 64):
        rep = compare_sink_kernels(kernel_factory("m4", 3),
                                   sink_kernel_inputs(1000, ns, "cuda",
                                                      dtype))
        report.update({f"{k}_{ns}": r for k, r in rep.items()})
    sim = GradhSphSimulation(bb_params(3000, rho_sink=2.0e-17),
                             device="cuda", dtype=dtype)
    sim.SetupSimulation()
    sim.main_loop_steps(2)
    assert int((~sim.state.alive).sum()) > 2
    rep = compare_sink_kernels(sim.kern, sim_sink_inputs(sim))
    rep.update(compare_tree_kernels(sim, sim.state))
    assert rep["tree_gather"]["alive_input"]
    report.update({f"bb_{k}": r for k, r in rep.items()})
    torch.cuda.synchronize()
    bad = {k: r.get("scaled_err", r) for k, r in report.items()
           if not r["ok"]}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_td_sink_kernels_match_plain_versions_on_gpu(dtype):
    """K20-K22 against their plain versions on the card: K20 on
    check.smooth_accretion_inputs at 2,000 gas particles with 16 and 64
    slots (the lower slot takes a tie, gas goes whole and in part); K21
    at ndim 1, 2 and 3 (the Sod tube, the small KHI and the 16^3 box
    with cd2010 after a step) and K22 on the block Plummer sphere after
    two ticks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gandalf_tpu_torch.check import (compare_td_sink_kernels,
                                         jittered_box_ic, khi_params,
                                         plummer_block_params, slice_params,
                                         smooth_accretion_inputs, sod_params)
    from gandalf_tpu_torch.kernels.smoothing import kernel_factory
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    report = {}
    for ns in (16, 64):
        rep = compare_td_sink_kernels(
            kernel_factory("m4", 3),
            smooth_inputs=smooth_accretion_inputs(2000, ns, "cuda", dtype))
        assert rep["smooth_accretion"]["whole"] > 0
        report.update({f"{k}_{ns}": r for k, r in rep.items()})
    for params, ic in ((sod_params(), None), (khi_params(1), None),
                       (slice_params(16), True)):
        params.set("time_dependent_avisc", "cd2010")
        sim = GradhSphSimulation(params, device="cuda", dtype=dtype)
        sim.SetupSimulation(jittered_box_ic(params, 16) if ic else None)
        sim.main_loop_step()
        report.update(compare_td_sink_kernels(sim=sim, state=sim.state))
    sim = GradhSphSimulation(plummer_block_params(512, 16), device="cuda",
                             dtype=dtype)
    sim.SetupSimulation()
    for _ in range(2):
        sim.main_loop_step()
    rep = compare_td_sink_kernels(sim=sim, state=sim.state)
    report.update({f"plummer_{k}": r for k, r in rep.items()})
    torch.cuda.synchronize()
    assert {"cullen_dehnen", "cullen_dehnen_2d", "cullen_dehnen_1d",
            "plummer_levelneib"} <= set(report)
    bad = {k: r.get("scaled_err", r) for k, r in report.items()
           if not r["ok"]}
    assert not bad, bad


def test_td_sink_wrappers_refuse_cpu_tensors():
    """K20-K22: CPU tensors raise and count no launch; the plain versions
    run only through ops.sinks', ops.forces' and ops.active_grid's
    dispatch on CPU tensors."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.ops.sph_grid27 import Grid27Spec

    f64 = dict(dtype=torch.float64)
    r, v = torch.rand((32, 3), **f64), torch.rand((32, 3), **f64)
    m = torch.rand((32,), **f64)
    rs, ms = torch.rand((4, 3), **f64), torch.rand((4,), **f64)
    alive = torch.ones((32,), dtype=torch.bool)
    act = torch.ones((4,), dtype=torch.bool)
    claim = torch.zeros((32,), dtype=torch.int32)
    spec = Grid27Spec(3, (2, 2, 2), (0.0,) * 3, (1.0,) * 3, 8,
                      (True,) * 3)
    ids = torch.full((2, 2, 2, 8), -1, dtype=torch.int32)
    level = torch.zeros((32,), dtype=torch.int32)
    kern = type("K", (), {"kernnorm": 1.0, "kernrange": 2.0})()
    visc = type("V", (), {"alpha_visc": 1.0, "alpha_visc_min": 0.1})()
    before = dict(_ext.LAUNCHES)
    for call in (lambda: _ext.smooth_accretion_sums(
                     r, v, m, m, m, alive, rs, rs, ms, ms, act, 2.0,
                     torch.tensor(0.1, **f64), 1.0, 0.1, 0.01, 0.01, 0.01),
                 lambda: _ext.smooth_accretion_apply(
                     r, v, m, m, claim, alive, rs, rs, rs, rs, ms, rs, act),
                 lambda: _ext.cullen_dehnen(spec, kern, visc, ids, r,
                                            torch.rand((32, 11), **f64)),
                 lambda: _ext.levelneib(spec, kern, ids, r, m, level)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _ext.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dust_kernels_match_plain_versions_on_gpu(dtype):
    """K23 and K24 against their plain versions on the card on
    check.dust_kernel_inputs at 2,000 particles: ndim 1, 2 and 3, the
    fixed and Epstein laws, two-fluid and test-particle, and the 3D mirror
    layout of tests/test_grid_mirror.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gandalf_tpu_torch.check import (MIRROR_MIXED, compare_dust_kernels,
                                         dust_kernel_inputs)
    from gandalf_tpu_torch.kernels.smoothing import kernel_factory
    from gandalf_tpu_torch.ops.dust import DragLaw

    report = {}
    for ndim, walls in ((1, None), (2, None), (3, None), (3, MIRROR_MIXED)):
        s, box, spec, dt = dust_kernel_inputs(2000, ndim, "cuda", dtype,
                                              walls=walls)
        for law, coeff in (("fixed", 2.0), ("epstein", 1.5)):
            for tp in (False, True):
                rep = compare_dust_kernels(kernel_factory("m4", ndim),
                                           DragLaw(law, coeff, True), tp, s,
                                           box, spec, dt)
                report.update({f"{k}_{ndim}_{walls is not None}_{law}_{tp}":
                               r for k, r in rep.items()})
    torch.cuda.synchronize()
    bad = {k: r["scaled_err"] for k, r in report.items() if not r["ok"]}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sm2012_kernels_match_plain_versions_on_gpu(dtype):
    """K25 and K26 against their plain versions on the card on
    check.sm2012_kernel_inputs at about 4,000 particles in 1, 2 and 3
    dims, alpha fixed and per particle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gandalf_tpu_torch.check import (compare_sm2012_kernels,
                                         sm2012_kernel_inputs)
    from gandalf_tpu_torch.kernels.smoothing import kernel_factory
    from gandalf_tpu_torch.ops.forces import ArtificialViscosity

    report = {}
    for ndim, side in ((1, 4096), (2, 64), (3, 16)):
        s, spec = sm2012_kernel_inputs(side, ndim, "cuda", dtype)
        for avisc in (1, 2):
            rep = compare_sm2012_kernels(
                kernel_factory("m4", ndim), ArtificialViscosity(avisc=avisc),
                1.4, 1.2, 0.01, spec, s)
            report.update({f"{k}_{avisc}": r for k, r in rep.items()})
    torch.cuda.synchronize()
    bad = {k: r for k, r in report.items() if not r["ok"]}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_family_kernels_match_plain_versions_on_gpu(dtype):
    """K2, K3, K8 and K9 (1-3 dims), K7 (3D) with the quintic, gaussian,
    tabulated M4 and tabulated quintic against their plain versions on
    the card (check.compare_family_kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gandalf_tpu_torch.check import compare_family_kernels

    report = {}
    for variant in ("quintic", "gaussian", "m4_tab", "quintic_tab"):
        for ndim in (1, 2, 3):
            rep = compare_family_kernels(variant, ndim, "cuda", dtype)
            report.update({f"{k}_{ndim}": r for k, r in rep.items()})
    torch.cuda.synchronize()
    bad = {k: r for k, r in report.items() if not r["ok"]}
    assert not bad, bad


def test_family_wrappers_refuse_cpu_tensors():
    """K2, K3, K7, K8 and K9 with the quintic: CPU tensors raise and count
    no launch."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.kernels.smoothing import kernel_factory
    from gandalf_tpu_torch.ops.forces import ArtificialViscosity
    from gandalf_tpu_torch.ops.sph_grid27 import Grid27Spec

    kern = kernel_factory("quintic", 3)
    f64 = dict(dtype=torch.float64)
    spec = Grid27Spec(3, (2, 2, 2), (0.0,) * 3, (1.0,) * 3, 8,
                      (True,) * 3)
    shape = (2, 2, 2, 8)
    x, x3 = torch.rand(shape, **f64), torch.rand(shape + (3,), **f64)
    fill = torch.ones(shape, dtype=torch.bool)
    idx = torch.arange(4, dtype=torch.int32)
    ids = torch.full(shape, -1, dtype=torch.int32)
    r = torch.rand((32, 3), **f64)
    m = torch.rand((32,), **f64)
    cell = torch.zeros((32,), dtype=torch.int32)
    before = dict(_ext.LAUNCHES)
    for call in (
            lambda: _ext.grid27_density(spec, kern, 1.2, 0.01, 1.0, x3, x,
                                        x, fill),
            lambda: _ext.grid27_forces(spec, kern, ArtificialViscosity(),
                                       x3, x3, torch.rand(shape + (9,),
                                                          **f64), fill),
            lambda: _ext.active_density(spec, kern, 1.2, 0.01, 1.0, idx,
                                        cell, ids, r, m, m)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _ext.LAUNCHES == before


def test_sm2012_wrappers_refuse_cpu_tensors():
    """K25 and K26: CPU tensors raise and count no launch; the plain
    versions run only through ops.sm2012's dispatch on CPU tensors."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.ops.forces import ArtificialViscosity
    from gandalf_tpu_torch.ops.sph_grid27 import Grid27Spec

    f64 = dict(dtype=torch.float64)
    n = 32
    spec = Grid27Spec(2, (2, 2), (0.0,) * 2, (1.0,) * 2, 8, (True,) * 2)
    ids = torch.full((2, 2, 8), -1, dtype=torch.int32)
    r, v = torch.rand((n, 2), **f64), torch.rand((n, 2), **f64)
    m, pk = torch.rand((n,), **f64), torch.rand((n, 8), **f64)
    kern = type("K", (), {"kernnorm": 1.0})()
    before = dict(_ext.LAUNCHES)
    for call in (lambda: _ext.sm2012_density(spec, kern, 1.2, 0.01, 1.0,
                                             ids, r, m, m, m),
                 lambda: _ext.sm2012_forces(spec, kern, ArtificialViscosity(),
                                            1.4, ids, r, v, pk)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _ext.LAUNCHES == before


def test_dust_wrappers_refuse_cpu_tensors():
    """K23 and K24: CPU tensors raise and count no launch; the plain
    versions run only through ops.dust's dispatch on CPU tensors."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.ops.dust import DragLaw
    from gandalf_tpu_torch.ops.sph_grid27 import Grid27Spec

    f64 = dict(dtype=torch.float64)
    n = 32
    spec = Grid27Spec(3, (2, 2, 2), (0.0,) * 3, (1.0,) * 3, 8,
                      (True,) * 3)
    ids = torch.full((2, 2, 2, 8), -1, dtype=torch.int32)
    r, vec = torch.rand((n, 3), **f64), torch.rand((n, 9), **f64)
    sc, m = torch.rand((n, 4), **f64), torch.rand((n,), **f64)
    pt = torch.zeros((n,), dtype=torch.int32)
    kern = type("K", (), {"kernnorm": 1.0, "kernnormdrag": 1.0})()
    before = dict(_ext.LAUNCHES)
    for call in (lambda: _ext.dust_drag_sums(spec, kern, DragLaw(), False,
                                             ids, n, r, vec, sc, pt, m),
                 lambda: _ext.dust_drag_deposit(spec, kern, ids, n, r, sc,
                                                pt, m, m)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _ext.LAUNCHES == before


def test_sink_wrappers_refuse_cpu_tensors():
    """K16-K18 and K4 with its alive input: CPU tensors raise and count
    no launch; the plain versions run only through ops.sph_gravity's,
    ops.sinks' and ops.tree's dispatch on CPU tensors."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.ops.tree import plan_tree

    f64 = dict(dtype=torch.float64)
    r, v = torch.rand((32, 3), **f64), torch.rand((32, 3), **f64)
    m, h = torch.rand((32,), **f64), torch.rand((32,), **f64)
    rs, ms, hs = torch.rand((4, 3), **f64), torch.rand((4,), **f64), \
        torch.rand((4,), **f64)
    alive = torch.ones((32,), dtype=torch.bool)
    act = torch.ones((4,), dtype=torch.bool)
    tspec = plan_tree(64)
    gmap = torch.arange(64, dtype=torch.int32).reshape(2, 32)
    r64 = torch.rand((64, 3), **f64)
    before = dict(_ext.LAUNCHES)
    for call in (lambda: _ext.star_gas_forces(r, m, h, rs, ms, hs, act),
                 lambda: _ext.sink_candidate(m, alive, 0.5, r, v, m, h),
                 lambda: _ext.accretion_sums(r, v, m, alive, rs, hs, act,
                                             2.0),
                 lambda: _ext.tree_gather(tspec, gmap, r64, r64[:, 0], None,
                                          None, None,
                                          torch.ones((64,),
                                                     dtype=torch.bool))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _ext.LAUNCHES == before


def test_missing_tree_planner_raises(monkeypatch, tmp_path):
    """Without the C++ planner (g++ could not build the port's copy of
    kdplan.cpp) the port raises; it has no numpy planner or worst-case
    cap law to fall back to."""
    import numpy as np

    from gandalf_tpu_torch import native
    from gandalf_tpu_torch.check import jittered_box_ic, slice_params
    from gandalf_tpu_torch.ops import tree
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    # no library built yet, and a compiler that fails
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libkdplan_missing.so")
    monkeypatch.setattr(native, "_build", lambda so: "g++: not found")
    r = np.random.default_rng(0).random((64, 3))
    with pytest.raises(RuntimeError, match="kdplan.cpp"):
        tree.plan_buckets_kd(r, 32)
    with pytest.raises(RuntimeError, match="kdplan.cpp"):
        tree.walk_stats_levels_native(r, np.arange(64, dtype=np.int32)
                                      .reshape(2, 32), 0.1)
    p = slice_params(8, self_gravity=1)
    sim = GradhSphSimulation(p, device="cpu", dtype=torch.float64)
    with pytest.raises(RuntimeError, match="kdplan.cpp"):
        sim.SetupSimulation(jittered_box_ic(p, 8))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper given CPU tensors raises; it never runs the plain
    version in the kernel's place."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.ops.sph_grid27 import Grid27Spec

    spec = Grid27Spec(ndim=3, ncells=(2, 2, 2), lo=(0.0,) * 3,
                      extents=(1.0,) * 3, k_cell=4, periodic=(True,) * 3)
    r = torch.rand((16, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        _ext.grid27_bin(spec, r)
    assert _ext.LAUNCHES["grid27_bin"] == 0
    from gandalf_tpu_torch.ops.tree import plan_tree

    tspec = plan_tree(64)
    gmap = torch.arange(64, dtype=torch.int32).reshape(2, 32)
    m = torch.ones((64,), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        _ext.tree_gather(tspec, gmap, torch.rand((64, 3),
                                                 dtype=torch.float64),
                         m, None, None, None)
    assert _ext.LAUNCHES["tree_gather"] == 0


def test_mfv_wrappers_refuse_cpu_tensors():
    """K10-K12 and K7's MFV mode: CPU tensors raise and count no launch;
    the MFV mode of K7 takes no group list."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.kernels.smoothing import kernel_factory
    from gandalf_tpu_torch.ops.mfv import MfvConfig
    from gandalf_tpu_torch.ops.mfv_grid27 import flux_modes
    from gandalf_tpu_torch.ops.sph_grid27 import Grid27Spec
    from gandalf_tpu_torch.ops.tree import plan_tree

    spec = Grid27Spec(ndim=3, ncells=(2, 2, 2), lo=(0.0,) * 3,
                      extents=(1.0,) * 3, k_cell=4, periodic=(True,) * 3)
    kern = kernel_factory("m4", 3)
    f64 = dict(dtype=torch.float64)
    ids = torch.arange(32, dtype=torch.int32).reshape(2, 2, 2, 4)
    r, x = torch.rand((32, 3), **f64), torch.rand((32,), **f64)
    before = dict(_ext.LAUNCHES)
    calls = (
        lambda: _ext.mfv_density(spec, kern, 1.2, 0.01, 0.2, ids, r, x, x),
        lambda: _ext.mfv_gradients(spec, kern, ids, r,
                                   torch.rand((32, 8), **f64)),
        lambda: _ext.mfv_fluxes(spec, kern,
                                flux_modes(MfvConfig(gamma=1.4)),
                                torch.tensor(1e-3, **f64), ids, r,
                                torch.rand((32, 41), **f64)))
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    tspec = plan_tree(64)
    with pytest.raises(NotImplementedError, match="all groups"):
        _ext.tree_near(tspec, kern, None, None, None, None, None, None,
                       None, 64, torch.zeros((1,), dtype=torch.int32),
                       zeta_scaling="mfv")
    assert _ext.LAUNCHES == before


def test_nbody_wrappers_refuse_cpu_tensors():
    """K13-K15: CPU tensors raise and count no launch; the plain versions
    run only through ops.gravity's dispatch on CPU tensors."""
    from gandalf_tpu_torch import _ext

    f64 = dict(dtype=torch.float64)
    r, v, a = (torch.rand((16, 3), **f64) for _ in range(3))
    m, h = torch.rand((16,), **f64), torch.rand((16,), **f64)
    before = dict(_ext.LAUNCHES)
    for call in (lambda: _ext.direct_nbody(r, v, m),
                 lambda: _ext.direct_softened(r, v, m, h, True),
                 lambda: _ext.direct_snap(r, v, a, m)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="shape"):
        _ext.direct_nbody(torch.rand((16, 4), **f64), v, m)
    assert _ext.LAUNCHES == before


def test_ptxas_report_keeps_each_kernels_lines(monkeypatch):
    """The build log's ptxas lines of each kernel, as ptxas wrote them;
    nothing else of the log."""
    from gandalf_tpu_torch import _ext

    kernel = [
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_117mfv_fluxes_kernelIfEEvPKiPKT_' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_117mfv_fluxes_kernelIfEEvPKiPKT_",
        "    48 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 128 registers, used 0 barriers"]
    log = "\n".join(["nvcc warning : something else", *kernel,
                     "ptxas info    : 0 bytes gmem"]) + "\n"
    monkeypatch.setattr(_ext, "build_log", lambda: log)
    assert _ext.ptxas_report().splitlines() == kernel


def test_controllers_default_to_the_card():
    """A controller built without a device runs on the card; with no
    CUDA device its setup raises instead of running the plain versions."""
    from gandalf_tpu_torch.check import mfv_params, slice_params
    from gandalf_tpu_torch.sim.simulation import (GradhSphSimulation,
                                                  SimulationBase)

    from gandalf_tpu_torch.check import nbody_params

    from gandalf_tpu_torch.check import disc_params

    sims = (SimulationBase.factory(mfv_params(8)),
            SimulationBase.factory(slice_params(8)),
            GradhSphSimulation(slice_params(8)),
            SimulationBase.factory(nbody_params(8)),
            SimulationBase.factory(disc_params(300, 2)),
            SimulationBase.factory(disc_params(300, 2, sim="mfvmuscl")),
            SimulationBase.factory(disc_params(64, 1)))
    assert [s.device.type for s in sims] == ["cuda"] * 7
    if torch.cuda.is_available():
        return
    for s in sims:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            s.SetupSimulation()
        assert s.state is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_radws_kernels_match_plain_versions_on_gpu(dtype):
    """K27-K29 against their plain versions on the card on
    check.radws_kernel_inputs at 4,000 elements on both tables (K27 also
    on a dense shape with empty slots), and K30 on
    check.ambient_kernel_inputs with 16 slots in every case of
    check.AMBIENT_CASES: no flip in float64, at most
    TOL_RADWS_FLIP_FRACTION in float32, the stated tolerances elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gandalf_tpu_torch.check import (ambient_kernel_inputs,
                                         compare_ambient_kernels,
                                         compare_radws_kernels,
                                         radws_kernel_inputs)

    report = {}
    for table in ("ideal", "nonideal"):
        rep = compare_radws_kernels(
            radws_kernel_inputs(4000, "cuda", dtype, table),
            dense_shape=(50, 40))
        report.update({f"{k}_{table}": r for k, r in rep.items()})
    report.update(compare_ambient_kernels(
        ambient_kernel_inputs(4000, 16, "cuda", dtype)))
    torch.cuda.synchronize()
    bad = {k: r for k, r in report.items() if not r["ok"]}
    assert not bad, bad


def test_radws_wrappers_refuse_cpu_tensors():
    """K27-K30: CPU tensors raise and count no launch; the plain versions
    run only through ops.radws' and ops.radiative_fb's dispatch on CPU
    tensors."""
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.ops.radws import make_ideal_table

    f64 = dict(dtype=torch.float64)
    tab = make_ideal_table()
    x = torch.rand((32,), **f64)
    r, rs = torch.rand((32, 3), **f64), torch.rand((4, 3), **f64)
    q = torch.rand((4,), **f64)
    act = torch.ones((4,), dtype=torch.bool)
    before = dict(_ext.LAUNCHES)
    for call in (lambda: _ext.radws_eos(tab, x, x),
                 lambda: _ext.radws_equilibrium(tab, x, x, x, x, x),
                 lambda: _ext.radws_implicit_heating(tab, x, x, x, x, x, x),
                 lambda: _ext.ambient_temperature(r, rs, q, q, act, act, 5.0,
                                                  None)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _ext.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_radiation_kernels_match_plain_versions_on_gpu(dtype):
    """K34-K37 against their plain versions on the card at the Spitzer
    sphere of 739 particles (4,096 packets) and K37 on three overlapping
    sources at 4,096 particles, with check.compare_radiation_kernels'
    tolerances and flag bands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gandalf_tpu_torch.check import (compare_radiation_kernels,
                                         radiation_kernel_inputs,
                                         spitzer_sim, stromgren_inputs)

    sim = spitzer_sim(700, "monoionisation", "cuda", dtype)
    report = compare_radiation_kernels(
        radiation_kernel_inputs(sim, n_packets=4096),
        stromgren=stromgren_inputs(4096, "cuda", dtype))
    bad = {k: r for k, r in report.items() if not r["ok"]}
    assert not bad, bad


def test_radiation_wrappers_refuse_cpu_tensors():
    """K34-K37: CPU tensors raise and count no launch; the plain versions
    run only through ops.treeray's, ops.mcrt's and ops.ionisation's
    dispatch on CPU tensors."""
    from types import SimpleNamespace

    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.ops.sph_grid27 import Grid27Spec

    f64 = dict(dtype=torch.float64)
    spec = Grid27Spec(3, (2, 2, 2), (0.0,) * 3, (1.0,) * 3, 8,
                      (False,) * 3)
    box = SimpleNamespace(ndim=3, lo=(0.0,) * 3, extents=(1.0,) * 3,
                          ncells=(2, 2, 2), periodic=(False,) * 3)
    n = 16
    cells = torch.zeros((n,), dtype=torch.int32)
    r, x = torch.rand((n, 3), **f64), torch.rand((n,), **f64)
    field = torch.rand((8,), **f64)
    before = dict(_ext.LAUNCHES)
    for call in (lambda: _ext.cell_field(spec, cells, cells, x, x, 1.0, 1.0),
                 lambda: _ext.ray_march(box, field, r, r[:, None, :],
                                        x[:, None], 8),
                 lambda: _ext.packet_march(box, field, r, r, 8, 0.1),
                 lambda: _ext.stromgren_prefix(
                     r, x, r[:2], x[:2], torch.ones(2, dtype=torch.bool),
                     8)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _ext.LAUNCHES == before
