"""Guards of the PyTorch port: no module of it imports JAX or the JAX
package (an AST scan) and running it never loads JAX, whatever
GANDALF_PRECISION says (the self-gravitating, block-timestep, MFV and
N-body slices included); chip_smoke.py refuses to run without a GPU, a missing
C++ tree planner raises, a kernel wrapper refuses CPU tensors, and on a
GPU each CUDA kernel agrees with its plain PyTorch version.

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
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'gandalf_tpu')))\n")
    # GANDALF_PRECISION makes the JAX package import JAX: set, it must
    # make no difference to the port
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_env("double"), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


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
    from gandalf_tpu_torch.check import (compare_active_kernels,
                                         compare_kernels,
                                         compare_mfv_kernels,
                                         compare_tree_kernels,
                                         jittered_box_ic, mfv_params,
                                         slice_params, sphere_block_params)
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
    # K10-K12 and K7's MFV mode on the MFV box after two steps
    p = mfv_params(16, self_gravity=1)
    sim = SimulationBase.factory(p, "cuda", dtype)
    sim.SetupSimulation(jittered_box_ic(p, 16))
    sim.main_loop_steps(2)
    report.update(compare_mfv_kernels(sim, sim.state))
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
        lambda: _ext.mfv_fluxes(spec, kern, MfvConfig(gamma=1.4),
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

    sims = (SimulationBase.factory(mfv_params(8)),
            SimulationBase.factory(slice_params(8)),
            GradhSphSimulation(slice_params(8)),
            SimulationBase.factory(nbody_params(8)))
    assert [s.device.type for s in sims] == ["cuda"] * 4
    if torch.cuda.is_available():
        return
    for s in sims:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            s.SetupSimulation()
        assert s.state is None
