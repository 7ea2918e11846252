"""Guards of the PyTorch port: it never imports JAX (the self-gravitating
and block-timestep slices included), chip_smoke.py refuses to run
without a GPU, a missing C++ tree planner raises, and on a GPU each CUDA
kernel agrees with its plain PyTorch version.

This file imports no JAX, so its CUDA test also runs on a machine
without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_guards.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _env_without_precision():
    env = dict(os.environ)
    env.pop("GANDALF_PRECISION", None)
    env["PYTHONPATH"] = str(REPO)
    return env


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
        "print('jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_env_without_precision(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "False"


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=_env_without_precision(),
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
                                         compare_tree_kernels,
                                         jittered_box_ic, slice_params,
                                         sphere_block_params)
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

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
    torch.cuda.synchronize()
    assert all(r["ok"] for r in report.values()), report


def test_missing_tree_planner_raises(monkeypatch):
    """Without the C++ planner (g++ could not build kdplan.cpp) the port
    raises; it has no numpy planner or worst-case cap law to fall back
    to."""
    import numpy as np

    import gandalf_tpu.native
    from gandalf_tpu_torch.check import jittered_box_ic, slice_params
    from gandalf_tpu_torch.ops import tree
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    monkeypatch.setattr(gandalf_tpu.native, "load", lambda: None)
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
