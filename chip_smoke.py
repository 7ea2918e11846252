"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives gandalf_tpu_torch's hydro-only grad-h SPH main path on the card
and checks it, in phases, each printing one line:

1. device: the card's name and power limit (nvidia-smi); refuses to run
   without CUDA;
2. build: compiles the CUDA kernels K1-K3 from csrc/ and prints the time;
3. kernels: each kernel against its plain PyTorch version on the card,
   at 16^3 and 32^3 particles, in float64 and float32;
4. parity: 5 steps of the slice at 16^3 in float64, kernels on the card
   against the plain path on the CPU;
5. main path: 64^3 = 262,144 particles in float32, setup, bootstrap and
   18 steps through main_loop_steps (16 timed), with launch counts,
   finiteness, overflow and energy checks, and each kernel's time beside
   its plain version's at the main path's shapes.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero
without printing the last line.  Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# the JAX package's __init__ imports JAX when this is set; the port
# reuses its host-only modules and must not
os.environ.pop("GANDALF_PRECISION", None)

import torch  # noqa: E402

N_MAIN = 64
STEPS_WARM = 2
STEPS_TIMED = 16
PARITY_STEPS = 5
PARITY_TOL = 1e-9
ENERGY_DRIFT_TOL = 1e-3

SOURCES = {
    "grid27_bin": ("gandalf_tpu_torch/csrc/grid27_bin.cu",
                   "gandalf_tpu/ops/sph_grid27.py:193"),
    "grid27_density": ("gandalf_tpu_torch/csrc/grid27_density.cu",
                       "gandalf_tpu/ops/sph_grid27.py:359"),
    "grid27_forces": ("gandalf_tpu_torch/csrc/grid27_forces.cu",
                      "gandalf_tpu/ops/sph_grid27.py:528"),
}


def phase(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def energy(s) -> float:
    e = s.m * (0.5 * torch.sum(s.v * s.v, dim=-1) + s.u)
    return float(torch.sum(e.double()))


def make_sim(n_side, device, dtype):
    from gandalf_tpu_torch.check import jittered_box_ic, slice_params
    from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

    params = slice_params(n_side)
    sim = GradhSphSimulation(params, device=device, dtype=dtype)
    return sim, jittered_box_ic(params, n_side)


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs only on a GPU")
    # the package first: without it nothing is printed
    from gandalf_tpu_torch import _ext
    from gandalf_tpu_torch.check import compare_kernels

    dev = torch.device("cuda", 0)
    card = card_line()
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=card,
          torch=torch.__version__, cuda=torch.version.cuda)
    print(card, flush=True)

    t0 = time.perf_counter()
    so = _ext.build()
    _ext.lib()
    regs = [ln.strip() for ln in _ext.build_log().splitlines()
            if "registers" in ln]
    phase("build", seconds=time.perf_counter() - t0, library=so.name,
          ptxas=regs)

    # 3. kernels against their plain versions at small sizes
    for n_side in (16, 32):
        for dtype in (torch.float64, torch.float32):
            sim, ic = make_sim(n_side, dev, dtype)
            sim.SetupSimulation(ic)
            rep = compare_kernels(sim, sim.state)
            torch.cuda.synchronize()
            phase("kernels", n_side=n_side, dtype=str(dtype), report=rep)
            bad = [k for k, r in rep.items() if not r["ok"]]
            if bad:
                raise RuntimeError(f"kernel disagrees with its plain "
                                   f"version: {bad}")

    # 4. end-to-end parity, kernels on the card against the plain CPU path
    sims = []
    for device in (dev, torch.device("cpu")):
        sim, ic = make_sim(16, device, torch.float64)
        sim.SetupSimulation(ic)
        for _ in range(PARITY_STEPS):
            sim.main_loop_step()
        sims.append(sim)
    torch.cuda.synchronize()
    errs = {}
    for f in ("r", "v", "u", "h", "rho"):
        x = getattr(sims[0].state, f).cpu()
        ref = getattr(sims[1].state, f)
        errs[f] = float(torch.abs(x - ref).max() / torch.abs(ref).max())
    errs["t"] = abs(sims[0].t - sims[1].t) / sims[1].t
    phase("parity", n_side=16, steps=PARITY_STEPS, rel_err=errs)
    if max(errs.values()) > PARITY_TOL:
        raise RuntimeError(f"kernel path disagrees with the plain path: "
                           f"{errs}")

    # 5. the main path at full size
    sim, ic = make_sim(N_MAIN, dev, torch.float32)
    _ext.reset_launches()
    t0 = time.perf_counter()
    sim.SetupSimulation(ic)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    e0 = energy(sim.state)
    done = 0
    while done < STEPS_WARM:
        done += sim.main_loop_steps(STEPS_WARM - done)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = 0
    while done < STEPS_TIMED:
        done += sim.main_loop_steps(STEPS_TIMED - done)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_ext.LAUNCHES)
    s = sim.state
    N = s.N
    finite = all(bool(torch.isfinite(getattr(s, f)).all())
                 for f in ("r", "v", "a", "u", "h", "rho", "dudt"))
    drift = abs(energy(s) - e0) / abs(e0)
    checks = {
        "finite": finite,
        "rho_positive": bool((s.rho > 0).all()),
        "no_overflow": not bool(s.neib_overflow),
        "launches": all(n >= sim.Nsteps + 1 for n in launches.values()),
        "energy_drift": drift < ENERGY_DRIFT_TOL,
    }
    rep = compare_kernels(sim, s, repeats=5)
    phase("main_path", N=N, ncells=list(sim.gridspec.ncells),
          k_cell=sim.gridspec.k_cell, steps=sim.Nsteps,
          timed_steps=STEPS_TIMED, setup_s=t_setup, timed_s=elapsed,
          particle_steps_per_s=N * STEPS_TIMED / elapsed,
          grid_replans=sim._n_grid_overflows, launches=launches,
          energy_drift=drift, checks=checks, kernels=rep, card=card,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, r in rep.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"main path checks failed: {failed}")

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": rep[name]["max_abs_err"],
                "ms": rep[name]["ms"], "plain_ms": rep[name]["plain_ms"]}
               for name, (src, replaces) in SOURCES.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
