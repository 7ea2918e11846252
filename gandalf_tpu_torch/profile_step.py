"""Where a step's device time goes: torch.profiler over a window of
steps of a slice on one GPU.

    python -m gandalf_tpu_torch.profile_step [--self-gravity {0,1}]
    python -m gandalf_tpu_torch.profile_step --block
    python -m gandalf_tpu_torch.profile_step --mfv [--self-gravity {0,1}]
    python -m gandalf_tpu_torch.profile_step --nbody [--nbody-scheme S]
    python -m gandalf_tpu_torch.profile_step --ewald

Sets up the slice at 64^3 = 262,144 particles in float32 (hydro only,
or self-gravitating as in bench.build_sim(64), the default), runs two
warm-up steps, then profiles one burst of 8 steps (main_loop_steps)
that holds no tree rebuild.  With --block: the block slice
(cold_sphere_block) at about 262,144 particles in float32, 4 warm-up
ticks, then a window of 8 ticks without a tree rebuild.  With --mfv:
the meshless finite-volume box (check.mfv_params, self-gravitating by
default) at 64^3 in float32, as the SPH box.  With --nbody: the N-body
cluster (check.nbody_params, plummer_cluster) at 65,536 stars in
float64 under hermite4 (or --nbody-scheme, hermite6ts unsoftened at
16,384 stars), 2 warm-up steps, then a window of 8 steps
(main_loop_step, each with its host read of t and dt).  With --ewald:
the periodic Jeans box with the Ewald sum (check.jeans_params,
ewald_jeans_box) at 64^3 in float32, as the SPH box.  Prints one JSON
line: the window's host time, the device time summed over kernels and
copies, the device's idle share of the window, the device time of each
of K1-K15 and of the torch glue between them, and the device time per
kernel name (largest first); with --block also the active rows per
tick.  Refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

N_SIDE = 64
STEPS = 8
BLOCK_N = 262144
BLOCK_WARM = 4
# device kernel names of K1-K12 (csrc/); every other device event is glue
FAMILIES = {
    "K1 grid27_bin": ("bin_count_kernel", "bin_scan_kernel",
                      "bin_scatter_kernel", "bin_rank_kernel"),
    "K2 grid27_density": ("grid27_density_kernel",),
    "K3 grid27_forces": ("grid27_forces_kernel",),
    "K4 tree_gather": ("tree_gather_kernel",),
    "K5 tree_build": ("tree_leaf_kernel", "tree_merge_kernel"),
    "K6 tree_walk": ("tree_walk_kernel",),
    "K7 tree_near": ("tree_near_kernel",),
    "K8 active_density": ("active_density_kernel",),
    "K9 active_forces": ("active_forces_kernel",),
    "K10 mfv_density": ("mfv_density_kernel",),
    "K11 mfv_gradients": ("mfv_gradients_kernel",),
    "K12 mfv_fluxes": ("mfv_fluxes_kernel",),
    "K13 direct_nbody": ("direct_nbody_kernel",),
    "K14 direct_softened": ("direct_softened_kernel",),
    "K15 direct_snap": ("direct_snap_kernel",),
}
NBODY_N = 65536
NBODY_TS6_N = 16384


def _device_us(evt) -> float:
    # FunctionEventAvg renamed cuda_* to device_* in recent releases
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _family(name: str) -> str:
    for fam, kernels in FAMILIES.items():
        if any(k in name for k in kernels):
            return fam
    return "torch glue"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--self-gravity", type=int, default=1, choices=(0, 1))
    ap.add_argument("--block", action="store_true",
                    help="the block-timestep slice (cold_sphere_block)")
    ap.add_argument("--mfv", action="store_true",
                    help="the meshless finite-volume box (mfv_box)")
    ap.add_argument("--nbody", action="store_true",
                    help="the N-body cluster (plummer_cluster)")
    ap.add_argument("--nbody-scheme", default="hermite4",
                    choices=("hermite4", "hermite6ts"))
    ap.add_argument("--ewald", action="store_true",
                    help="the Jeans box with the Ewald sum (ewald_jeans_box)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_step: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from .check import (jeans_params, jittered_box_ic, mfv_params,
                        nbody_params, slice_params, sphere_block_params)
    from .sim.simulation import GradhSphSimulation, SimulationBase

    if args.nbody:
        ts6 = args.nbody_scheme == "hermite6ts"
        params = nbody_params(NBODY_TS6_N if ts6 else NBODY_N,
                              nbody=args.nbody_scheme,
                              nbody_softening=0 if ts6 else 1)
        sim = SimulationBase.factory(params, "cuda")
        sim.SetupSimulation()
        warm = 2
    elif args.ewald:
        sim = GradhSphSimulation(jeans_params(N_SIDE), device="cuda",
                                 dtype=torch.float32)
        sim.SetupSimulation()
        warm = 2
    elif args.mfv:
        params = mfv_params(N_SIDE, self_gravity=args.self_gravity)
        sim = SimulationBase.factory(params, "cuda", torch.float32)
        sim.SetupSimulation(jittered_box_ic(params, N_SIDE))
        warm = 2
    elif args.block:
        sim = GradhSphSimulation(sphere_block_params(BLOCK_N),
                                 device="cuda", dtype=torch.float32)
        sim.SetupSimulation()
        warm = BLOCK_WARM
    else:
        params = slice_params(N_SIDE, self_gravity=args.self_gravity)
        sim = GradhSphSimulation(params, device="cuda", dtype=torch.float32)
        sim.SetupSimulation(jittered_box_ic(params, N_SIDE))
        warm = 2
    done = 0
    while done < warm:
        done += sim.main_loop_steps(warm - done)
    torch.cuda.synchronize()
    plans0 = sim._n_tree_plans
    rows = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if args.block or args.nbody:
            for _ in range(STEPS):
                sim.main_loop_step()
                if args.block:
                    rows.append(list(sim.last_tick_rows))
            done = STEPS
        else:
            done = sim.main_loop_steps(STEPS)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    per_name = {}
    for evt in prof.key_averages():
        # device-side events only (kernels, copies, memsets): the host
        # ops that launched them would count the same time again
        us = _device_us(evt)
        if str(evt.device_type).endswith("CUDA") and us > 0.0:
            per_name[evt.key] = per_name.get(evt.key, 0.0) + us
    per_family = {}
    for name, us in per_name.items():
        fam = _family(name)
        per_family[fam] = per_family.get(fam, 0.0) + us
    busy_us = sum(per_name.values())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if args.nbody:
        slice_fields = {"nbody": True, "scheme": sim.scheme,
                        "softening": int(sim.softening),
                        "dtype": str(sim.dtype), "dt": sim._dt_host}
    else:
        slice_fields = {
            "block": args.block, "mfv": args.mfv, "ewald": args.ewald,
            "self_gravity": int(sim.self_gravity),
            "tree_plans_in_window": sim._n_tree_plans - plans0,
            "active_rows_per_tick": rows,
            "ncells": list(sim.gridspec.ncells),
            "k_cell": sim.gridspec.k_cell}
    print(json.dumps({
        "card": card, "N": sim.state.N, **slice_fields, "steps": done,
        "window_ms": window_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / window_us,
        "device_ms_per_step": busy_us / 1e3 / done,
        "device_ms_per_step_by_kernel": {
            k: v / 1e3 / done for k, v in sorted(
                per_family.items(), key=lambda kv: -kv[1])},
        "device_ms_by_name": {k: v / 1e3 for k, v in sorted(
            per_name.items(), key=lambda kv: -kv[1])}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
