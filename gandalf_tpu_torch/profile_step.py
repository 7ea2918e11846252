"""Where a step's device time goes: torch.profiler over a window of
steps of a slice on one GPU.

    python -m gandalf_tpu_torch.profile_step [--self-gravity {0,1}]
    python -m gandalf_tpu_torch.profile_step --block [--ndim {1,2,3}]
    python -m gandalf_tpu_torch.profile_step --mfv [--self-gravity {0,1}]
        [--ndim {1,2,3}] [--riemann {hllc,exact}] [--limiter L] [--rk2]
    python -m gandalf_tpu_torch.profile_step --mfv --block [--ndim {1,2,3}]
        [--timestep-limiter {none,simple,conservative}]
    python -m gandalf_tpu_torch.profile_step --nbody [--nbody-scheme S]
    python -m gandalf_tpu_torch.profile_step --ewald
    python -m gandalf_tpu_torch.profile_step --sinks [--ndim {1,2,3}]
    python -m gandalf_tpu_torch.profile_step --khi
    python -m gandalf_tpu_torch.profile_step --mirror [--layout L]
    python -m gandalf_tpu_torch.profile_step --block-sinks [--ndim {1,2,3}]
    python -m gandalf_tpu_torch.profile_step --cd2010
    python -m gandalf_tpu_torch.profile_step --dust [--dust-case C]
    python -m gandalf_tpu_torch.profile_step --sm2012 [--khi]
    python -m gandalf_tpu_torch.profile_step --radws [--mfv]
    python -m gandalf_tpu_torch.profile_step --radfb
    python -m gandalf_tpu_torch.profile_step --radiation SCHEME
    python -m gandalf_tpu_torch.profile_step [--block] --kernel V

Sets up the slice at 64^3 = 262,144 particles in float32 (hydro only,
or self-gravitating as in bench.build_sim(64), the default), runs two
warm-up steps, then profiles one burst of 8 steps (main_loop_steps)
that holds no tree rebuild.  With --block: the block slice
(cold_sphere_block) at about 262,144 particles in float32, 4 warm-up
ticks, then a window of 8 ticks without a tree rebuild; --ndim 2 takes
the KHI (check.khi_params, 425,984 particles) with Nlevels 3 in
float32 and --ndim 1 the block Sod tube (check.block_sod_params(4), 256
+ 64, float64), both on the compacted tick without gravity.  With --mfv:
the meshless finite-volume box (check.mfv_params, self-gravitating by
default) at 64^3 in float32, as the SPH box; --ndim 2 takes the 2D box
of tests/test_mfv_grid.py at x16 per axis (check.mfv_khi_params(512),
524,288 particles, no gravity) and --ndim 1 the MFV Sod tube (512 +
128, float64), --riemann the Riemann solver, --limiter the slope
limiter (gizmo, scalar, null, zeroslope, tvdscalar, springel2009) and
--rk2 the Heun scheme (sim = mfvrk).  With --mfv --block: block-timestep
MFV, 4 warm-up ticks and a window of 8: at ndim 3 mfv_block_sphere
(check.mfv_block_sphere_params at about 262,144 particles, the
quadrupole tree) in float32, at ndim 2 the 2D box (524,288 particles)
with Nlevels 3 in float32, at ndim 1 the block Sod tube
(check.mfv_block_tube_params(3), float64); --timestep-limiter sets
time_step_limiter (conservative at ndim 3, simple otherwise, by
default; --limiter is the slope limiter).  With --nbody: the N-body
cluster (check.nbody_params, plummer_cluster) at 65,536 stars in
float64 under hermite4 (or --nbody-scheme, hermite6ts unsoftened at
16,384 stars), 2 warm-up steps, then a window of 8 steps
(main_loop_step, each with its host read of t and dt).  With --ewald:
the periodic Jeans box with the Ewald sum (check.jeans_params,
ewald_jeans_box) at 64^3 in float32, as the SPH box.  With --sinks:
the Boss-Bodenheimer collapse with sinks (check.bb_params at about
262,144 particles, rho_sink 2e-17 g cm^-3) in float32, 9 warm-up steps
(one tree rebuild, 9 sinks formed), then the burst of 7 steps up to the
next rebuild, and again the burst of steps 26-32 (16 sinks, their dead
gas piled up at them), as a second line; --ndim 2 takes the 2D disc
with sinks (check.sink_disc_params(262144, 2): 262,376 particles,
rho_sink from the bootstrap, check.sink_disc_sim) in float32 and --ndim
1 the rod at 4,096 in float64, 9 warm-up steps and the same windows.
With --khi: the 2D Kelvin-Helmholtz instability (check.khi_params,
425,984 particles) in float32, as the SPH box.  With --mirror: the
mirror-wall box
(check.mirror_params at 64^3 with jittered_state's IC; --layout dim0,
walls on dim 0, or mixed, the mirror/wall and open/mirror pairs on dims
1 and 2) in float32, as the SPH box.  With --block-sinks: the
block-stepped Boss-Bodenheimer collapse (check.bb_block_params at about
262,144 particles: Nlevels 5, smooth accretion, mm97) in float32, 4
warm-up ticks, then a window of 8 dense ticks; --ndim 2 and 1 take the
disc and the rod of --sinks with Nlevels 4 and smooth accretion.  With
--cd2010: the KHI with time_dependent_avisc = cd2010 (K21 once a
step), as --khi.  With --dust: the dusty Evrard collapse
(check.dust_params at Nhydro 131,072,
about 262,144 gas and dust particles, two-fluid Epstein drag, tree
gravity) in float32, as the SPH box; --dust-case box takes the 3D dusty
box at 64^3 gas + 64^3 dust (check.dustybox_params) instead.  With
--sm2012: the SPH box (self-gravitating unless --self-gravity 0), or
with --khi the KHI, through SM2012SphSimulation (K25, K26 in place of
K2, K3).  With --radws: the SPH box (self-gravitating unless
--self-gravity 0), or with --mfv the MFV box, on the radws
thermodynamics (check.radws_params: K27 and K28, or K27 and K29 in
MFV).  With --radfb: the hybrid Plummer sphere of 262,144 gas particles
and 4 stars on radws with radiative feedback (check.radfb_params;
K27, K28 and K30 beside the sink path's kernels), as the SPH box.
With --radiation (ionisation, treeray or monoionisation): the Spitzer HII
region (check.spitzer_params at 262,144 particles, the star at the
origin, check.spitzer_table; monoionisation with
check.SPITZER_MC_ACROSS) in float32, 2 warm-up steps, then a window of
4 steps, each with its radiation update (K37, or K34 and K35, or K34
and K36 four times).
With --kernel V (quintic, gaussian, m4_tab, quintic_tab, gaussian_tab)
the SPH box, or with --block the block sphere, runs that smoothing
kernel (check.family_params; the gaussian with --self-gravity 0).
Prints one JSON line a
window: the steps before it, each kernel's launches in it (a burst
redone after an overflow replan counts again), the window's host time,
the device time summed over kernels and copies, the device's idle share
of the window, the device time of each of K1-K37 and of the torch glue
between them, and the device time per kernel name (largest first); with
--block also the active rows per tick.  Refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .kernels.smoothing import VARIANTS

N_SIDE = 64
STEPS = 8
BLOCK_N = 262144
BLOCK_WARM = 4
# device kernel names of K1-K37 (csrc/); every other device event is glue
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
    "K16 star_gas_forces": ("star_gas_gas_side", "star_gas_star_side",
                            "star_gas_star_finish"),
    "K17 sink_candidate": ("candidate_partial", "candidate_finish"),
    "K18 accretion_sums": ("accretion_nearest", "accretion_partial",
                           "accretion_finish"),
    "K19 grid27_mirror": ("grid27_mirror_kernel",),
    "K20 smooth_accretion": ("smooth_terms", "smooth_slots", "smooth_dm",
                             "move_terms", "move_slots", "spin_terms",
                             "spin_slots", "slot_partial", "slot_finish"),
    "K21 cullen_dehnen": ("cullen_dehnen_kernel",),
    "K22 levelneib": ("levelneib_kernel",),
    "K23 dust_drag_sums": ("dust_sums_kernel",),
    "K24 dust_drag_deposit": ("dust_deposit_kernel",),
    "K25 sm2012_density": ("sm2012_density_kernel",),
    "K26 sm2012_forces": ("sm2012_forces_kernel",),
    "K27 radws_eos": ("radws_eos_kernel",),
    "K28 radws_equilibrium": ("radws_equilibrium_kernel",),
    "K29 radws_implicit_heating": ("radws_implicit_kernel",),
    "K30 ambient_temperature": ("ambient_kernel",),
    "K31 mfv_limiter": ("mfv_limiter_kernel",),
    "K32 mfv_vsig_near": ("vsig_near_kernel",),
    "K33 mfv_vsig_far": ("vsig_agg_kernel", "vsig_far_kernel",
                         "vsig_far_reduce"),
    "K34 cell_field": ("slot_map_kernel", "cell_sum_kernel"),
    "K35 ray_march": ("ray_march_kernel",),
    "K36 packet_march": ("packet_march_kernel", "packet_cast_kernel"),
    "K37 stromgren_prefix": ("src_dist_kernel", "weights_kernel",
                             "hist_kernel", "select_kernel",
                             "any_reach_kernel"),
}
# the radiation window's steps (each with its update)
RADIATION_STEPS = 4
DUST_NHYDRO = 131072
NBODY_N = 65536
NBODY_TS6_N = 16384
SINK_N = 262144
SINK_ROD_N = 4096
# the sink path's two windows: after 9 steps (one tree rebuild, 9 sinks)
# and after 25, the burst up to step 32 that ends bb_sink_collapse's
SINK_WARM = 9
SINK_LATE = 25


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


def _profile_window(sim, args, before: int) -> int:
    """Profile one window of steps (ticks) after `before` of them and
    print its JSON line; returns the steps it ran."""
    from torch.profiler import ProfilerActivity, profile

    from . import _ext

    torch.cuda.synchronize()
    plans0, replans0 = sim._n_tree_plans, sim._n_grid_overflows
    launches0 = dict(_ext.LAUNCHES)
    rows = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if args.radiation:
            for _ in range(RADIATION_STEPS):
                sim.main_loop_step()
            done = RADIATION_STEPS
        elif args.block or args.block_sinks or args.nbody:
            for _ in range(STEPS):
                sim.main_loop_step()
                if args.block or args.block_sinks:
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
            "mfv_modes": ({k: getattr(sim.mfv_cfg, k) for k in
                           ("riemann", "slope_limiter", "time_scheme")}
                          if args.mfv else None),
            "time_step_limiter": (sim.time_step_limiter
                                  if args.mfv and args.block else None),
            "sinks": args.sinks, "khi": args.khi,
            "block_sinks": args.block_sinks, "cd2010": args.cd2010,
            "mirror": args.layout if args.mirror else None,
            "dust": args.dust_case if args.dust else None,
            "sm2012": args.sm2012, "radws": args.radws,
            "radfb": args.radfb, "radiation": args.radiation,
            "kernel": sim.kern.variant,
            "ndim": sim.ndim,
            "sinks_active": (int(sim.state.sinks.active.sum())
                             if getattr(sim, "has_sinks", False) else 0),
            "self_gravity": int(sim.self_gravity),
            "tree_plans_in_window": sim._n_tree_plans - plans0,
            "grid_replans_in_window": sim._n_grid_overflows - replans0,
            "active_rows_per_tick": rows,
            "ncells": list(sim.gridspec.ncells),
            "k_cell": sim.gridspec.k_cell}
    print(json.dumps({
        "card": card, "N": sim.state.N, **slice_fields,
        "after_steps": before, "steps": done,
        # a burst redone after an overflow replan launches its kernels again
        "launches_in_window": {k: n - launches0[k]
                               for k, n in _ext.LAUNCHES.items()
                               if n > launches0[k]},
        "window_ms": window_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / window_us,
        "device_ms_per_step": busy_us / 1e3 / done,
        "device_ms_per_step_by_kernel": {
            k: v / 1e3 / done for k, v in sorted(
                per_family.items(), key=lambda kv: -kv[1])},
        "device_ms_by_name": {k: v / 1e3 for k, v in sorted(
            per_name.items(), key=lambda kv: -kv[1])}}))
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--self-gravity", type=int, default=1, choices=(0, 1))
    ap.add_argument("--block", action="store_true",
                    help="the block-timestep slice (cold_sphere_block)")
    ap.add_argument("--mfv", action="store_true",
                    help="the meshless finite-volume box (mfv_box)")
    ap.add_argument("--ndim", type=int, default=3, choices=(1, 2, 3),
                    help="with --mfv or --block: the Sod tube (1) or the "
                         "2D box or KHI (2); with --sinks or --block-sinks: "
                         "the rod (1) or the disc (2)")
    ap.add_argument("--riemann", default="hllc", choices=("hllc", "exact"),
                    help="with --mfv: the Riemann solver")
    ap.add_argument("--limiter", default="gizmo",
                    choices=("gizmo", "scalar", "null", "zeroslope",
                             "tvdscalar", "springel2009"),
                    help="with --mfv: the slope limiter")
    ap.add_argument("--rk2", action="store_true",
                    help="with --mfv: RK2 (sim = mfvrk)")
    ap.add_argument("--timestep-limiter", default=None,
                    choices=("none", "simple", "conservative"),
                    help="with --mfv --block: time_step_limiter")
    ap.add_argument("--nbody", action="store_true",
                    help="the N-body cluster (plummer_cluster)")
    ap.add_argument("--nbody-scheme", default="hermite4",
                    choices=("hermite4", "hermite6ts"))
    ap.add_argument("--ewald", action="store_true",
                    help="the Jeans box with the Ewald sum (ewald_jeans_box)")
    ap.add_argument("--sinks", action="store_true",
                    help="the Boss-Bodenheimer collapse (bb_sink_collapse)")
    ap.add_argument("--khi", action="store_true",
                    help="the 2D Kelvin-Helmholtz instability "
                         "(khi_main_path)")
    ap.add_argument("--mirror", action="store_true",
                    help="the mirror-wall box (mirror_box)")
    ap.add_argument("--layout", default="dim0", choices=("dim0", "mixed"))
    ap.add_argument("--block-sinks", action="store_true",
                    help="the block-stepped Boss-Bodenheimer collapse "
                         "(bb_block_collapse)")
    ap.add_argument("--cd2010", action="store_true",
                    help="the KHI with the Cullen & Dehnen switch "
                         "(khi_cd2010)")
    ap.add_argument("--dust", action="store_true",
                    help="the dusty Evrard collapse (dusty_evrard)")
    ap.add_argument("--dust-case", default="evrard",
                    choices=("evrard", "box"))
    ap.add_argument("--sm2012", action="store_true",
                    help="the SPH box, or with --khi the KHI, through "
                         "SM2012SphSimulation")
    ap.add_argument("--radws", action="store_true",
                    help="the SPH box, or with --mfv the MFV box, on radws "
                         "(radws_box, radws_mfv_box)")
    ap.add_argument("--radfb", action="store_true",
                    help="the Plummer sphere with 4 stars on radws with "
                         "radiative feedback (radfb_cluster)")
    ap.add_argument("--radiation", default=None,
                    choices=("ionisation", "treeray", "monoionisation"),
                    help="the Spitzer HII region under this scheme")
    ap.add_argument("--kernel", default="m4",
                    choices=("m4",) + tuple(VARIANTS),
                    help="the smoothing kernel of the SPH box or the "
                         "block sphere")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_step: no CUDA device")
    from .check import (MIRROR_DIM0, MIRROR_MIXED, bb_block_params,
                        bb_params, block_sod_params, dust_params,
                        dustybox_params, family_params, jeans_params,
                        jittered_box_ic, khi_params, mfv_block_sphere_params,
                        mfv_block_tube_params, mfv_khi_params,
                        mfv_params, mfv_sod_params, mirror_ic,
                        mirror_params, nbody_params, plummer_stars_params,
                        radfb_params, radws_params, sink_disc_params,
                        sink_disc_sim, slice_params, sm2012_params,
                        sphere_block_params)
    from .sim.simulation import GradhSphSimulation, SimulationBase

    if args.radiation:
        from .check import spitzer_sim

        sim = spitzer_sim(BLOCK_N, args.radiation, "cuda")
        warm = 2
    elif args.nbody:
        ts6 = args.nbody_scheme == "hermite6ts"
        params = nbody_params(NBODY_TS6_N if ts6 else NBODY_N,
                              nbody=args.nbody_scheme,
                              nbody_softening=0 if ts6 else 1)
        sim = SimulationBase.factory(params, "cuda")
        sim.SetupSimulation()
        warm = 2
    elif args.radfb:
        sim = GradhSphSimulation(
            radfb_params(plummer_stars_params(SINK_N, 4)), device="cuda",
            dtype=torch.float32)
        sim.SetupSimulation()
        warm = 2
    elif (args.sinks or args.block_sinks) and args.ndim < 3:
        params = sink_disc_params(
            SINK_N if args.ndim == 2 else SINK_ROD_N, args.ndim,
            nlevels=4 if args.block_sinks else 1,
            smooth_accretion=int(args.block_sinks))
        sim, _, _ = sink_disc_sim(params, "cuda", torch.float32
                                  if args.ndim == 2 else torch.float64)
        warm = BLOCK_WARM if args.block_sinks else SINK_WARM
    elif args.sinks:
        sim = GradhSphSimulation(bb_params(SINK_N, rho_sink=2.0e-17),
                                 device="cuda", dtype=torch.float32)
        sim.SetupSimulation()
        warm = SINK_WARM
    elif args.dust:
        params = (dust_params(DUST_NHYDRO) if args.dust_case == "evrard"
                  else dustybox_params(N_SIDE, 3))
        sim = GradhSphSimulation(params, device="cuda", dtype=torch.float32)
        sim.SetupSimulation()
        warm = 2
    elif args.block_sinks:
        sim = GradhSphSimulation(bb_block_params(SINK_N), device="cuda",
                                 dtype=torch.float32)
        sim.SetupSimulation()
        warm = BLOCK_WARM
    elif args.khi or args.cd2010:
        params = khi_params()
        if args.cd2010:
            params.set("time_dependent_avisc", "cd2010")
        if args.sm2012:
            params = sm2012_params(params)
        sim = SimulationBase.factory(params, "cuda", torch.float32)
        sim.SetupSimulation()
        warm = 2
    elif args.mirror:
        walls = MIRROR_DIM0 if args.layout == "dim0" else MIRROR_MIXED
        params = mirror_params(N_SIDE, 3, walls)
        sim = GradhSphSimulation(params, device="cuda", dtype=torch.float32)
        sim.SetupSimulation(mirror_ic(params, walls))
        warm = 2
    elif args.ewald:
        sim = GradhSphSimulation(jeans_params(N_SIDE), device="cuda",
                                 dtype=torch.float32)
        sim.SetupSimulation()
        warm = 2
    elif args.mfv and args.block:
        lim = args.timestep_limiter or ("conservative" if args.ndim == 3
                                        else "simple")
        if args.ndim == 3:
            params = mfv_block_sphere_params(BLOCK_N)
        elif args.ndim == 2:
            params = mfv_khi_params(512, Nlevels=3)
        else:
            params = mfv_block_tube_params(3)
        params.set("time_step_limiter", lim)
        params.set("riemann_solver", args.riemann)
        params.set("slope_limiter", args.limiter)
        sim = SimulationBase.factory(
            params, "cuda", torch.float64 if args.ndim == 1
            else torch.float32)
        sim.SetupSimulation()
        warm = BLOCK_WARM
    elif args.mfv:
        opts = {"riemann_solver": args.riemann,
                "slope_limiter": args.limiter,
                "sim": "mfvrk" if args.rk2 else "meshlessfv"}
        if args.ndim == 3:
            params = mfv_params(N_SIDE, self_gravity=args.self_gravity)
            for k, v in opts.items():
                params.set(k, v)
            if args.radws:
                params = radws_params(params)
            sim = SimulationBase.factory(params, "cuda", torch.float32)
            sim.SetupSimulation(jittered_box_ic(params, N_SIDE))
        else:
            params = (mfv_khi_params(512, **opts) if args.ndim == 2
                      else mfv_sod_params(**opts))
            sim = SimulationBase.factory(
                params, "cuda",
                torch.float32 if args.ndim == 2 else torch.float64)
            sim.SetupSimulation()
        warm = 2
    elif args.block:
        if args.ndim == 3:
            params = sphere_block_params(BLOCK_N)
        elif args.ndim == 2:
            params = khi_params(nlevels=3)
        else:
            params = block_sod_params(4, tend=1.0e30)
        sim = GradhSphSimulation(
            family_params(args.kernel, params), device="cuda",
            dtype=torch.float64 if args.ndim == 1 else torch.float32)
        sim.SetupSimulation()
        warm = BLOCK_WARM
    else:
        params = family_params(
            args.kernel, slice_params(N_SIDE, self_gravity=args.self_gravity))
        if args.sm2012:
            params = sm2012_params(params)
        if args.radws:
            params = radws_params(params)
        sim = SimulationBase.factory(params, "cuda", torch.float32)
        sim.SetupSimulation(jittered_box_ic(params, N_SIDE))
        warm = 2
    done = 0
    while done < warm:
        done += sim.main_loop_steps(warm - done)
    done += _profile_window(sim, args, done)
    if args.sinks:
        # the burst that ends bb_sink_collapse's window, sinks and dead
        # gas piled up
        while done < SINK_LATE:
            done += sim.main_loop_steps(SINK_LATE - done)
        _profile_window(sim, args, done)
    return 0


if __name__ == "__main__":
    sys.exit(main())
