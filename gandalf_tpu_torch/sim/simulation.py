"""Simulation controllers: the shared host side, and the grad-h SPH
controller.

``SimulationBase`` is the counterpart of the host part of
``gandalf_tpu/sim/simulation.py:SimulationBase``: parameters, device and
dtype, the structured-grid plan, the KD-bucket tree plan and its
``ntreebuildstep`` cadence, and the global-timestep host loop (bursts of
steps, overflow replans, the clamp to tend).  ``factory`` builds a
controller by the ``sim`` parameter.  The meshless finite-volume
controller is in ``sim/mfv_sim.py``, the N-body one in ``sim/nbody_sim.py``.

``GradhSphSimulation`` is the counterpart of gandalf_tpu's
``GradhSphSimulation`` for one configuration: grad-h SPH with the M4
kernel, the adiabatic EOS, mon97 viscosity (or none) and optional
conductivity, the structured 27-shift grid, KDK leapfrog with a global
timestep or with hierarchical block timesteps (``Nlevels > 1``), and
optionally self-gravity from the KD-bucket Barnes-Hut tree (frontier
walk; geometric, gadget2 or eigenmac MAC; monopole or quadrupole moments,
at every particle or expanded about each bucket's centre; the Ewald sum
of a periodic box, fully periodic, slab or cylinder), with its buckets
replanned every ``ntreebuildstep`` steps.  Options outside that slice
raise NotImplementedError naming their ROADMAP item.

A global step runs eagerly as a sequence of torch operations and kernel
launches on the simulation's device; on a CUDA device nothing in it
waits for the device, so ``main_loop_steps`` queues a burst of steps and
reads the overflow flag and the time once at its end.  A block tick
(the JAX package's active-compacted tick) drifts every particle, then
does the pair work of the active particles only (``ops/active_grid.py``,
and with self-gravity the tree walk of their buckets); it reads the
active set, the Saitoh-Makino set and the overflow flag on the host, so
it runs tick by tick.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..integrate.block import (BlockConfig, advance, check_timesteps,
                               end_timestep, init_schedule)
from ..integrate.leapfrog import (IntegratorConfig, correct, predict,
                                  sph_timestep)
from ..kernels.smoothing import kernel_factory
from ..ops.active_grid import active_hydro_pass
from ..ops.eos import eos_factory
from ..ops.ewald import table_from_params
from ..ops.forces import ArtificialViscosity
from ..ops.sph_grid27 import hydro_pass_grid27, plan_grid27
from ..ops.tree import (grow_tree_caps, plan_buckets_kd,
                        plan_tree_for_buckets, tree_gravity_active,
                        tree_gravity_grouped, walk_stats_levels_native)
from ..state import (BOUNDARY_TYPE, DUST_TYPE, ICM_TYPE, DomainBox,
                     SphState, make_sph_state)
from ..units import SimUnits, inscale_parameters
from ..utils.timing import CodeTiming
from .ic import generate_ic

# queued steps per burst: each queued step keeps its input state alive
BURST_CAP = 8
# bucket size of the gravity tree (gandalf_tpu's _plan_tree_buckets)
LEAF_SIZE = 32


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, {item})")


class SimulationBase:
    """Host side shared by the controllers.  `device` and `dtype` place
    every state tensor: the card unless the caller asks for the CPU,
    where the plain versions of the kernels run.  float32 is the working
    type on a GPU, float64 the reference-grade type.  A subclass provides process_parameters,
    SetupSimulation, ``_step_fn`` (one global step, state to state) and
    ``_run_bootstrap``."""

    use_block = False

    def __init__(self, params, device="cuda", dtype=torch.float32):
        self.params = params
        self.device = torch.device(device)
        self.dtype = dtype
        self.ndim = params.intparams["ndim"]
        self.state = None
        self.gridspec = None
        self.treespec = None
        self.Nsteps = 0
        self.t = 0.0
        self.setup_complete = False
        self.timing = CodeTiming()
        self._n_grid_overflows = 0
        self._n_tree_plans = 0
        self._step_fn = None
        self._leaf_of = None
        # the next snapshot time; no snapshot is written
        self.tsnapnext = math.inf

    @staticmethod
    def factory(params, device="cuda", dtype=None):
        """The controller for the `sim` parameter
        (SimulationBase::SimulationFactory).  `dtype` defaults to float32
        for the hydro controllers and float64 for N-body."""
        sim = params.stringparams["sim"]
        if sim == "nbody":
            # Nmpi > 1: the reference replicates the star set on every
            # rank and integrates it identically (no decomposition in
            # NbodySimulation.cpp), so the controller is the same
            from .nbody_sim import NbodySimulation

            return NbodySimulation(params, device, dtype or torch.float64)
        if params.intparams["Nmpi"] > 1:
            raise _unsupported("Nmpi > 1", "item 13")
        dtype = dtype or torch.float32
        if sim in ("sph", "gradhsph", "gradsph"):
            return GradhSphSimulation(params, device, dtype)
        if sim in ("meshlessfv", "mfvmuscl"):
            from .mfv_sim import MfvMusclSimulation

            return MfvMusclSimulation(params, device, dtype)
        raise _unsupported(f"sim {sim!r}", "items 9-10")

    def _require_device(self):
        """Refuse a CUDA device when there is none, rather than leave the
        caller on some other path."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "versions of the kernels on the CPU")

    # -- parameters shared by the controllers ---------------------------------
    def _common_parameters(self):
        """Units, kernel, EOS, box and the gravity options."""
        p = self.params
        ip, sp = p.intparams, p.stringparams
        if self.ndim != 3:
            raise _unsupported("ndim != 3", "item 3")
        if ip["sink_particles"] or ip["create_sinks"]:
            raise _unsupported("sink particles", "item 9")
        if sp["gas_eos"] == "radws":
            raise _unsupported("radws", "item 9")
        if sp["radiation"] not in ("none", "null", ""):
            raise _unsupported("radiation", "item 12")
        if sp["external_potential"] != "none":
            raise _unsupported("external potentials", "item 9")
        if sp["neib_search"] == "bruteforce":
            raise _unsupported("neib_search = bruteforce",
                               "'Not to port': brute-force paths")
        self.units = SimUnits()
        self.units.setup_units(p)
        if not self.units.dimensionless:
            inscale_parameters(p, self.units)
        self.kern = kernel_factory(sp["kernel"], self.ndim,
                                   ip["tabulated_kernel"])
        self.eos = eos_factory(p)
        self.box = DomainBox.from_params(p)
        if self.box.mirror_walls():
            raise _unsupported("mirror/wall boundaries", "item 8")
        self.self_gravity = bool(ip["self_gravity"])
        if self.self_gravity:
            self._check_gravity_options()
        # the Ewald sum of a periodic self-gravitating box (ewald = 0
        # treats the box's mass as isolated), its table built once on the
        # host (gandalf_tpu/sim/simulation.py:897-921)
        self.use_ewald = (self.self_gravity and bool(self.box.periodic_dims())
                          and bool(ip["ewald"]))
        self.ewald_table = None
        if self.use_ewald:
            with self.timing.block("EWALD_TABLE"):
                self.ewald_table = table_from_params(p, self.box)
        self.h_fac = p.floatparams["h_fac"]
        self.h_converge = p.floatparams["h_converge"]

    def _check_gravity_options(self):
        """The tree-gravity options the port runs: the frontier walk over
        KD buckets (every MAC, multipole and Ewald option of the JAX
        package)."""
        p = self.params
        if p.stringparams["neib_search"] == "octtree":
            raise _unsupported("neib_search = octtree (Morton buckets)",
                               "item 8")

    def _periodic_extent(self):
        """Per-dim box length along periodic dims (0 elsewhere), or None
        without periodic dims: the tree's unwrap extent."""
        pdims = self.box.periodic_dims()
        if not pdims:
            return None
        return [self.box.size[k] if k in pdims else 0.0
                for k in range(self.ndim)]

    # -- grid plan -------------------------------------------------------------
    def _plan_grid(self, r, h, growth: float = 1.3):
        """(Re)plan the structured grid from positions and h on the host.
        With unchanged cells, a grown slot count overshoots by 25% so a
        slowly clustering core does not re-overflow within a few steps."""
        h_max = float(_host(h).max()) * growth
        old = self.gridspec
        spec = plan_grid27(self.box, _host(r), h_max, self.kern.kernrange)
        if old is not None and old.ncells == spec.ncells \
                and old.qz == spec.qz and spec.k_cell > old.k_cell:
            spec = dataclasses.replace(
                spec, k_cell=max(spec.k_cell, int(1.25 * old.k_cell)))
        self.gridspec = spec

    # -- tree plan -------------------------------------------------------------
    def _plan_tree_buckets(self, r_np: np.ndarray, grow_caps: bool = False,
                           full_width: bool = False) -> bool:
        """(Re)plan the gravity-tree buckets from positions on the host:
        KD buckets, then caps from the walk demand the C++ planner
        measures on 4096 sampled groups, quantised to multiples of 32 and
        kept within hysteresis of the old caps; `grow_caps` grows them
        after an overflow, `full_width` sets them to the whole tree's
        width.  Returns whether the TreeSpec changed."""
        p = self.params
        theta_sqd = p.floatparams["thetamaxsqd"]
        old = self.treespec
        gmap = plan_buckets_kd(r_np, leaf_size=LEAF_SIZE)
        h_np = None
        if self.state is not None and self.state.N == len(r_np):
            h_np = _host(self.state.h)

        def q32(x):
            return -(-x // 32) * 32

        def settle(new, old_v):
            # keep the old cap unless demand grew past it or fell below a
            # quarter of it; a growing cap overshoots by 25% of the old one
            if new is None or old_v is None:
                return new
            if new <= old_v <= 4 * new:
                return old_v
            if new > old_v:
                return q32(max(new, int(1.25 * old_v)))
            return new

        near_max, front_max, sup_max, level_max = walk_stats_levels_native(
            r_np, gmap, theta_sqd, h=h_np, kernrange=self.kern.kernrange,
            sample=4096)
        near_cap = q32(int(1.25 * near_max) + 16)
        frontier = q32(int(1.25 * front_max) + 32)
        support_cap = None
        if h_np is not None:
            support_cap = q32(min(int(1.5 * sup_max) + 8, near_cap))
        level_caps = [max(min(q32(int(1.25 * int(w)) + 16), 1 << ell,
                              frontier), 1)
                      for ell, w in enumerate(level_max)]
        near_cap = min(near_cap, gmap.shape[0])
        if old is not None:
            near_cap = settle(near_cap, old.near_cap)
            frontier = settle(frontier, old.frontier)
            support_cap = settle(support_cap, old.support_cap)
            if old.frontier_levels is not None \
                    and len(old.frontier_levels) == len(level_caps):
                level_caps = [settle(w, ow) for w, ow in
                              zip(level_caps, old.frontier_levels)]
            if self._mac_outgrows_stats():
                # the walk statistics cannot see an accuracy MAC's demand,
                # so its caps never shrink (ROADMAP fault F4)
                near_cap = max(near_cap, old.near_cap)
                frontier = max(frontier, old.frontier)
                if old.frontier_levels is not None \
                        and len(old.frontier_levels) == len(level_caps):
                    level_caps = [max(w, ow) for w, ow in
                                  zip(level_caps, old.frontier_levels)]
        if full_width:
            # the whole tree's width: every leaf in each near list (and
            # kernel support) and 2^l cells at level l (ROADMAP fault F4)
            near_cap = gmap.shape[0]
            support_cap = None if support_cap is None else near_cap
            frontier = 2 * gmap.shape[0]
            level_caps = [min(1 << ell, frontier)
                          for ell in range(len(level_caps))]
        mp = p.stringparams["multipole"]
        spec = plan_tree_for_buckets(
            gmap, theta_sqd=theta_sqd,
            quadrupole=mp in ("quadrupole", "fast_quadrupole"),
            fast=mp.startswith("fast"), near_cap=near_cap,
            frontier=frontier, mac=p.stringparams["gravity_mac"],
            macerror=p.floatparams["macerror"])
        if support_cap is not None:
            spec = dataclasses.replace(spec, support_cap=support_cap)
        spec = dataclasses.replace(spec, frontier_levels=tuple(level_caps))
        if grow_caps:
            spec = grow_tree_caps(spec)
        self.treespec = spec
        self.state = self.state.replace(bucket_map=torch.as_tensor(
            gmap, device=self.device))
        self._set_leaf_of(gmap)
        self._n_tree_plans += 1
        return old != spec

    def _mac_outgrows_stats(self) -> bool:
        """Whether the walk's demand can outgrow what the walk statistics
        measure: the planner replays the geometric MAC, and gadget2 and
        eigenmac open more cells (gadget2 every cell of a group whose
        least |a_prev| is near 0, as at the bootstrap, where a0 = 0)."""
        return (self.self_gravity and self.params.stringparams[
            "gravity_mac"] in ("gadget2", "eigenmac"))

    def _set_leaf_of(self, gmap: np.ndarray) -> None:
        """Particle -> bucket map of the block tick's active-group walk;
        rebuilt on every bucket plan, overflow replans included."""
        leaf_of = np.full(self.state.N, -1, np.int32)
        rows = np.repeat(np.arange(gmap.shape[0], dtype=np.int32),
                         gmap.shape[1])
        flat = gmap.reshape(-1)
        leaf_of[flat[flat >= 0]] = rows[flat >= 0]
        self._leaf_of = torch.as_tensor(leaf_of, device=self.device)

    def _tree_cadence(self):
        """Replan the buckets every ntreebuildstep steps."""
        ntb = max(self.params.intparams["ntreebuildstep"], 1)
        if self.treespec is not None and self.Nsteps > 0 \
                and self.Nsteps % ntb == 0:
            with self.timing.block("TREE_REBUILD"):
                self._plan_tree_buckets(_host(self.state.r))

    # -- setup -----------------------------------------------------------------
    def _bootstrap_with_replans(self):
        """Run the bootstrap pass; on neighbour overflow replan the grid
        (and the tree buckets, with grown caps) from the overflowed
        state and run it again, at most 5 times.  An accuracy MAC's walk
        can outgrow 5 growths of its caps (gadget2 opens every cell while
        every a0 is zero); it gets a sixth try with caps of the whole
        tree's width where the JAX package raises (ROADMAP fault F4), so
        that the two agree wherever the JAX package runs."""
        self._run_bootstrap()
        tries = 0
        while bool(self.state.neib_overflow):
            tries += 1
            full = tries == 6 and self._mac_outgrows_stats()
            if tries > 5 and not full:
                raise RuntimeError(
                    "bootstrap neighbour overflow persists after 5 "
                    "replans: h is pinned at a clamp (coincident "
                    "particles in the ICs?)")
            self._n_grid_overflows += 1
            self._plan_grid(self.state.r, self.state.h)
            if self.treespec is not None:
                self._plan_tree_buckets(_host(self.state.r),
                                        grow_caps=not full, full_width=full)
            self.state = self.state.replace(
                neib_overflow=torch.zeros_like(self.state.neib_overflow))
            self._run_bootstrap()

    # -- host loop -------------------------------------------------------------
    def _clamp_dt_to_tend(self):
        """Bound the global timestep by the remaining run time so the
        last step lands on tend."""
        t_now = float(self.state.t)
        cap = self.params.floatparams["tend"] - t_now
        dt = float(self.state.dt)
        if cap > 0.0 and (not math.isfinite(dt) or dt > cap):
            self.state = self.state.replace(dt=torch.tensor(
                cap, dtype=self.dtype, device=self.device))

    def main_loop_step(self):
        """One global step; on neighbour overflow, replan the grid from
        the pre-step state (and the tree buckets, with grown caps) and
        redo the step (at most 4 times; an accuracy MAC's walk gets a
        fifth try with caps of the whole tree's width, ROADMAP fault F4).
        Every ntreebuildstep steps the tree buckets are replanned
        first."""
        self._tree_cadence()
        self._clamp_dt_to_tend()
        with self.timing.block("MAIN_LOOP"):
            prev = self.state
            self.state = self._step_fn(prev)
            if bool(self.state.neib_overflow):
                # plan from the pre-step state: the overflowed state's h
                # came from truncated sums
                with self.timing.block("GRID_REPLAN"):
                    tries = 5 if self._mac_outgrows_stats() else 4
                    for attempt in range(tries):
                        full = attempt == 4
                        self.state = prev
                        self._n_grid_overflows += 1
                        self._plan_grid(prev.r, prev.h,
                                        growth=1.3 * (1.2 ** attempt))
                        if self.treespec is not None:
                            # replaces self.state's bucket map
                            self._plan_tree_buckets(
                                _host(prev.r), grow_caps=not full,
                                full_width=full)
                        self.state = self._step_fn(self.state)
                        if not bool(self.state.neib_overflow):
                            break
                    else:
                        raise RuntimeError(
                            "neighbour overflow persists after 4 replans")
        self.Nsteps += 1
        self.t = float(self.state.t)

    def main_loop_steps(self, n: int) -> int:
        """Advance up to `n` steps as one burst: queue the steps without
        reading anything back, then read (overflow, t) once.  If some
        step overflowed, rewind to the burst's start and replay it step
        by step, so main_loop_step replans at the offending step.  A
        burst starts with the tree cadence's replan and ends at the next
        one.  Every step stops at tend (the device clamp); the host bound
        near tend only limits the steps wasted there.  Block ticks run one
        at a time.  Returns the steps done."""
        if self.use_block:
            self.main_loop_step()
            return 1
        if self.treespec is not None:
            self._tree_cadence()
            ntb = max(self.params.intparams["ntreebuildstep"], 1)
            n = min(n, ntb - self.Nsteps % ntb)
        n = min(n, BURST_CAP)
        tend = self.params.floatparams["tend"]
        if tend < 1e20:
            # stay clear of tend by a 2x dt margin (dt may grow)
            dt0 = float(self.state.dt)
            if dt0 > 0.0 and math.isfinite(dt0):
                n = min(n, int(max((tend - self.t) / dt0 * 0.5, 0.0)))
        if n <= 1:
            self.main_loop_step()
            return 1
        with self.timing.block("MAIN_LOOP"):
            start = cur = self.state
            for _ in range(n):
                cur = self._step_fn(cur)
            ovf, t_now = torch.stack(
                (cur.neib_overflow.to(cur.t.dtype), cur.t)).tolist()
            if ovf:
                self.state = start
                for _ in range(n):
                    self.main_loop_step()
                return n
            self.state = cur
        self.Nsteps += n
        self.t = float(t_now)
        return n

    def _init_output_cadence(self):
        """The first snapshot time, advanced past t (gandalf_tpu's
        _init_output_cadence without the snapshot)."""
        self.tsnapnext = self.params.floatparams["tsnapfirst"]
        while self.tsnapnext <= self.t:
            self.tsnapnext += self.params.floatparams["dt_snap"]

    def output(self, final: bool = False):
        """Advance the snapshot time once t has reached it, as
        gandalf_tpu's output does; no snapshot is written."""
        if self.t >= self.tsnapnext or final:
            self.tsnapnext += self.params.floatparams["dt_snap"]

    def Run(self, Nadvance: int = -1):
        """Advance until tend or Nstepsmax (or Nadvance more steps),
        advancing the snapshot time after each burst; no snapshot
        output."""
        if not self.setup_complete:
            self.SetupSimulation()
        tend = self.params.floatparams["tend"]
        nmax = (self.params.intparams["Nstepsmax"] if Nadvance < 0
                else self.Nsteps + Nadvance)
        while self.t < tend and self.Nsteps < nmax:
            self.main_loop_steps(nmax - self.Nsteps)
            self.output()
        self.output(final=True)


class GradhSphSimulation(SimulationBase):
    """Conservative grad-h SPH on one device, with a global timestep or
    block timesteps."""

    def __init__(self, params, device="cuda", dtype=torch.float32):
        super().__init__(params, device, dtype)
        self._bootstrap_fn = None
        self._blocksched = None
        # rows of the active passes: in all, and per pass of the last tick
        # (the Saitoh-Makino pass and overflow retries included)
        self.active_rows = 0
        self.last_tick_rows = []

    # -- parameters ------------------------------------------------------------
    def process_parameters(self):
        p = self.params
        ip, sp = p.intparams, p.stringparams
        if sp["sim"] not in ("sph", "gradhsph", "gradsph"):
            raise _unsupported(f"sim {sp['sim']!r}", "items 9-10")
        if sp["dust_forces"] not in ("none", "null", ""):
            raise _unsupported("dust", "item 9")
        if sp["time_dependent_avisc"] != "none":
            raise _unsupported("time_dependent_avisc", "item 9")
        if sp["supernova_feedback"] not in ("none", "null", ""):
            raise _unsupported("supernova feedback", "item 9")
        self._common_parameters()
        self.visc = ArtificialViscosity.from_params(p)
        self.integ = IntegratorConfig.from_params(p, energy_integration=True)
        self.hydro_forces = bool(ip["hydro_forces"])
        # hierarchical block timesteps on the grid path
        self.nlevels = max(ip["Nlevels"], 1)
        self.use_block = self.nlevels > 1
        self.block_cfg = BlockConfig(nlevels=self.nlevels,
                                     level_diff_max=ip["level_diff_max"])
        self.u_mode = "energy" if self.integ.energy_integration else "none"

    # -- setup -----------------------------------------------------------------
    def SetupSimulation(self, ic: Optional[Dict[str, np.ndarray]] = None):
        """Initial conditions, grid plan and bootstrap force pass.

        `ic` (keys r, v, m, h, u; optional t) replaces the generated IC,
        as arrays staged with ImportArray do in the JAX package."""
        self._require_device()
        with self.timing.block("SETUP"):
            self.process_parameters()
            if ic is None:
                with self.timing.block("GENERATE_IC"):
                    ic = generate_ic(self.params, self.eos)
            if "star" in ic or "ptype" in ic:
                raise _unsupported("stars and non-gas particle types",
                                   "item 9")
            if np.any(np.asarray(ic["m"]) <= 0.0):
                raise _unsupported("massless (dead) particles", "item 9")
            self.state = make_sph_state(ic["r"], ic["v"], ic["m"], ic["h"],
                                        ic["u"], device=self.device,
                                        dtype=self.dtype)
            s = self.state
            self.state = s.replace(
                alpha=torch.full_like(s.alpha, self.visc.alpha_visc))
            if "t" in ic:
                self.state = self.state.replace(t=torch.tensor(
                    float(ic["t"]), dtype=self.dtype, device=self.device))
            self._step_fn = self._build_step()
            self._bootstrap_fn = self._build_bootstrap()
            self._plan_grid(ic["r"], ic["h"])
            if self.self_gravity:
                self._plan_tree_buckets(_host(self.state.r))
            self._bootstrap_with_replans()
        self.t = float(self.state.t)
        self.setup_complete = True

    def _run_bootstrap(self):
        if self.use_block:
            self.state, self._blocksched = self._bootstrap_fn(self.state)
        else:
            self.state = self._bootstrap_fn(self.state)

    # -- the physics -----------------------------------------------------------
    def _hydro_pass(self, s: SphState) -> SphState:
        """density -> EOS -> hydro forces -> self-gravity at the current
        positions.  The overflow flag is the OR of both passes'."""
        s = hydro_pass_grid27(self.kern, self.visc, self.box,
                              self.gridspec, self.eos, self.h_fac,
                              self.h_converge, self.hydro_forces, s)
        if self.self_gravity:
            a_g, gpot, overflow = tree_gravity_grouped(
                self.treespec, s.bucket_map, s.r, self._gravity_mass(s),
                s.h, self.kern, zh=s.zeta * s.hfactor,
                periodic_extent=self._periodic_extent(),
                ewald_table=self.ewald_table, **self._mac_inputs(s))
            s = s.replace(a=s.a + a_g, gpot=gpot,
                          neib_overflow=s.neib_overflow | overflow)
        return s

    def _mac_inputs(self, s, spec=None) -> dict:
        """The accuracy MAC's target-side input for `spec` (default the
        simulation's TreeSpec), from the previous step
        (gandalf_tpu/sim/simulation.py:1451-1455): |a0| for gadget2,
        gpot for eigenmac."""
        mac = (spec or self.treespec).mac
        if mac == "gadget2":
            return {"amag": torch.sqrt(torch.sum(s.a0 * s.a0, -1))}
        if mac == "eigenmac":
            return {"gpot_prev": s.gpot}
        return {}

    def _gravity_mass(self, s: SphState):
        """Gravitating mass: gas (and cdm); icm, boundary and dust
        particles do not gravitate (dust only in two-fluid runs, which
        the port does not run)."""
        no_grav = ((s.ptype == ICM_TYPE) | (s.ptype == BOUNDARY_TYPE)
                   | (s.ptype == DUST_TYPE))
        return torch.where(no_grav, 0.0, s.m)

    def _build_bootstrap(self):
        """Initial force and timestep pass."""
        integ = self.integ

        def bootstrap(s: SphState) -> SphState:
            s = self._hydro_pass(s)
            s = s.replace(a0=s.a, dudt0=s.dudt, u0=s.u, r0=s.r, v0=s.v)
            dt_part = sph_timestep(integ, s, self.hydro_forces)
            if self.use_block:
                # the initial ladder; a tick is dt_base
                s, sched = init_schedule(self.block_cfg, s, dt_part)
                return s.replace(dt=sched.dt_base), sched
            return s.replace(dt=torch.min(dt_part))

        return bootstrap

    def _build_step(self):
        """One global-timestep KDK step: predict, wrap, hydro pass,
        correct, next dt.  The overflow flag is sticky across the steps
        of a burst (a mid-burst overflow must survive to its end).  With
        a finite tend the step's dt is clamped on the device to tend - t,
        so no step of a burst passes tend (ROADMAP fault F3)."""
        integ, box = self.integ, self.box
        tend = self.params.floatparams["tend"]
        bounded = math.isfinite(tend)

        def step(s: SphState) -> SphState:
            dt = s.dt
            if bounded:
                dt = torch.minimum(dt, tend - s.t)
            # never past tend, whatever the rounding of t + (tend - t)
            t = torch.clamp_max(s.t + dt, tend) if bounded else s.t + dt
            overflow_in = s.neib_overflow
            s = predict(integ, s, dt)
            s = s.replace(r=box.wrap(s.r), r0=box.wrap(s.r0))
            s = self._hydro_pass(s)
            s = s.replace(neib_overflow=s.neib_overflow | overflow_in)
            s = correct(integ, s, dt, torch.zeros_like(s.alpha))
            dt_next = torch.min(sph_timestep(integ, s, self.hydro_forces))
            return s.replace(t=t, dt=dt_next, nstep=s.nstep + 1)

        return step

    # -- block timesteps -------------------------------------------------------
    def _block_advance(self, s: SphState, B):
        """Drift every particle one tick, wrap, and refresh every
        particle's EOS from its predicted u (so inactive neighbours'
        pressure and sound match it).  Returns (state, active mask)."""
        s, active, t = advance(s, B, self.u_mode)
        s = s.replace(r=self.box.wrap(s.r), r0=self.box.wrap(s.r0), t=t)
        if self.u_mode != "none":
            u_n, p_n, c_n = self.eos.thermal_update(
                torch.clamp_min(s.rho, 1e-30), s.u)
            alive = s.alive
            s = s.replace(u=torch.where(alive, u_n, s.u),
                          pressure=torch.where(alive, p_n, s.pressure),
                          sound=torch.where(alive, c_n, s.sound))
        return s, active

    def _active_groups(self, ids: torch.Tensor) -> torch.Tensor:
        """The buckets holding the particles ids, ascending, int32."""
        mark = torch.zeros((self.treespec.n_leaves,), dtype=torch.bool,
                           device=self.device)
        mark[self._leaf_of[ids.long()].long()] = True
        return torch.nonzero(mark).flatten().to(torch.int32)

    def _active_pass(self, s: SphState, ids: torch.Tensor) -> SphState:
        """Density, EOS, hydro forces and levelneib of the particles ids
        (K1, K8, K9) and, with self-gravity, the tree walk of their
        buckets (K4, K5 over all buckets, K6 and K7 over the list), whose
        acceleration is added and potential set at ids only.  The
        overflow flag ORs into the state's."""
        self.active_rows += ids.numel()
        self.last_tick_rows.append(ids.numel())
        s, ovf = active_hydro_pass(self.kern, self.visc, self.gridspec,
                                   self.eos, self.h_fac, self.h_converge, s,
                                   ids, self.hydro_forces)
        if self.self_gravity:
            a_g, gpot, ovg = tree_gravity_active(
                self.treespec, s.bucket_map, s.r, self._gravity_mass(s),
                s.h, self.kern, s.zeta * s.hfactor, self._active_groups(ids),
                periodic_extent=self._periodic_extent())
            il = ids.long()
            s = s.replace(a=s.a.index_add(0, il, a_g[il]),
                          gpot=s.gpot.index_copy(0, il, gpot[il]))
            ovf = ovf | ovg
        return s.replace(neib_overflow=s.neib_overflow | ovf)

    def _block_tick(self):
        """One block tick: drift all, the active pass of the particles
        ending their step, a second pass for those the Saitoh-Makino
        limiter ends early, then the closing kick and the ladder update.
        The active sets are read to the host (one sync each).  On
        overflow, replan the grid (and the tree buckets with grown caps)
        from the pre-tick state and redo the tick from the pre-tick state
        and schedule, at most 5 attempts."""
        cfg, integ = self.block_cfg, self.integ
        prev, prev_sched = self.state, self._blocksched
        self.last_tick_rows = []
        for attempt in range(5):
            B = prev_sched
            s, active = self._block_advance(prev, B)
            s = self._active_pass(
                s, torch.nonzero(active).flatten().to(torch.int32))
            active2, nstep_p, level = check_timesteps(cfg, s, B, active)
            newly = torch.nonzero(active2 & ~active).flatten()
            if newly.numel():
                # the limiter's re-activations need fresh forces before
                # their closing kick
                s = self._active_pass(s, newly.to(torch.int32))
            dt_crit = sph_timestep(integ, s, self.hydro_forces)
            s, B = end_timestep(cfg, s, B, active2, level, nstep_p, dt_crit,
                                s.t, self.u_mode)
            s = s.replace(nstep=s.nstep + 1)
            if not bool(s.neib_overflow):
                self.state, self._blocksched = s, B
                return
            with self.timing.block("GRID_REPLAN"):
                self._n_grid_overflows += 1
                self._plan_grid(prev.r, prev.h,
                                growth=1.3 * (1.2 ** attempt))
                if self.treespec is not None:
                    # replaces self.state's (the pre-tick state's) map
                    self._plan_tree_buckets(_host(prev.r), grow_caps=True)
                    prev = self.state
        raise RuntimeError("neighbour overflow persists after 5 replans")

    # -- host loop -------------------------------------------------------------
    def main_loop_step(self):
        """One step, or one block tick with block timesteps (the ladder's
        tick is not clamped to tend, as in the JAX package)."""
        if not self.use_block:
            super().main_loop_step()
            return
        self._tree_cadence()
        with self.timing.block("MAIN_LOOP"):
            self._block_tick()
        self.Nsteps += 1
        self.t = float(self.state.t)
