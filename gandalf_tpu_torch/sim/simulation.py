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
``GradhSphSimulation`` for one configuration: grad-h SPH with the M4,
quintic or gaussian kernel, direct or tabulated (the quintic, gaussian
and tabulated kernels through K2, K3, K7-K9 only, so not with sinks,
stars, dust, cd2010 or SM2012; the gaussian not with self-gravity:
fault F23), the adiabatic, isothermal, barotropic, polytropic or radws EOS
(the opacity table's gamma, K27; with energy_integration = radws u
relaxes each step toward the radiative equilibrium that K28 finds at
the previous step's end, instead of integrating du/dt, and with rad_fb
the equilibrium takes K30's per-particle ambient temperature from the
sinks' accretion luminosity and the disc profile), mon97
viscosity (or none; with time_dependent_avisc = mm97 or cd2010 its
alpha evolves per particle) and optional conductivity, the structured
3^ndim shift grid (in 1D and 2D too, and with mirror or wall boundaries, whose
reflected images the grid holds in an image-cell layer beyond each
wall; hydro only there), KDK leapfrog with a global timestep or with
hierarchical block timesteps (``Nlevels > 1``), and optionally
self-gravity from the KD-bucket Barnes-Hut tree in 1-3 dims (frontier
walk; geometric, gadget2 or eigenmac MAC; monopole or quadrupole
moments, at every particle or expanded about each bucket's centre; the
Ewald sum of a 3D periodic box, fully periodic, slab or cylinder), with
its buckets replanned every ``ntreebuildstep`` steps.  It also runs star
and sink particles (``ops/sinks.py``), with a global timestep or block timesteps: stars from the IC, sink creation,
plain or smooth accretion (K18, K20), star-gas gravity (K16) and
star-star gravity (K14), with the accreted gas dead (masked out of the
grid and tree passes and frozen).  The sinks ride in the state
(``SphState.sinks``), so bursts and overflow rewinds carry them.  Dust
(``dust_forces`` = full_twofluid or test_particle; ``ops/dust.py``) runs
on the grid path with a global timestep or block timesteps, between
mirror walls and with self-gravity (the dust gravitates in two-fluid
runs): two type-masked grid passes give the gas its density and forces
and the dust its own h, then the semi-implicit drag (K23, K24) adds its
acceleration and heating.  The external analytic potentials (vertical,
plummer) act on the gas after its gravity and on the stars.  Options
outside that slice raise NotImplementedError naming their ROADMAP item;
dust with sinks or stars is refused (the JAX package's sink paths apply
no drag: fault F14), and so are external potentials under the compacted
block tick (which skips them there: fault F19).
With ``radiation`` = ionisation, treeray or monoionisation and sinks or
stars as sources, the ionisation field updates every ``nradstep`` steps
before the step, in the global step and the dense block tick
(``_radiation_update``: the multi-source Stromgren balance, K37; the
ray-traced OnTheSpot balance, K34 and K35; or the monochromatic
Monte-Carlo balance, K34 and K36), and a burst never crosses an update.

``SM2012SphSimulation`` is the counterpart of gandalf_tpu's: the same
controller with the Saitoh & Makino (2012) grid pass of
``ops/sm2012.py`` (K1, K25, K26) in place of the grad-h one.

A global step runs eagerly as a sequence of torch operations and kernel
launches on the simulation's device; on a CUDA device nothing in it
waits for the device, so ``main_loop_steps`` queues a burst of steps and
reads the overflow flag and the time once at its end.  A block tick
(the JAX package's active-compacted tick) drifts every particle, then
does the pair work of the active particles only (``ops/active_grid.py``,
and with self-gravity the tree walk of their buckets); it reads the
active set, the Saitoh-Makino set and the overflow flag on the host, so
it runs tick by tick.  With sinks a block tick is the JAX package's dense
tick instead: every particle drifts and takes the whole coupled pass,
then the neighbour-level pass (K22) and the ladder update, with the
sinks stepping at the tick's dt_base; with dust likewise, the drag taken
over each particle's own step.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from .._ext import require_m4
from ..integrate.block import (BlockConfig, advance, check_timesteps,
                               end_timestep, init_schedule)
from ..integrate.leapfrog import (IntegratorConfig, correct, predict,
                                  sph_timestep)
from ..kernels.smoothing import kernel_factory
from ..ops.active_grid import active_hydro_pass, levelneib_grid27
from ..ops.dust import DragLaw, drag_pass_grid
from ..ops import mcrt, treeray
from ..ops import sph_grid27 as g27
from ..ops.eos import RADIATION_SCHEMES, eos_factory
from ..ops.ewald import table_from_params
from ..ops.forces import ArtificialViscosity, cullen_dehnen_dense
from ..ops.gravity import (EXTERNAL_POTENTIALS, direct_softened,
                           external_potential)
from ..ops.ionisation import (IonisationConfig, apply_ionisation,
                              multi_source_ionisation)
from ..ops.radiative_fb import (DiscHeatingConfig, SinkHeatingConfig,
                                combined_ambient_temperature)
from ..ops.radws import energy_find_equi, radws_energy_integration
from ..ops.sinks import (SinkConfig, accrete_to_sinks,
                         apply_smooth_accretion, create_sinks, empty_sinks,
                         make_sinks, smooth_accretion_sums)
from ..ops.sm2012 import sm2012_hydro_pass_grid
from ..ops.sph_gravity import star_gas_forces
from ..ops.stellar import (default_stellar_table, load_stellar_table,
                           stellar_nlyc)
from ..ops.sph_grid27 import hydro_pass_grid27, plan_grid27
from ..ops.tree import (EWALD_BELOW_3D, grow_tree_caps, plan_buckets_kd,
                        plan_tree_for_buckets, tree_gravity_active,
                        tree_gravity_grouped, walk_stats_levels_native)
from ..state import (BOUNDARY_TYPE, DUST_TYPE, FLAG_DEAD, GAS_TYPE,
                     ICM_TYPE, DomainBox, SphState, make_sph_state)
from ..units import (L_SUN, M_JUP, M_SUN, R_SUN, SimUnits,
                     inscale_parameters)
from ..utils.timing import CodeTiming
from .ic import generate_ic

# queued steps per burst: each queued step keeps its input state alive
BURST_CAP = 8
# bucket size of the gravity tree (gandalf_tpu's _plan_tree_buckets)
LEAF_SIZE = 32
# creation slots when Nsinkfixed <= 0 (gandalf_tpu/sim/simulation.py:1365)
SINK_SLOTS = 16


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
    # whether the controller runs the radiation schemes
    RUNS_RADIATION = False

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
        if sim == "sm2012sph":
            return SM2012SphSimulation(params, device, dtype)
        if sim in ("meshlessfv", "mfvmuscl"):
            from .mfv_sim import MfvMusclSimulation

            return MfvMusclSimulation(params, device, dtype)
        if sim == "mfvrk":
            from .mfv_sim import MfvRungeKuttaSimulation

            return MfvRungeKuttaSimulation(params, device, dtype)
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
        if self.ndim not in (1, 2, 3):
            raise ValueError(f"ndim must be 1, 2 or 3, not {self.ndim}")
        if sp["radiation"] not in ("none", "null", "") \
                and not self.RUNS_RADIATION:
            # the JAX package's MFV controllers never read `radiation`
            raise _unsupported(
                f"radiation in {type(self).__name__} (the JAX package's "
                "controller ignores it: fault F26)", "item 12")
        if sp["neib_search"] == "bruteforce":
            raise _unsupported("neib_search = bruteforce",
                               "'Not to port': brute-force paths")
        self.units = SimUnits()
        self.units.setup_units(p)
        if not self.units.dimensionless:
            inscale_parameters(p, self.units)
        self.kern = kernel_factory(sp["kernel"], self.ndim,
                                   ip["tabulated_kernel"])
        self.eos = eos_factory(p, self.device, self.dtype)
        self.box = DomainBox.from_params(p)
        # radws: the relaxation toward radiative equilibrium replaces the
        # explicit integration of u (gandalf_tpu/sim/simulation.py:887-890)
        self.use_radws_energy = (sp["gas_eos"] == "radws"
                                 and sp["energy_integration"] == "radws")
        self.self_gravity = bool(ip["self_gravity"])
        if self.self_gravity:
            self._check_gravity_options()
            if self.kern.name == "gaussian":
                # the JAX package's gaussian wgrav and wpot are zero, so
                # its tree drops every support-tier pair's gravity
                raise NotImplementedError(
                    "self-gravity with the gaussian kernel: its softened "
                    "gravity kernels are zero in the JAX package, whose "
                    "tree then loses the gravity of every pair in a "
                    "support leaf (ROADMAP queue 3, fault F23)")
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
        KD buckets in 1-3 dims (every MAC, multipole and Ewald option of
        the JAX package; the Ewald sum in 3D only, as there)."""
        p = self.params
        if self.ndim != 3 and self.box.periodic_dims() \
                and p.intparams["ewald"]:
            raise NotImplementedError(EWALD_BELOW_3D)
        if self.box.mirror_walls():
            raise _unsupported("mirror/wall boundaries with self-gravity "
                               "(the JAX package's all-pairs path)",
                               "item 8")
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

    def alive_mask(self, s):
        """The alive mask the passes take for state `s`, or None where
        every particle is alive (no sinks, no dead particles)."""
        return None

    # -- grid plan -------------------------------------------------------------
    def _plan_grid(self, r, h, growth: float = 1.3, alive=None):
        """(Re)plan the structured grid from positions and h on the host,
        h_max over the `alive` particles (all without it): a dead
        particle's h = 1 would make the grid one cell.  With unchanged
        cells, a grown slot count overshoots by 25% so a slowly
        clustering core does not re-overflow within a few steps."""
        h_np = _host(h)
        if alive is not None:
            h_np = h_np[_host(alive)]
        h_max = float(h_np.max()) * growth
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
            self._plan_grid(self.state.r, self.state.h,
                            alive=self.state.alive)
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
                                        growth=1.3 * (1.2 ** attempt),
                                        alive=prev.alive)
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

    # the `sim` parameter values this controller runs
    SIM_NAMES = ("sph", "gradhsph", "gradsph")
    RUNS_RADIATION = True

    def __init__(self, params, device="cuda", dtype=torch.float32):
        super().__init__(params, device, dtype)
        self._bootstrap_fn = None
        self._blocksched = None
        # star and sink slots in the state, and dead (massless) particles
        self.has_sinks = False
        self._mask_dead = False
        self.has_dust = False
        # the radiation scheme's draws of packets (monoionisation): None
        # takes them from a torch.Generator (_mc_draws); a caller may set
        # a function (seed, ndot, n_packets, n_iter) -> draws
        self.mc_draw_fn = None
        # rows of the active passes: in all, and per pass of the last tick
        # (the Saitoh-Makino pass and overflow retries included)
        self.active_rows = 0
        self.last_tick_rows = []

    # -- parameters ------------------------------------------------------------
    def process_parameters(self):
        p = self.params
        ip, sp = p.intparams, p.stringparams
        if sp["sim"] not in self.SIM_NAMES:
            raise _unsupported(f"sim {sp['sim']!r}", "items 9-10")
        if sp["supernova_feedback"] not in ("none", "null", ""):
            raise _unsupported("supernova feedback", "item 9")
        self._common_parameters()
        self.visc = ArtificialViscosity.from_params(p)
        self.td_avisc_type = sp["time_dependent_avisc"]
        if self.td_avisc_type == "cd2010":
            require_m4(self.kern, "cd2010 viscosity (K21)")
        # external analytic potentials (gandalf_tpu/sim/simulation.py:
        # 957-965)
        self.extpot = sp["external_potential"]
        if self.extpot not in EXTERNAL_POTENTIALS:
            raise ValueError(
                f"Unrecognised external_potential: {self.extpot!r}")
        kgrav = ip["kgrav"]
        self.extpot_cfg = {
            "mplummer": p.floatparams["mplummer"],
            "rplummer": p.floatparams["rplummer"],
            "kgrav": kgrav, "avert": p.floatparams["avert"],
            "rzero": self.box.boxmin[kgrav] if kgrav < self.ndim else 0.0}
        # u is integrated explicitly for energy_eqn, and for radws without
        # the radws relaxation; the other EOS set it from rho
        # (gandalf_tpu/sim/simulation.py:891-893)
        self.integ = IntegratorConfig.from_params(
            p, energy_integration=sp["gas_eos"] == "energy_eqn" or (
                sp["gas_eos"] == "radws" and not self.use_radws_energy))
        self.hydro_forces = bool(ip["hydro_forces"])
        # hierarchical block timesteps on the grid path
        self.nlevels = max(ip["Nlevels"], 1)
        self.use_block = self.nlevels > 1
        if self.use_block and self.box.mirror_walls():
            raise _unsupported("mirror/wall boundaries with block timesteps "
                               "(the JAX package's all-pairs path)",
                               "item 8")
        self.block_cfg = BlockConfig(nlevels=self.nlevels,
                                     level_diff_max=ip["level_diff_max"])
        self.u_mode = "radws" if self.use_radws_energy else (
            "energy" if self.integ.energy_integration else "none")
        # sinks (gandalf_tpu/sim/simulation.py:984-993); rho_sink is in
        # code units after _common_parameters
        self.sink_cfg = SinkConfig(
            rho_sink=p.floatparams["rho_sink"],
            sink_radius=p.floatparams["sink_radius"],
            create=bool(ip["create_sinks"]),
            accrete=bool(ip["sink_particles"]))
        self.smooth_accretion = bool(ip["smooth_accretion"])
        if self.sink_cfg.create or self.sink_cfg.accrete:
            self._check_sink_options()
        self._radfb_parameters()
        self._radiation_parameters()
        # gas-dust drag (gandalf_tpu/sim/simulation.py:1042-1050)
        self.dust_forces = sp["dust_forces"]
        self.has_dust = self.dust_forces not in ("none", "null", "")
        self.drag_law = None
        if self.has_dust:
            if self.dust_forces not in ("full_twofluid", "test_particle"):
                raise ValueError(f"unknown dust_forces {self.dust_forces!r}")
            if self.sink_cfg.create or self.sink_cfg.accrete:
                raise self._dust_with_sinks()
            if self.radiation != "none":
                raise _unsupported("radiation with dust", "item 12")
            require_m4(self.kern, "gas-dust drag (K23, K24)")
            self.drag_law = DragLaw.from_params(p)

    def _radfb_parameters(self):
        """Radiative feedback (gandalf_tpu/sim/simulation.py:994-1044): on
        with rad_fb and the radws relaxation only; the sink-heating and
        disc-heating configurations in code units (the reference's
        SinkHeating constructor, RadiativeFB.cpp:171-211), temp_ambient,
        temp_au and r_smooth already scaled by inscale_parameters."""
        p = self.params
        ip, fp = p.intparams, p.floatparams
        self.rad_fb = bool(ip["rad_fb"]) and self.use_radws_energy
        self.radfb_sink_on = False
        self.radfb_sink_cfg = self.radfb_disc_cfg = None
        if not self.rad_fb:
            return
        u = self.units
        if u.dimensionless:
            rad_const = lsun = msun = rsun = 1.0
        else:
            R = u.r.outscale * u.r.outSI
            T = u.t.outscale * u.t.outSI
            E = u.E.outscale * u.E.outSI
            temp_unit = u.temp.outscale * u.temp.outSI
            stefboltz = 5.67037321e-8      # SI (the reference's Constants.h)
            rad_const = stefboltz * (R * R * T * temp_unit ** 4) / E
            lsun = L_SUN / (u.L.outscale * u.L.outSI)
            msun = M_SUN / (u.m.outscale * u.m.outSI)
            rsun = R_SUN / R
        self.radfb_sink_on = bool(ip["sink_heating"])
        self.radfb_sink_cfg = SinkHeatingConfig(
            rad_const=rad_const,
            temp_inf=fp["temp_ambient"] if ip["ambient_heating"] else 0.0,
            f_acc=fp["f_acc"], lsun=lsun, msun=msun, mjup=M_JUP / M_SUN,
            r_planet=fp["r_planet"] * rsun, r_bdwarf=fp["r_bdwarf"] * rsun,
            r_star=fp["r_star"] * rsun)
        ncentral = min(max(ip["disc_heating"], 0), 2)
        if ncentral:
            self.radfb_disc_cfg = DiscHeatingConfig(
                temp_au=fp["temp_au"], temp_q=fp["temp_q"],
                rsmooth=fp["r_smooth"], n_central=ncentral)

    def _radiation_parameters(self):
        """The radiation field (gandalf_tpu/sim/simulation.py:923-956):
        updated every nradstep steps from the sinks and stars, their
        N_LyC from the stellar table (stellar.dat in the working
        directory, else the built-in one); the monochromatic Monte-Carlo
        cross-section is the reference's 7.9e-18 cm^2 in code length
        units (MonochromaticIonisationMonteCarlo.cpp:71)."""
        p = self.params
        ip, fp = p.intparams, p.floatparams
        name = p.stringparams["radiation"]
        self.radiation = "none" if name in ("none", "null", "") else name
        self.nradstep = max(ip["nradstep"], 1)
        self.ion_cfg = None
        if self.radiation == "none":
            return
        if self.radiation not in RADIATION_SCHEMES:
            raise NotImplementedError(
                f"radiation scheme {self.radiation!r} not implemented "
                f"(available: {', '.join(RADIATION_SCHEMES)}), as in the "
                "JAX package")
        self.ion_cfg = IonisationConfig(
            temp_ion=fp["temp_ion"], temp_neutral=fp["temp0"],
            mu_ion=fp["mu_ion"], mu_bar=fp["mu_bar"],
            alphaB=fp["arecomb"], Ndotmin=fp["Ndotmin"])
        self.stellar_table = load_stellar_table("stellar.dat") \
            if os.path.exists("stellar.dat") else default_stellar_table()
        if self.units.dimensionless:
            self.mc_across = 7.9e-18
        else:
            r_cm = self.units.r.outscale * self.units.r.outSI * 100.0
            self.mc_across = 7.9e-18 / (r_cm * r_cm)

    @staticmethod
    def _dust_with_sinks():
        """Dust with sinks or stars: the JAX package's sink paths never
        apply the drag (ROADMAP fault F14), so the port refuses the
        combination."""
        return _unsupported("dust with sinks or stars (the JAX package's "
                            "sink paths apply no drag: fault F14)",
                            "item 9")

    def _check_sink_options(self):
        """The sink options the port runs: 3D, no mirror walls, M4."""
        require_m4(self.kern, "sinks or stars (K14, K16-K18, K20)")
        if self.ndim != 3:
            raise _unsupported("sinks at ndim < 3", "item 9")
        if self.box.mirror_walls():
            raise _unsupported("mirror/wall boundaries with sinks (the JAX "
                               "package's all-pairs path)", "item 8")

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
            ptype = ic.get("ptype")
            if ptype is not None and not (
                    self.has_dust and np.isin(ptype, (GAS_TYPE,
                                                      DUST_TYPE)).all()):
                raise _unsupported("particle types other than gas (and "
                                   "dust in a dust run)", "item 9")
            if self.has_dust and "star" in ic:
                raise self._dust_with_sinks()
            if "star" in ic:
                require_m4(self.kern,
                                  "sinks or stars (K14, K16-K18, K20)")
            # smooth accretion's floor (gandalf_tpu/sim/simulation.py:1339)
            self.mmean = float(np.asarray(ic["m"]).mean())
            self.state = make_sph_state(ic["r"], ic["v"], ic["m"], ic["h"],
                                        ic["u"], device=self.device,
                                        dtype=self.dtype)
            s = self.state
            # massless particles (accreted gas in old files) are dead
            dead = torch.as_tensor(np.asarray(ic["m"]) <= 0.0,
                                   device=self.device)
            # a time-dependent alpha starts at its floor
            # (gandalf_tpu/sim/simulation.py:1315-1318)
            alpha0 = (self.visc.alpha_visc_min if self.integ.td_avisc
                      else self.visc.alpha_visc)
            if ptype is not None:
                s = s.replace(ptype=torch.as_tensor(
                    np.asarray(ptype, dtype=np.int32), device=self.device))
            self.state = s.replace(
                alpha=torch.full_like(s.alpha, alpha0),
                flags=torch.where(dead, s.flags | FLAG_DEAD, s.flags),
                sinks=self._initial_sinks(ic))
            self.has_sinks = self.state.sinks is not None
            self._mask_dead = self.has_sinks or bool(dead.any())
            if self.use_block and not (self.has_sinks or self.has_dust):
                self._check_compacted_tick()
            if "t" in ic:
                self.state = self.state.replace(t=torch.tensor(
                    float(ic["t"]), dtype=self.dtype, device=self.device))
            self._step_fn = self._build_step()
            self._bootstrap_fn = self._build_bootstrap()
            self._plan_grid(ic["r"], ic["h"], alive=self.state.alive)
            if self.self_gravity:
                self._plan_tree_buckets(_host(self.state.r))
            self._bootstrap_with_replans()
        self.t = float(self.state.t)
        self.setup_complete = True

    def _check_compacted_tick(self):
        """Options that the compacted block tick (the block tick without
        sinks or dust) does not run: the JAX package's tick skips the
        external potential (f_active and f_active_grav,
        gandalf_tpu/sim/simulation.py:1135-1160, add none: fault F19),
        so the port refuses it."""
        if self.extpot != "none":
            raise _unsupported(
                "external potentials under block timesteps without sinks "
                "(the JAX package's compacted tick skips them: fault F19)",
                "item 9")

    def _initial_sinks(self, ic):
        """The star slots of the IC plus the creation slots (Nsinkfixed,
        else 16, with create_sinks), or None without either
        (gandalf_tpu/sim/simulation.py:1360-1373)."""
        nfix = self.params.intparams["Nsinkfixed"]
        n_extra = (nfix if nfix > 0 else SINK_SLOTS) \
            if self.sink_cfg.create else 0
        kw = dict(device=self.device, dtype=self.dtype)
        if "star" in ic:
            st = ic["star"]
            return make_sinks(st["r"], st["v"], st["m"], st["h"],
                              n_extra=n_extra, **kw)
        if self.sink_cfg.create:
            return empty_sinks(n_extra, self.ndim, **kw)
        return None

    def _run_bootstrap(self):
        if self.use_block:
            self.state, self._blocksched = self._bootstrap_fn(self.state)
        else:
            self.state = self._bootstrap_fn(self.state)

    def alive_mask(self, s: SphState):
        """s.alive where there may be dead particles (sinks, or dead gas
        in the ICs), else None."""
        return s.alive if self._mask_dead else None

    # -- the physics -----------------------------------------------------------
    def _hydro_pass(self, s: SphState) -> SphState:
        """density -> EOS -> hydro forces (_hydro_only_pass) ->
        self-gravity -> the external potential at the current positions,
        dead particles masked out where there may be any
        (gandalf_tpu/sim/simulation.py:1425-1488).  The overflow flag is
        the OR of both passes'."""
        alive = self.alive_mask(s)
        s = self._hydro_only_pass(s)
        if self.self_gravity:
            a_g, gpot, overflow = tree_gravity_grouped(
                self.treespec, s.bucket_map, s.r, self._gravity_mass(s),
                s.h, self.kern, zh=s.zeta * s.hfactor,
                periodic_extent=self._periodic_extent(),
                ewald_table=self.ewald_table, alive=alive,
                **self._mac_inputs(s))
            s = s.replace(a=s.a + a_g, gpot=gpot,
                          neib_overflow=s.neib_overflow | overflow)
        if self.extpot != "none":
            # after the force loop, on every particle, as the JAX package
            # adds it
            a_x, _, pot_x = external_potential(self.extpot, self.extpot_cfg,
                                               s.r, s.v)
            s = s.replace(a=s.a + a_x, gpot=s.gpot + pot_x)
        return s

    def _hydro_only_pass(self, s: SphState) -> SphState:
        """The grid pass: density, EOS and hydro forces; in a dust run
        _dust_hydro_pass's two type-masked passes."""
        if self.has_dust:
            return self._dust_hydro_pass(s)
        return hydro_pass_grid27(self.kern, self.visc, self.box,
                                 self.gridspec, self.eos, self.h_fac,
                                 self.h_converge, self.hydro_forces, s,
                                 alive=self.alive_mask(s))

    def _dust_hydro_pass(self, s: SphState) -> SphState:
        """The grid pass of a dust run (gandalf_tpu/sim/simulation.py:
        1496-1525): two type-masked passes (K1 and K2 each, K3 for the
        gas), the gas's density, EOS and forces from the gas alone, and
        the dust's own h, rho, zeta and hfactor from the dust alone with
        no hydro force; the dust carries no u, pressure or sound (the
        drag pass sets its sound speed)."""
        alive = s.alive
        is_dust = s.ptype == DUST_TYPE
        args = (self.kern, self.visc, self.box, self.gridspec, self.eos,
                self.h_fac, self.h_converge)
        s_g = hydro_pass_grid27(*args, self.hydro_forces, s,
                                alive=alive & ~is_dust)
        s_d = hydro_pass_grid27(*args, False, s, alive=alive & is_dust)

        def pick(g, d):
            return torch.where(is_dust if g.dim() == 1 else is_dust[:, None],
                               d, g)

        z = torch.zeros_like(s.u)
        return s.replace(
            h=pick(s_g.h, s_d.h), rho=pick(s_g.rho, s_d.rho),
            invomega=pick(s_g.invomega, s_d.invomega),
            zeta=pick(s_g.zeta, s_d.zeta),
            hfactor=pick(s_g.hfactor, s_d.hfactor), u=pick(s_g.u, z),
            pressure=pick(s_g.pressure, z), sound=pick(s_g.sound, z),
            a=pick(s_g.a, torch.zeros_like(s.a)), dudt=pick(s_g.dudt, z),
            div_v=pick(s_g.div_v, z),
            neib_overflow=s_g.neib_overflow | s_d.neib_overflow)

    def _apply_drag(self, s: SphState, dt) -> SphState:
        """The gas-dust drag (K23, K24) added after the hydro and gravity
        pass, over a step of dt (a scalar, or each particle's step under
        block timesteps; 0 at the bootstrap: the instantaneous drag
        force): a and du/dt gain the drag's, and the dust takes the
        drag's sound speed and |dv|/h (gandalf_tpu/sim/simulation.py:
        1954-2005, grid branch).  The overflow of the pass's binning
        (the alive particles of both types and their images) ORs into
        the state's."""
        d, overflow = drag_pass_grid(
            self.kern, self.drag_law, self.gridspec, self.box, dt, s,
            s.alive, self.dust_forces == "test_particle")
        is_dust = s.ptype == DUST_TYPE
        return s.replace(
            a=s.a + d.a_drag, dudt=s.dudt + d.dudt,
            sound=torch.where(is_dust, d.sound, s.sound),
            div_v=torch.where(is_dust, d.div_v, s.div_v),
            neib_overflow=s.neib_overflow | overflow)

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
        """Gravitating mass per particle: gas (and cdm) always, dust only
        in full two-fluid runs, icm and boundary particles never
        (gandalf_tpu/sim/simulation.py:571-581)."""
        no_grav = (s.ptype == ICM_TYPE) | (s.ptype == BOUNDARY_TYPE)
        if self.dust_forces != "full_twofluid":
            no_grav = no_grav | (s.ptype == DUST_TYPE)
        return torch.where(no_grav, 0.0, s.m)

    # -- sinks ----------------------------------------------------------------
    def _sink_coupled_pass(self, s: SphState) -> SphState:
        """The gas pass, then star-gas (K16) and star-star (K14) gravity,
        with dead gas frozen (gandalf_tpu/sim/simulation.py:1610-1640)."""
        s = self._hydro_pass(s)
        sk, alive = s.sinks, s.alive
        m_live = torch.where(alive, s.m, 0.0)
        m_star = torch.where(sk.active, sk.m, 0.0)
        a_gs, gp_gs, a_st, _ = star_gas_forces(
            self.kern, s.r, m_live, s.h, sk.r, m_star, sk.h, sk.active)
        ss = direct_softened(sk.r, sk.v, m_star, sk.h, self.kern)
        a_star = a_st + ss.a
        if self.extpot != "none":
            # the stars feel the external field too
            # (gandalf_tpu/sim/simulation.py:1626-1632)
            a_star = a_star + external_potential(
                self.extpot, self.extpot_cfg, sk.r, sk.v)[0]
        sk = sk.replace(a=torch.where(sk.active[:, None], a_star, 0.0))
        return s.replace(
            a=torch.where(alive[:, None], s.a + a_gs, 0.0),
            dudt=torch.where(alive, s.dudt, 0.0),
            gpot=s.gpot + torch.where(alive, gp_gs, 0.0), sinks=sk)

    def _sink_create_accrete(self, s: SphState, dt) -> SphState:
        """Sink creation (K17) and plain (K18) or smooth (K20) accretion
        over a step of size dt (a block tick's dt_base), with the
        accretion rate; the eaten gas dies, smoothly accreted gas keeps
        what is left of its mass (gandalf_tpu/sim/simulation.py:
        1642-1680)."""
        cfg, sk, alive = self.sink_cfg, s.sinks, s.alive
        m_before = sk.m
        if cfg.create:
            sk, alive = create_sinks(cfg, sk, s.r, s.v, s.m, s.h, s.rho,
                                     alive)
            m_before = sk.m      # creation mass is not accretion
        if cfg.accrete:
            if self.smooth_accretion:
                fp = self.params.floatparams
                dm, sums = smooth_accretion_sums(
                    cfg, sk, s.r, s.v, s.m, s.rho, s.sound, alive, dt,
                    self.kern, self.mmean, alpha_ss=fp["alpha_ss"],
                    smooth_accrete_frac=fp["smooth_accrete_frac"],
                    smooth_accrete_dt=fp["smooth_accrete_dt"])
                sk, m_new, alive = apply_smooth_accretion(
                    sk, s.r, s.v, s.m, dm, sums["claim"], alive, self.kern)
                s = s.replace(m=m_new)
            else:
                sk, alive = accrete_to_sinks(cfg, sk, s.r, s.v, s.m, alive,
                                             self.kern)
            sk = sk.replace(mdot=(sk.m - m_before)
                            / torch.clamp_min(dt, 1e-30))
        return self._kill_eaten(s.replace(sinks=sk), alive)

    @staticmethod
    def _kill_eaten(s: SphState, alive_new) -> SphState:
        """Mark the newly dead gas: FLAG_DEAD, zero mass and motion
        (gandalf_tpu/sim/simulation.py:1722-1738)."""
        died = s.alive & ~alive_new
        col = died[:, None]
        return s.replace(
            flags=torch.where(died, s.flags | FLAG_DEAD, s.flags),
            m=torch.where(died, 0.0, s.m),
            v=torch.where(col, 0.0, s.v), v0=torch.where(col, 0.0, s.v0),
            a=torch.where(col, 0.0, s.a), a0=torch.where(col, 0.0, s.a0),
            dudt=torch.where(died, 0.0, s.dudt),
            dudt0=torch.where(died, 0.0, s.dudt0))

    def _sink_timestep(self, sk):
        """The stars' acceleration timestep bound (Sinks::Timestep
        analogue; gandalf_tpu/sim/simulation.py:1704-1711)."""
        amag = torch.sqrt(torch.sum(sk.a * sk.a, dim=-1))
        dt = self.integ.accel_mult * torch.sqrt(sk.h / (amag + 1e-30))
        return torch.min(torch.where(sk.active, dt, 1e30))

    def _global_timestep(self, s: SphState):
        """The next global dt: the SPH criteria, with sinks over the
        alive gas and with the stars' bound (_hybrid_timestep)."""
        dt_part = sph_timestep(self.integ, s, self.hydro_forces)
        if not self.has_sinks:
            return torch.min(dt_part)
        dt_gas = torch.min(torch.where(s.alive, dt_part, 1e30))
        return torch.minimum(dt_gas, self._sink_timestep(s.sinks))

    def _build_bootstrap(self):
        """Initial force and timestep pass (with the instantaneous drag
        force, dt = 0, in a dust run)."""
        integ = self.integ

        def bootstrap(s: SphState) -> SphState:
            if self.has_sinks:
                s = self._sink_coupled_pass(s)
                sk = s.sinks
                s = s.replace(sinks=sk.replace(a0=sk.a, r0=sk.r, v0=sk.v))
            else:
                s = self._hydro_pass(s)
                if self.has_dust:
                    s = self._apply_drag(s, torch.zeros_like(s.t))
            if self.use_radws_energy:
                s = self._radws_equilibrium(s)
            s = s.replace(a0=s.a, dudt0=s.dudt, u0=s.u, r0=s.r, v0=s.v)
            if self.use_block:
                # the initial ladder; a tick is dt_base, which the sinks'
                # bound caps (gandalf_tpu/sim/simulation.py:1751-1764)
                dt_part = sph_timestep(integ, s, self.hydro_forces)
                dt_extra = (self._sink_timestep(s.sinks) if self.has_sinks
                            else None)
                s, sched = init_schedule(self.block_cfg, s, dt_part,
                                         dt_extra=dt_extra)
                return s.replace(dt=sched.dt_base), sched
            return s.replace(dt=self._global_timestep(s))

        return bootstrap

    def _build_step(self):
        """One global-timestep KDK step: predict, wrap, hydro pass (and
        the drag over dt in a dust run), correct, next dt; with sinks the stars drift and kick at the same
        dt around the coupled pass, then sinks form and accrete
        (gandalf_tpu/sim/simulation.py:1891-1923); with a time-dependent
        alpha, _td_avisc's rate goes into the closing kick.  The overflow
        flag is sticky across the steps of a burst (a mid-burst overflow must
        survive to its end).  With a finite tend the step's dt is clamped
        on the device to tend - t, so no step of a burst passes tend
        (ROADMAP fault F3)."""
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
            if self.use_radws_energy:
                # the relaxation toward the previous step's equilibrium
                # (EnergyRadws::EnergyIntegration)
                s = s.replace(u=radws_energy_integration(
                    s.u0, s.ueq, s.dt_therm, dt))
            # boundary enforcement: wrap, then reflect across mirror walls
            r, v = box.reflect(box.wrap(s.r), s.v)
            s = s.replace(r=r, v=v, r0=box.wrap(s.r0))
            if self.has_sinks:
                sk = s.sinks
                s = s.replace(sinks=sk.replace(
                    r=sk.r0 + sk.v0 * dt + 0.5 * sk.a0 * dt * dt,
                    v=sk.v0 + sk.a0 * dt))
                s = self._sink_coupled_pass(s)
            else:
                s = self._hydro_pass(s)
                if self.has_dust:
                    s = self._apply_drag(s, dt)
            s = s.replace(neib_overflow=s.neib_overflow | overflow_in)
            s, dal = self._td_avisc(s)
            s = correct(integ, s, dt, dal)
            if self.use_radws_energy:
                # the next relaxation starts here, toward the equilibrium
                # of this step's end
                s = self._radws_equilibrium(s)
                s = s.replace(u0=s.u, dudt0=s.dudt)
            if self.has_sinks:
                sk = s.sinks
                v_c = sk.v + 0.5 * dt * (sk.a - sk.a0)
                s = s.replace(sinks=sk.replace(v=v_c, r0=sk.r, v0=v_c,
                                               a0=sk.a))
                s = self._sink_create_accrete(s, dt)
            return s.replace(t=t, dt=self._global_timestep(s),
                             nstep=s.nstep + 1)

        return step

    # -- radws -----------------------------------------------------------------
    def _radws_equilibrium(self, s: SphState) -> SphState:
        """(ueq, dt_therm) at the end of a step (EnergyRadws::EndTimestep;
        gandalf_tpu/sim/simulation.py:2007-2031) through K28, with col2
        from max(gpot, 0).  With radiative feedback and sinks the ambient
        temperature is K30's per-particle field; sink_heating = 0 masks
        every slot out of it, the disc term included, as there."""
        temp_amb, sk = None, s.sinks
        if self.rad_fb and sk is not None:
            act = sk.active if self.radfb_sink_on \
                else torch.zeros_like(sk.active)
            temp_amb = combined_ambient_temperature(
                self.radfb_sink_cfg, self.radfb_disc_cfg, s.r, sk.r, sk.m,
                sk.mdot, sk.h * self.sink_cfg.sink_radius, act)
        ueq, dt_therm = energy_find_equi(self.eos.table, s.rho, s.u, s.dudt,
                                         s.gpot, temp_amb)
        return s.replace(ueq=ueq, dt_therm=dt_therm)

    def _radws_refresh(self, s: SphState, active) -> SphState:
        """A block tick's (ueq, dt_therm), refreshed for the particles
        ending their step only (gandalf_tpu/sim/simulation.py:1172-1178,
        :1835-1842, :1877-1884); the state as it is without the radws
        relaxation."""
        if not self.use_radws_energy:
            return s
        s2 = self._radws_equilibrium(s)
        return s.replace(ueq=torch.where(active, s2.ueq, s.ueq),
                         dt_therm=torch.where(active, s2.dt_therm,
                                              s.dt_therm))

    # -- time-dependent viscosity ---------------------------------------------
    def _dalphadt(self, s: SphState):
        """The Morris & Monaghan (1997) rate of alpha
        (gandalf_tpu/sim/simulation.py:2033-2040); zero with a fixed
        alpha."""
        if not self.integ.td_avisc:
            return torch.zeros_like(s.alpha)
        visc = self.visc
        return (0.1 * s.sound * (visc.alpha_visc_min - s.alpha) / s.h
                + torch.clamp_min(-s.div_v, 0.0)
                * (visc.alpha_visc - s.alpha))

    def _td_avisc(self, s: SphState):
        """(state, dalphadt) after a global step's pass
        (gandalf_tpu/sim/simulation.py:2042-2069): cd2010 raises alpha at
        once to the Cullen & Dehnen target (K21 over the alive particles,
        without mirror images) and returns its decay rate; mm97 returns
        _dalphadt."""
        if not self.integ.td_avisc:
            return s, torch.zeros_like(s.alpha)
        if self.td_avisc_type == "cd2010":
            alpha_new, dal = cullen_dehnen_dense(
                self.kern, self.visc, self.gridspec, s.r, s.v, s.a, s.m,
                s.h, s.rho, s.sound, s.hfactor, s.alpha, s.alive)
            return s.replace(alpha=alpha_new), dal
        return s, self._dalphadt(s)

    # -- block timesteps -------------------------------------------------------
    def _block_advance(self, s: SphState, B):
        """Drift every particle one tick, wrap, and refresh every
        particle's EOS from its predicted u (so inactive neighbours'
        pressure and sound match it).  Returns (state, active mask)."""
        s, active, t = advance(s, B, self.u_mode)
        r, v = self.box.reflect(self.box.wrap(s.r), s.v)
        s = s.replace(r=r, v=v, r0=self.box.wrap(s.r0), t=t)
        if self.u_mode != "none":
            eos_kw = ({"ionfrac": s.ionfrac} if self.eos.needs_ionfrac
                      else {})
            u_n, p_n, c_n = self.eos.thermal_update(
                torch.clamp_min(s.rho, 1e-30), s.u, **eos_kw)
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

    def _advance_alpha(self, s: SphState, B) -> SphState:
        """A block tick's alpha step, _dalphadt times dt_base, for every
        particle and whatever the scheme: cd2010 too evolves by MM97's
        law under block timesteps, as in the JAX package
        (gandalf_tpu/sim/simulation.py:1168-1171; ROADMAP fault F13)."""
        if not self.integ.td_avisc:
            return s
        return s.replace(alpha=s.alpha + self._dalphadt(s) * B.dt_base)

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
            s = self._advance_alpha(s, B)
            s = self._radws_refresh(s, active2)
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
                                growth=1.3 * (1.2 ** attempt),
                                alive=prev.alive)
                if self.treespec is not None:
                    # replaces self.state's (the pre-tick state's) map
                    self._plan_tree_buckets(_host(prev.r), grow_caps=True)
                    prev = self.state
        raise RuntimeError("neighbour overflow persists after 5 replans")

    def _dense_tick(self, s: SphState, B):
        """One dense block tick from state s and schedule B, the JAX
        package's tick with sinks (gandalf_tpu/sim/simulation.py:
        1814-1853) or with dust (:1854-1880): drift every particle (and
        the sinks, at dt_base), wrap and reflect, the whole pass of every
        particle (the coupled pass with sinks; the hydro pass and the
        drag over each particle's own step, nstep_part dt_base, with
        dust), the neighbour levels of every alive particle (K22),
        alpha's step, the Saitoh-Makino limiter, with sinks their closing
        kick, creation and accretion over dt_base, then the closing kick
        and the ladder update (with the sinks' bound)."""
        cfg, integ = self.block_cfg, self.integ
        dtb = B.dt_base
        s, active, t = advance(s, B, self.u_mode)
        r, v = self.box.reflect(self.box.wrap(s.r), s.v)
        s = s.replace(r=r, v=v, r0=self.box.wrap(s.r0))
        if self.has_sinks:
            sk = s.sinks
            s = s.replace(sinks=sk.replace(
                r=sk.r0 + sk.v0 * dtb + 0.5 * sk.a0 * dtb * dtb,
                v=sk.v0 + sk.a0 * dtb))
            s = self._sink_coupled_pass(s)
        else:
            s = self._hydro_pass(s)
            s = self._apply_drag(s, B.nstep_part.to(s.m.dtype) * dtb)
        s = s.replace(levelneib=levelneib_grid27(
            self.kern, self.gridspec, s.r, s.h, s.level, s.alive))
        s = self._advance_alpha(s, B)
        active, nstep_p, level = check_timesteps(cfg, s, B, active)
        s = self._radws_refresh(s, active)
        dt_crit = sph_timestep(integ, s, self.hydro_forces)
        dt_extra = None
        if self.has_sinks:
            sk = s.sinks
            v_c = sk.v + 0.5 * dtb * (sk.a - sk.a0)
            s = s.replace(sinks=sk.replace(v=v_c, r0=sk.r, v0=v_c,
                                           a0=sk.a))
            s = self._sink_create_accrete(s, dtb)
            dt_extra = self._sink_timestep(s.sinks)
        s, B = end_timestep(cfg, s, B, active, level, nstep_p, dt_crit, t,
                            self.u_mode, dt_extra=dt_extra)
        self.active_rows += s.N
        self.last_tick_rows.append(s.N)
        return s.replace(nstep=s.nstep + 1), B

    def _block_dense_tick(self):
        """One dense tick (_dense_tick), every particle's pass each tick
        as the JAX package chose for sinks and for dust
        (gandalf_tpu/sim/simulation.py:1076-1085); on overflow the state,
        its sinks and the schedule rewind together, the grid (and the
        tree buckets with grown caps) is replanned from the pre-tick
        state and the tick redone, at most 5 attempts."""
        prev, prev_sched = self.state, self._blocksched
        self.last_tick_rows = []
        for attempt in range(5):
            s, B = self._dense_tick(prev, prev_sched)
            if not bool(s.neib_overflow):
                self.state, self._blocksched = s, B
                return
            with self.timing.block("GRID_REPLAN"):
                self._n_grid_overflows += 1
                self._plan_grid(prev.r, prev.h,
                                growth=1.3 * (1.2 ** attempt),
                                alive=prev.alive)
                if self.treespec is not None:
                    # replaces self.state's (the pre-tick state's) map
                    self._plan_tree_buckets(_host(prev.r), grow_caps=True)
                    prev = self.state
        raise RuntimeError("neighbour overflow persists after 5 replans")

    # -- radiation -------------------------------------------------------------
    def _radiation_due(self) -> bool:
        """Whether the radiation field updates before the next step: a
        radiation scheme with sinks or stars, every nradstep steps."""
        return (self.radiation != "none" and self.has_sinks
                and self.Nsteps % self.nradstep == 0)

    def _mc_draws(self, seed: int, ndot, n_packets: int, n_iter: int):
        """The packets' sources and directions of each Monte-Carlo
        iteration, from a torch.Generator on the state's device seeded
        with `seed`."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return mcrt.mc_draws(gen, ndot, n_packets, self.ndim, n_iter)

    def _radiation_field(self, s: SphState, ndot):
        """(N,) ionised flags of the scheme from the sinks' N_LyC
        (gandalf_tpu/sim/simulation.py:2072-2138): treeray's ray-traced
        OnTheSpot balance (K34, K35), the monochromatic Monte-Carlo
        balance (K34, K36) read back at each particle's cell, or the
        multi-source Stromgren prefixes (K37) over every particle."""
        sk, cfg = s.sinks, self.ion_cfg
        if self.radiation == "ionisation":
            return multi_source_ionisation(cfg, s.r, s.m, s.rho, sk.r, ndot,
                                           sk.active)
        spec = self.gridspec
        b = g27.bin_particles(spec, s.r, discard=~s.alive)
        rho_cell, nh2_cell = treeray.cell_field(spec, b, s.m, s.rho,
                                                cfg.mu_bar)
        if self.radiation == "treeray":
            return treeray.treeray_ionisation(spec, nh2_cell, s.r, sk.r,
                                              ndot, sk.active, cfg.alphaB)
        p = self.params
        n_pack = max(int(p.floatparams["Nphotonratio"]) * s.N, 4096)
        seed = p.intparams["randseed"] + 7919 * self.Nsteps
        n_iter = max(p.intparams["Nraditerations"], 4)
        draws = (self.mc_draw_fn or self._mc_draws)(seed, ndot, n_pack,
                                                    n_iter)
        xHI = mcrt.monochromatic_ionisation_mc(
            spec, rho_cell / cfg.mu_bar, sk.r, ndot, draws,
            sigma=self.mc_across, alphaB=cfg.alphaB)
        flat, inside = treeray.flat_cell_index(spec, s.r)
        return inside & (xHI.reshape(-1)[flat] < 0.5) & s.alive

    def _radiation_update(self):
        """Update the ionisation field from the sinks and stars
        (radiation->UpdateRadiationField, SphSimulation.cpp:671-679):
        the scheme's flags, the ionised and neutral temperature floors,
        the EOS refresh with the new ionfrac and the timestep clamped to
        the hot gas's (gandalf_tpu/sim/simulation.py:2139-2153)."""
        s = self.state
        ndot = stellar_nlyc(self.stellar_table, s.sinks.m)
        ion = self._radiation_field(s, ndot)
        u_new, _ = apply_ionisation(self.ion_cfg, self.eos.gammam1, ion, s.u)
        s = s.replace(u=u_new, u0=u_new, ionfrac=ion.to(s.u.dtype))
        u2, p2, c2 = self.eos.thermal_update(
            torch.clamp_min(s.rho, 1e-30), s.u, ionfrac=s.ionfrac)
        s = s.replace(u=u2, u0=u2, pressure=p2, sound=c2)
        dt_part = torch.where(s.alive,
                              sph_timestep(self.integ, s, self.hydro_forces),
                              1e30)
        self.state = s.replace(dt=torch.minimum(s.dt, torch.min(dt_part)))

    # -- host loop -------------------------------------------------------------
    def main_loop_step(self):
        """One step, or one block tick with block timesteps (the ladder's
        tick is not clamped to tend, as in the JAX package): the dense
        tick with sinks or dust, else the active-compacted one.  Every
        nradstep steps the radiation field updates first."""
        if self._radiation_due():
            with self.timing.block("RADIATION"):
                self._radiation_update()
        if not self.use_block:
            super().main_loop_step()
            return
        self._tree_cadence()
        with self.timing.block("MAIN_LOOP"):
            if self.has_sinks or self.has_dust:
                self._block_dense_tick()
            else:
                self._block_tick()
        self.Nsteps += 1
        self.t = float(self.state.t)

    def main_loop_steps(self, n: int) -> int:
        """SimulationBase.main_loop_steps, with a burst that never crosses
        a radiation update: a due update takes one step, and a burst ends
        before the next one."""
        if self.radiation != "none" and self.has_sinks:
            k = self.Nsteps % self.nradstep
            if k == 0:
                self.main_loop_step()
                return 1
            n = min(n, self.nradstep - k)
        return super().main_loop_steps(n)


class SM2012SphSimulation(GradhSphSimulation):
    """Saitoh & Makino (2012) density-independent SPH (gandalf_tpu's
    SM2012SphSimulation, :2283-2346; GANDALF's SM2012SphSimulation).  The
    grad-h controller's steps, tree gravity, sinks and stars, with the
    grid pass of ops/sm2012.py (K1, K25, K26): the density iteration
    carries the smoothed energy density q and the force uses u_i u_j
    (1/q_i + 1/q_j) instead of P Omega / rho^2; invomega = 1 and zeta = 0,
    so the tree's zeta correction vanishes.  energy_eqn and isothermal
    only.  Refused where the JAX package runs something other than the
    SM2012 grid pass: mirror walls (its all-pairs path, item 8), dust
    (one untyped pass over gas and dust: fault F18) and block timesteps
    without sinks (its compacted tick runs grad-h SPH: fault F17)."""

    SIM_NAMES = ("sm2012sph",)

    def process_parameters(self):
        super().process_parameters()
        sp = self.params.stringparams
        self.gamma = self.params.floatparams["gamma_eos"]
        if sp["gas_eos"] not in ("energy_eqn", "isothermal"):
            raise ValueError("sm2012sph supports energy_eqn/isothermal only")
        if self.box.mirror_walls():
            raise _unsupported(
                "mirror/wall boundaries in SM2012 (the JAX package's "
                "all-pairs path)", "item 8")
        if self.has_dust:
            raise _unsupported(
                "dust in SM2012 (the JAX package runs gas and dust through "
                "one untyped SM2012 pass: fault F18)", "item 9")
        if self.radiation != "none":
            raise _unsupported("radiation in SM2012", "item 12")
        require_m4(self.kern, "SM2012 SPH (K25, K26)")

    def _check_compacted_tick(self):
        """The JAX package's compacted block tick calls the grad-h
        active_hydro_pass (gandalf_tpu/sim/simulation.py:1077-1089,
        1135-1147), so every tick after the SM2012 bootstrap runs grad-h
        SPH (fault F17): refused."""
        raise _unsupported(
            "SM2012 under block timesteps without sinks (the JAX package's "
            "compacted tick runs grad-h SPH: fault F17)", "item 9")

    def _hydro_only_pass(self, s: SphState) -> SphState:
        s, _ = sm2012_hydro_pass_grid(
            self.kern, self.visc, self.gamma, self.gridspec, self.h_fac,
            self.h_converge, s, self.alive_mask(s), self.hydro_forces)
        return s
