"""Grad-h SPH simulation controller, hydro-only global-timestep slice.

Counterpart of ``gandalf_tpu/sim/simulation.py:GradhSphSimulation`` for
one configuration: grad-h SPH with the M4 kernel, the adiabatic EOS,
mon97 viscosity (or none) and optional conductivity, the structured
27-shift grid, KDK leapfrog with a global timestep.  Options outside
that slice raise NotImplementedError naming their ROADMAP item.

The step runs eagerly as a sequence of torch operations and kernel
launches on the simulation's device; on a CUDA device nothing in it
waits for the device, so ``main_loop_steps`` queues a burst of steps and
reads the overflow flag and the time once at its end.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from gandalf_tpu.sim.ic import generate_ic
from gandalf_tpu.units import SimUnits, inscale_parameters
from gandalf_tpu.utils.timing import CodeTiming

from ..integrate.leapfrog import (IntegratorConfig, correct, predict,
                                  sph_timestep)
from ..kernels.smoothing import kernel_factory
from ..ops.eos import eos_factory
from ..ops.forces import ArtificialViscosity
from ..ops.sph_grid27 import hydro_pass_grid27, plan_grid27
from ..state import DomainBox, SphState, make_sph_state

# queued steps per burst: each queued step keeps its input state alive
BURST_CAP = 8


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, {item})")


class GradhSphSimulation:
    """Conservative grad-h SPH with a global timestep on one device.

    `device` and `dtype` place every state tensor; float32 is the working
    type on a GPU, float64 the reference-grade type."""

    def __init__(self, params, device="cpu", dtype=torch.float32):
        self.params = params
        self.device = torch.device(device)
        self.dtype = dtype
        self.ndim = params.intparams["ndim"]
        self.state: Optional[SphState] = None
        self.gridspec = None
        self.Nsteps = 0
        self.t = 0.0
        self.setup_complete = False
        self.timing = CodeTiming()
        self._n_grid_overflows = 0
        self._step_fn = None
        self._bootstrap_fn = None

    # -- parameters ------------------------------------------------------------
    def process_parameters(self):
        p = self.params
        ip, sp = p.intparams, p.stringparams
        if sp["sim"] not in ("sph", "gradhsph", "gradsph"):
            raise _unsupported(f"sim {sp['sim']!r}", "items 9-11")
        if self.ndim != 3:
            raise _unsupported("ndim != 3", "item 3")
        if ip["self_gravity"]:
            raise _unsupported("self_gravity", "item 4")
        if max(ip["Nlevels"], 1) > 1:
            raise _unsupported("Nlevels > 1 (block timesteps)", "item 7")
        if ip["sink_particles"] or ip["create_sinks"]:
            raise _unsupported("sink particles", "item 9")
        if sp["dust_forces"] not in ("none", "null", ""):
            raise _unsupported("dust", "item 9")
        if sp["gas_eos"] == "radws":
            raise _unsupported("radws", "item 9")
        if sp["radiation"] not in ("none", "null", ""):
            raise _unsupported("radiation", "item 12")
        if sp["time_dependent_avisc"] != "none":
            raise _unsupported("time_dependent_avisc", "item 9")
        if sp["external_potential"] != "none":
            raise _unsupported("external potentials", "item 9")
        if sp["supernova_feedback"] not in ("none", "null", ""):
            raise _unsupported("supernova feedback", "item 9")
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
        self.visc = ArtificialViscosity.from_params(p)
        self.box = DomainBox.from_params(p)
        if self.box.mirror_walls():
            raise _unsupported("mirror/wall boundaries", "item 8")
        self.integ = IntegratorConfig.from_params(p, energy_integration=True)
        self.hydro_forces = bool(ip["hydro_forces"])
        self.h_fac = p.floatparams["h_fac"]
        self.h_converge = p.floatparams["h_converge"]

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

    # -- setup -----------------------------------------------------------------
    def SetupSimulation(self, ic: Optional[Dict[str, np.ndarray]] = None):
        """Initial conditions, grid plan and bootstrap force pass.

        `ic` (keys r, v, m, h, u; optional t) replaces the generated IC,
        as arrays staged with ImportArray do in the JAX package."""
        with self.timing.block("SETUP"):
            self.process_parameters()
            if ic is None:
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
            self.state = self._bootstrap_fn(self.state)
            tries = 0
            while bool(self.state.neib_overflow):
                tries += 1
                if tries > 5:
                    raise RuntimeError(
                        "bootstrap neighbour overflow persists after 5 "
                        "replans: h is pinned at a clamp (coincident "
                        "particles in the ICs?)")
                self._n_grid_overflows += 1
                self._plan_grid(self.state.r, self.state.h)
                self.state = self._bootstrap_fn(self.state.replace(
                    neib_overflow=torch.zeros_like(self.state.neib_overflow)))
        self.t = float(self.state.t)
        self.setup_complete = True

    # -- the physics -----------------------------------------------------------
    def _hydro_pass(self, s: SphState) -> SphState:
        """density -> EOS -> hydro forces at the current positions."""
        return hydro_pass_grid27(self.kern, self.visc, self.box,
                                 self.gridspec, self.eos, self.h_fac,
                                 self.h_converge, self.hydro_forces, s)

    def _build_bootstrap(self):
        """Initial force and timestep pass."""
        integ = self.integ

        def bootstrap(s: SphState) -> SphState:
            s = self._hydro_pass(s)
            s = s.replace(a0=s.a, dudt0=s.dudt, u0=s.u, r0=s.r, v0=s.v)
            return s.replace(dt=torch.min(sph_timestep(integ, s,
                                                       self.hydro_forces)))

        return bootstrap

    def _build_step(self):
        """One global-timestep KDK step: predict, wrap, hydro pass,
        correct, next dt.  The overflow flag is sticky across the steps
        of a burst (a mid-burst overflow must survive to its end)."""
        integ, box = self.integ, self.box

        def step(s: SphState) -> SphState:
            dt = s.dt
            t = s.t + dt
            overflow_in = s.neib_overflow
            s = predict(integ, s, dt)
            s = s.replace(r=box.wrap(s.r), r0=box.wrap(s.r0))
            s = self._hydro_pass(s)
            s = s.replace(neib_overflow=s.neib_overflow | overflow_in)
            s = correct(integ, s, dt, torch.zeros_like(s.alpha))
            dt_next = torch.min(sph_timestep(integ, s, self.hydro_forces))
            return s.replace(t=t, dt=dt_next, nstep=s.nstep + 1)

        return step

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
        """One step; on neighbour overflow, replan the grid from the
        pre-step state and redo the step (at most 4 times)."""
        self._clamp_dt_to_tend()
        with self.timing.block("MAIN_LOOP"):
            prev = self.state
            self.state = self._step_fn(prev)
            if bool(self.state.neib_overflow):
                # plan from the pre-step state: the overflowed state's h
                # came from truncated sums
                with self.timing.block("GRID_REPLAN"):
                    for attempt in range(4):
                        self._n_grid_overflows += 1
                        self._plan_grid(prev.r, prev.h,
                                        growth=1.3 * (1.2 ** attempt))
                        self.state = self._step_fn(prev)
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
        by step, so main_loop_step replans at the offending step.  Near
        tend the per-step path takes over.  Returns the steps done."""
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

    def Run(self, Nadvance: int = -1):
        """Advance until tend or Nstepsmax (or Nadvance more steps); no
        snapshot output."""
        if not self.setup_complete:
            self.SetupSimulation()
        tend = self.params.floatparams["tend"]
        nmax = (self.params.intparams["Nstepsmax"] if Nadvance < 0
                else self.Nsteps + Nadvance)
        while self.t < tend and self.Nsteps < nmax:
            self.main_loop_steps(nmax - self.Nsteps)
