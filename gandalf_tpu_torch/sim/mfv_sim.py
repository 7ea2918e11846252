"""Meshless finite-volume simulation controllers (MUSCL and RK2).

Counterpart of ``gandalf_tpu/sim/mfv_sim.py:MfvMusclSimulation`` and
``MfvRungeKuttaSimulation`` on the structured grid in 1, 2 or 3 dims,
with a global timestep or (MUSCL only) block timesteps: the M4 kernel,
any EOS of the port but the locally isothermal family, the HLLC or exact
Riemann solver with or without zero mass flux, every slope limiter
(gizmo, scalar, null,
zeroslope, tvdscalar, springel2009 and the aliases tess2011 and
balsara2004), moving or static particles, and in 3D optionally
self-gravity from the KD-bucket Barnes-Hut tree with the MFV zeta
scaling (and, in a periodic box, the Ewald sum).  One global step is

  1. Godunov fluxes from the previous step's gradients and positions
     (K1 at the old r, K12: the MUSCL half step, or under RK2 the mean
     of the fluxes before and after a full step),
  2. the conserved update and the drift with the mean velocity; with
     self-gravity, the tree at the drifted r and new m (K4-K7, the
     previous h, zeta and hfactor) and the gravity source terms,
  3. the number-density h iteration at the new r (K1, K10) and the EOS,
  4. gradients and the cell limiter for the next step (K11; with
     tvdscalar or springel2009 the per-neighbour sweep, K31),
  5. the next dt from vsig_max (and |a|).

The JAX package bins three times a step; a binning is a function of r
and the grid plan only, so the port bins once at the old r and once at
the new r.  The host loop (bursts, overflow replans, tree cadence, the
clamp to tend) is ``SimulationBase``'s.  With ``gas_eos = radws`` the
EOS reads gamma from the opacity table (K27), and with
``energy_integration = radws`` the implicit radiative heating rate (K29)
at the step's end, after the gravity source terms with the new gpot, is
folded into the total-energy column.

With ``Nlevels > 1`` one call of ``main_loop_step`` is one tick of the
hierarchical block scheme (gandalf_tpu/sim/mfv_sim.py:511-555, in its
order): K1 at the old r and K12's block mode for the pairs whose deeper
member starts a step (the starters' dQdt replaced), the prediction and
drift of every particle (integrate/mfv_block.py) with the EOS at the old
number density, the Saitoh-Makino limiter with the last tick's levelneib
(``time_step_limiter = simple``), then K1 at the new r once for the
density pass (K10), the tree (K4-K7), the neighbour levels (K22) and,
under ``conservative``, the distant signal velocity's near and far
passes (K32, K33), then the commit of the particles ending their step
(with radws, K29 over each one's own step), the ladder update and the
gradients (K11, K31).  On overflow the state and the schedule rewind
together and the tick is redone after a replan, at most 4 times.
Self-gravity runs in 1-3 dims.  Mirror walls, sinks, external
potentials, radiative feedback, the locally isothermal EOS, smoothing
kernels other than M4, the Ewald sum below 3D and RK2 with block
timesteps raise NotImplementedError naming their ROADMAP item or fault,
or the JAX package's own refusal.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .._ext import require_m4
from ..integrate.block import BlockConfig
from ..integrate.mfv_block import (advance_mfv, check_timesteps_mfv,
                                   end_timestep_mfv, init_schedule_mfv)
from ..ops import mfv as mfv_ops
from ..ops import mfv_grid27 as mg
from ..ops import sph_grid27 as g27
from ..ops.active_grid import dense_ids, levelneib_grid27
from ..ops.radws import radws_implicit_heating
from ..ops.tree import tree_gravity_grouped
from ..state import MfvState, make_mfv_state
from .ic import generate_ic
from .simulation import SimulationBase, _host, _unsupported

# limiter aliases of the reference factory (MeshlessFVSimulation.cpp:87-110)
_LIMITER_ALIAS = {"tess2011": "tvdscalar", "balsara2004": "scalar"}
# the time_step_limiter values of a block run (the JAX package runs any
# other name as none; the port refuses it)
_TIMESTEP_LIMITERS = ("none", "simple", "conservative")


class MfvMusclSimulation(SimulationBase):
    """MUSCL meshless finite volume on one device with a global timestep
    or block timesteps."""

    time_scheme = "muscl"

    # -- parameters ------------------------------------------------------------
    def process_parameters(self):
        p = self.params
        ip, sp = p.intparams, p.stringparams
        self.use_block = ip["Nlevels"] > 1
        if self.use_block and self.time_scheme == "rk2":
            # the JAX package refuses it too
            # (gandalf_tpu/sim/mfv_sim.py:89-92)
            raise NotImplementedError(
                "block timesteps are wired to the MUSCL MFV scheme "
                "(the reference's RK2 block coupling differs)")
        self.block_cfg = BlockConfig(nlevels=ip["Nlevels"],
                                     level_diff_max=ip["level_diff_max"])
        self.time_step_limiter = sp["time_step_limiter"]
        if self.use_block \
                and self.time_step_limiter not in _TIMESTEP_LIMITERS:
            raise ValueError(f"unrecognised time_step_limiter "
                             f"{self.time_step_limiter!r}: one of "
                             f"{_TIMESTEP_LIMITERS}")
        # the JAX MFV controller never reads these options: a run there
        # makes no sinks (fault F16) and feels no external potential
        # (fault F19); the port refuses both rather than ignore them
        if ip["sink_particles"] or ip["create_sinks"]:
            raise _unsupported("sink particles in MFV (the JAX package's "
                               "MFV controller ignores them: fault F16)",
                               "item 9")
        if sp["external_potential"] != "none":
            raise _unsupported("external potentials in MFV (the JAX "
                               "package's MFV controller ignores them: "
                               "fault F19)", "item 9")
        if ip["rad_fb"]:
            raise _unsupported("radiative feedback in MFV (the JAX "
                               "package's MFV controller ignores rad_fb: "
                               "fault F21)", "item 9")
        self._common_parameters()
        require_m4(self.kern, "MFV (K7's MFV mode, K10-K12, K31)")
        if self.box.mirror_walls():
            raise _unsupported("mirror/wall boundaries in MFV",
                               "items 8 and 10")
        self.mfv_cfg = mfv_ops.MfvConfig(
            gamma=p.floatparams["gamma_eos"],
            zero_mass_flux=bool(ip["zero_mass_flux"]),
            static_particles=bool(ip["static_particles"]),
            riemann=sp["riemann_solver"],
            slope_limiter=_LIMITER_ALIAS.get(sp["slope_limiter"],
                                             sp["slope_limiter"]),
            time_scheme=self.time_scheme)
        mfv_ops.check_config(self.mfv_cfg)
        self.courant_mult = p.floatparams["courant_mult"]
        self.accel_mult = p.floatparams["accel_mult"]

    # -- setup -----------------------------------------------------------------
    def SetupSimulation(self, ic: Optional[Dict[str, np.ndarray]] = None):
        """Initial conditions, grid (and tree) plan and bootstrap pass,
        replanned while it overflows.  `ic` (keys r, v, m, h, u)
        replaces the generated IC."""
        self._require_device()
        with self.timing.block("SETUP"):
            self.process_parameters()
            if ic is None:
                with self.timing.block("GENERATE_IC"):
                    ic = generate_ic(self.params, self.eos)
            self.state = make_mfv_state(ic["r"], ic["v"], ic["m"], ic["h"],
                                        ic["u"], device=self.device,
                                        dtype=self.dtype)
            self._step_fn = self._step
            self._blocksched = None
            self.steps_ended = torch.zeros((), dtype=torch.int64,
                                           device=self.device)
            self.last_tick_rows = []
            self._plan_grid(ic["r"], ic["h"])
            if self.self_gravity:
                self._plan_tree_buckets(_host(self.state.r))
            self._bootstrap_with_replans()
        self.t = float(self.state.t)
        self.setup_complete = True

    def _run_bootstrap(self):
        if self.use_block:
            self.state, self._blocksched = self._bootstrap_block(self.state)
        else:
            self.state = self._bootstrap(self.state)

    # -- the passes ------------------------------------------------------------
    def _bin(self, r):
        """K1 at r: the slot map (*ncells, K) and the binning."""
        b = g27.bin_particles(self.gridspec, r)
        return dense_ids(self.gridspec, b), b

    def _density_pass(self, s: MfvState, ids_d, bin_ovf) -> MfvState:
        """K10 and its finish, then the EOS."""
        hmax = g27.hmax_of(self.gridspec, self.kern.kernrange)
        sums = mg.density_sums(self.kern, self.gridspec, self.h_fac,
                               self.h_converge, hmax, ids_d, s.r, s.m, s.h)
        d = mg.density_finish(self.h_fac, hmax, s.m, *sums, ndim=self.ndim)
        u, pressure, sound = self.eos.thermal_update(
            torch.clamp_min(d.rho, 1e-30), s.u)
        return s.replace(h=d.h, ndens=d.ndens, rho=d.rho,
                         invomega=d.invomega, zeta=d.zeta,
                         hfactor=d.hfactor, u=u, pressure=pressure,
                         sound=sound,
                         neib_overflow=s.neib_overflow | d.overflow
                         | bin_ovf)

    def _gradient_pass(self, s: MfvState, ids_d) -> MfvState:
        """K11 (and K31): B, the gradients, the cell alphas, vsig_max and
        the bad-gradient flag for the next step's fluxes."""
        packed = torch.cat([s.h[:, None], s.ndens[:, None], s.Wprim,
                            s.sound[:, None]], -1).contiguous()
        res = mg.gradients(self.kern, self.gridspec, ids_d, s.r, packed,
                           self.mfv_cfg.slope_limiter)
        return s.replace(B=res.B, grad=res.grad, alpha_slope=res.alpha_slope,
                         vsig_max=res.vsig_max,
                         bad_grad=res.bad.to(s.h.dtype))

    def _flux_pass(self, s: MfvState, dt, ids_d, block=None
                   ) -> mfv_ops.FluxResult:
        """K12 from the state's positions, gradients and a0; `block`
        (start (N,) bool, dt_own (N,)) runs its block mode."""
        start, dt_own = block if block is not None else (None, None)
        packed = mg.pack_flux_fields(s.h, s.ndens, s.Wprim, s.sound, s.a0,
                                     s.B, s.grad, s.alpha_slope, s.bad_grad,
                                     dt_own=dt_own, start=start)
        return mg.fluxes(self.kern, self.mfv_cfg, self.gridspec, dt, ids_d,
                         s.r, packed, block=block is not None)

    def _gravity_pass(self, s: MfvState):
        """K4-K7 with the MFV zeta scaling (MfvCommon.cpp:413-416) and
        the Ewald table where the box has one: (a, gpot, overflow).  As
        in the JAX package the accuracy MACs get no per-group factors
        here (gadget2 |a| = 1e30, eigenmac 0)."""
        return tree_gravity_grouped(
            self.treespec, s.bucket_map, s.r, s.m, s.h, self.kern,
            zh=s.zeta * s.hfactor, periodic_extent=self._periodic_extent(),
            zeta_scaling="mfv", ewald_table=self.ewald_table)

    def _apply_radws_cooling(self, Qcons, ndens, gpot, dt):
        """The implicit radiative heating rate (K29, col2 from max(gpot,
        0)) at the state of Qcons, clipped at -0.95 u / dt, times m dt
        added to the total-energy column (gandalf_tpu/sim/mfv_sim.py:
        426-441; EnergyRadws<MeshlessFVParticle>::EndTimestep)."""
        nd = self.ndim
        m, rho, _, u = mfv_ops.state_from_qcons(nd, Qcons, ndens)
        heat = radws_implicit_heating(self.eos.table, rho, u,
                                      torch.zeros_like(u), gpot, dt)
        heat = torch.maximum(heat, -0.95 * u / torch.clamp_min(dt, 1e-30))
        energy = Qcons[:, nd + 1] + m * heat * dt
        return torch.cat([Qcons[:, :nd + 1], energy[:, None]], -1)

    def _dt_criterion_part(self, s: MfvState, vsig):
        """Each particle's Courant and acceleration timestep from the
        signal velocity `vsig` (MfvIntegration::Timestep)."""
        dt = 2.0 * self.courant_mult * s.h / torch.clamp_min(vsig, 1e-30)
        if self.self_gravity:
            amag = torch.sqrt(torch.sum(s.a * s.a, dim=-1))
            dt = torch.minimum(dt, self.accel_mult
                               * torch.sqrt(s.h / (amag + 1e-30)))
        return dt

    def _dt_criterion(self, s: MfvState):
        """The global timestep: the minimum over particles."""
        return torch.min(self._dt_criterion_part(s, s.vsig_max))

    def _vsig(self, s: MfvState, ids_d, b):
        """The signal velocity of the timestep: vsig_max, and under the
        conservative limiter at least the distant bound (K32, K33) on
        the slot map `ids_d` of binning `b`."""
        if self.time_step_limiter != "conservative":
            return s.vsig_max
        return torch.maximum(s.vsig_max, mg.vsig_conservative(
            self.gridspec, ids_d, b.cell_of, s.r, s.v, s.sound, s.h))

    # -- bootstrap and step ----------------------------------------------------
    def _bootstrap(self, s: MfvState) -> MfvState:
        """Density, conserved variables, gravity (a0 = a; gpot is not
        kept, as in the JAX package), gradients and the first dt."""
        ids_d, b = self._bin(s.r)
        s = self._density_pass(s, ids_d, b.overflow)
        Q0 = mfv_ops.qcons_from_state(self.ndim, s.m, s.v, s.u)
        s = s.replace(Qcons0=Q0, r0=s.r, v0=s.v)
        if self.self_gravity:
            a, _, ovg = self._gravity_pass(s)
            s = s.replace(a=a, a0=a, neib_overflow=s.neib_overflow | ovg)
        s = self._gradient_pass(s, ids_d)
        return s.replace(dt=self._dt_criterion(s))

    def _bootstrap_block(self, s: MfvState):
        """The global bootstrap, then the first ladder from each
        particle's timestep (with the conservative limiter's bound):
        (state, schedule) with dt = dt_base (gandalf_tpu/sim/mfv_sim.py:
        415-422)."""
        s = self._bootstrap(s)
        ids_d, b = self._bin(s.r)
        dt_part = self._dt_criterion_part(s, self._vsig(s, ids_d, b))
        s, sched = init_schedule_mfv(self.block_cfg, s, dt_part)
        return s.replace(dt=sched.dt_base), sched

    def _step(self, s: MfvState) -> MfvState:
        """One global step (gandalf_tpu/sim/mfv_sim.py:449-491).
        The overflow flag is sticky across the steps of a burst.  With a
        finite tend the step's dt is clamped on the device to tend - t."""
        tend = self.params.floatparams["tend"]
        bounded = math.isfinite(tend)
        dt = s.dt
        if bounded:
            dt = torch.minimum(dt, tend - s.t)
        t = torch.clamp_max(s.t + dt, tend) if bounded else s.t + dt
        ids_old, b_old = self._bin(s.r)
        flux = self._flux_pass(s, dt, ids_old)
        Qcons = s.Qcons0 + flux.dQdt * dt
        overflow = s.neib_overflow | b_old.overflow
        nd = self.ndim
        if self.self_gravity:
            # drift, gravity at the drifted r and new m with the old h,
            # zeta and hfactor, then the source terms (MfvIntegration.cpp:
            # 150-170)
            m_new = Qcons[:, nd].contiguous()
            v_mid = Qcons[:, :nd] / torch.clamp_min(m_new, 1e-30)[:, None]
            r = self.box.wrap(s.r0 + 0.5 * (s.v0 + v_mid) * dt)
            a, gpot, ovg = self._gravity_pass(s.replace(r=r, m=m_new))
            Qcons = mfv_ops.gravity_source_terms(
                nd, dt, s.Qcons0, Qcons, s.a0, a, flux.rdmdt_dot * dt)
            if self.use_radws_energy:
                Qcons = self._apply_radws_cooling(Qcons, s.ndens, gpot, dt)
            m, _, v, u = mfv_ops.state_from_qcons(nd, Qcons, s.ndens)
            s = s.replace(m=m.contiguous(), v=v, u=u, r=r, Qcons0=Qcons,
                          r0=r, v0=v, a=a,
                          a0=a, gpot=gpot, neib_overflow=overflow | ovg)
        else:
            if self.use_radws_energy:
                Qcons = self._apply_radws_cooling(Qcons, s.ndens, s.gpot, dt)
            m, _, v, u = mfv_ops.state_from_qcons(nd, Qcons, s.ndens)
            r = self.box.wrap(s.r0 + 0.5 * (s.v0 + v) * dt)
            # the momentum as the JAX package rebuilds it after its
            # (here empty) wall reflection
            mom = v * torch.clamp_min(Qcons[:, nd], 1e-30)[:, None]
            Qcons = torch.cat([mom, Qcons[:, nd:]], -1)
            s = s.replace(m=m.contiguous(), v=v, u=u, r=r, Qcons0=Qcons,
                          r0=r, v0=v, neib_overflow=overflow)
        ids_new, b_new = self._bin(s.r)
        s = self._density_pass(s, ids_new, b_new.overflow)
        s = self._gradient_pass(s, ids_new)
        return s.replace(t=t, dt=self._dt_criterion(s), nstep=s.nstep + 1)

    # -- block timesteps ------------------------------------------------------
    def _block_tick(self, s: MfvState, B):
        """One tick from state s and schedule B, statement by statement
        the JAX package's (gandalf_tpu/sim/mfv_sim.py:511-555): returns
        (state, schedule, the number of particles that ended a step, a 0-d
        tensor).  The overflow flag is read by the caller."""
        cfg, spec = self.block_cfg, self.gridspec
        # fluxes of the pairs whose deeper member starts a step
        start = (B.n == s.nlast) & s.alive
        dt_own = B.dt_base * B.nstep_part.to(s.m.dtype)
        ids_old, b_old = self._bin(s.r)
        flux = self._flux_pass(s, B.dt_base, ids_old, block=(start, dt_own))
        s = s.replace(dQ=s.dQ + flux.dQ, rdmdt=s.rdmdt + flux.rdmdt,
                      dQdt=torch.where(start[:, None], flux.dQdt, s.dQdt),
                      neib_overflow=s.neib_overflow | b_old.overflow)
        # predict and drift every particle; the EOS at the old ndens
        s, active, t, _ = advance_mfv(s, B)
        rho = s.m * s.ndens
        u, pressure, sound = self.eos.thermal_update(
            torch.clamp_min(rho, 1e-30), s.u)
        s = s.replace(r=self.box.wrap(s.r), rho=rho, u=u, pressure=pressure,
                      sound=sound)
        if self.time_step_limiter == "simple":
            active, nstep_p, level, s = check_timesteps_mfv(cfg, s, B, active)
        else:
            nstep_p, level = B.nstep_part, s.level
        # one binning at the new r for the density, the levels, the
        # distant bound and the gradients
        ids_new, b_new = self._bin(s.r)
        s = self._density_pass(s, ids_new, b_new.overflow)
        if self.self_gravity:
            a, gpot, ovg = self._gravity_pass(s)
            s = s.replace(a=a, gpot=gpot,
                          neib_overflow=s.neib_overflow | ovg)
        s = s.replace(levelneib=levelneib_grid27(
            self.kern, spec, s.r, s.h, s.level, s.alive, b=b_new))
        dt_crit = self._dt_criterion_part(s, self._vsig(s, ids_new, b_new))
        s, B = end_timestep_mfv(
            cfg, self.eos, s, B, active, level, nstep_p, dt_crit, t,
            cooling_fn=(self._apply_radws_cooling if self.use_radws_energy
                        else None))
        s = self._gradient_pass(s, ids_new)
        return s.replace(nstep=s.nstep + 1), B, active.sum()

    def main_loop_step(self):
        """One global step, or one block tick (not clamped to tend, as in
        the JAX package).  A tick that overflows is redone from the
        pre-tick state and schedule after a replan of the grid (and of
        the tree buckets with grown caps) from the pre-tick state, at
        most 4 times.  A tick passes every particle through the dense
        passes (``last_tick_rows``); ``steps_ended`` (a 0-d device
        tensor) counts the particles that ended a step."""
        if not self.use_block:
            super().main_loop_step()
            return
        self._tree_cadence()
        with self.timing.block("MAIN_LOOP"):
            prev, prev_sched = self.state, self._blocksched
            s, B, ended = self._block_tick(prev, prev_sched)
            for attempt in range(4):
                if not bool(s.neib_overflow):
                    break
                with self.timing.block("GRID_REPLAN"):
                    self._n_grid_overflows += 1
                    self._plan_grid(prev.r, prev.h,
                                    growth=1.3 * (1.2 ** attempt))
                    if self.treespec is not None:
                        # replaces self.state's (the pre-tick state's) map
                        self._plan_tree_buckets(_host(prev.r),
                                                grow_caps=True)
                        prev = self.state
                s, B, ended = self._block_tick(prev, prev_sched)
            if bool(s.neib_overflow):
                raise RuntimeError(
                    "neighbour overflow persists after 4 replans")
            self.state, self._blocksched = s, B
            self.steps_ended = self.steps_ended + ended
            self.last_tick_rows = [s.N]
        self.Nsteps += 1
        self.t = float(self.state.t)


class MfvRungeKuttaSimulation(MfvMusclSimulation):
    """Heun (RK2) meshless finite volume (MfvRungeKuttaSimulation): the
    flux pass averages the Riemann fluxes of the face states as they
    are and of the states advanced a full dt by the primitive time
    derivative; the rest of the step is MUSCL's."""

    time_scheme = "rk2"
