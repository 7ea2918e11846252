"""Meshless finite-volume (MUSCL) simulation controller.

Counterpart of ``gandalf_tpu/sim/mfv_sim.py:MfvMusclSimulation`` for
the global-timestep path on the structured grid: the M4 kernel, the
adiabatic EOS, HLLC with or without zero mass flux, the Gizmo slope
limiter, and optionally self-gravity from the KD-bucket Barnes-Hut tree
with the MFV zeta scaling (and, in a periodic box, the Ewald sum).  One
step is

  1. Godunov fluxes from the previous step's gradients and positions
     (K1 at the old r, K12),
  2. the conserved update and the drift with the mean velocity; with
     self-gravity, the tree at the drifted r and new m (K4-K7, the
     previous h, zeta and hfactor) and the gravity source terms,
  3. the number-density h iteration at the new r (K1, K10) and the EOS,
  4. gradients and the cell limiter for the next step (K11),
  5. the next dt from vsig_max (and |a|).

The JAX package bins three times a step; a binning is a function of r
and the grid plan only, so the port bins once at the old r and once at
the new r.  The host loop (bursts, overflow replans, tree cadence, the
clamp to tend) is ``SimulationBase``'s.  Block timesteps, RK2, the exact
Riemann solver, the other limiters, static particles, radws and mirror
walls raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import mfv as mfv_ops
from ..ops import mfv_grid27 as mg
from ..ops import sph_grid27 as g27
from ..ops.active_grid import dense_ids
from ..ops.tree import tree_gravity_grouped
from ..state import MfvState, make_mfv_state
from .ic import generate_ic
from .simulation import SimulationBase, _host, _unsupported

# limiter aliases of the reference factory (MeshlessFVSimulation.cpp:87-110)
_LIMITER_ALIAS = {"tess2011": "tvdscalar", "balsara2004": "scalar"}


class MfvMusclSimulation(SimulationBase):
    """MUSCL meshless finite volume on one device with a global
    timestep."""

    # -- parameters ------------------------------------------------------------
    def process_parameters(self):
        p = self.params
        ip, sp = p.intparams, p.stringparams
        if sp["sim"] not in ("meshlessfv", "mfvmuscl"):
            raise _unsupported(f"sim {sp['sim']!r}", "item 10")
        if sp["energy_integration"] == "radws":
            raise _unsupported("radws energy integration", "item 9")
        if ip["Nlevels"] > 1:
            raise _unsupported("block timesteps for MFV (Nlevels > 1)",
                               "item 10")
        self._common_parameters()
        self.mfv_cfg = mfv_ops.MfvConfig(
            gamma=p.floatparams["gamma_eos"],
            zero_mass_flux=bool(ip["zero_mass_flux"]),
            static_particles=bool(ip["static_particles"]),
            riemann=sp["riemann_solver"],
            slope_limiter=_LIMITER_ALIAS.get(sp["slope_limiter"],
                                             sp["slope_limiter"]))
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
            self._plan_grid(ic["r"], ic["h"])
            if self.self_gravity:
                self._plan_tree_buckets(_host(self.state.r))
            self._bootstrap_with_replans()
        self.t = float(self.state.t)
        self.setup_complete = True

    def _run_bootstrap(self):
        self.state = self._bootstrap(self.state)

    # -- the passes ------------------------------------------------------------
    def _bin(self, r):
        """K1 at r: the slot map (*ncells, K) and the binning's overflow
        flag."""
        b = g27.bin_particles(self.gridspec, r)
        return dense_ids(self.gridspec, b), b.overflow

    def _density_pass(self, s: MfvState, ids_d, bin_ovf) -> MfvState:
        """K10 and its finish, then the EOS."""
        hmax = g27.hmax_of(self.gridspec, self.kern.kernrange)
        sums = mg.density_sums(self.kern, self.gridspec, self.h_fac,
                               self.h_converge, hmax, ids_d, s.r, s.m, s.h)
        d = mg.density_finish(self.h_fac, hmax, s.m, *sums)
        u, pressure, sound = self.eos.thermal_update(
            torch.clamp_min(d.rho, 1e-30), s.u)
        return s.replace(h=d.h, ndens=d.ndens, rho=d.rho,
                         invomega=d.invomega, zeta=d.zeta,
                         hfactor=d.hfactor, u=u, pressure=pressure,
                         sound=sound,
                         neib_overflow=s.neib_overflow | d.overflow
                         | bin_ovf)

    def _gradient_pass(self, s: MfvState, ids_d) -> MfvState:
        """K11: B, the gradients, the cell alphas, vsig_max and the
        bad-gradient flag for the next step's fluxes."""
        packed = torch.cat([s.h[:, None], s.ndens[:, None], s.Wprim,
                            s.sound[:, None]], -1).contiguous()
        res = mg.gradients(self.kern, self.gridspec, ids_d, s.r, packed)
        return s.replace(B=res.B, grad=res.grad, alpha_slope=res.alpha_slope,
                         vsig_max=res.vsig_max,
                         bad_grad=res.bad.to(s.h.dtype))

    def _flux_pass(self, s: MfvState, dt, ids_d) -> mfv_ops.FluxResult:
        """K12 from the state's positions, gradients and a0."""
        packed = mg.pack_flux_fields(s.h, s.ndens, s.Wprim, s.sound, s.a0,
                                     s.B, s.grad, s.alpha_slope, s.bad_grad)
        return mg.fluxes(self.kern, self.mfv_cfg, self.gridspec, dt, ids_d,
                         s.r, packed)

    def _gravity_pass(self, s: MfvState):
        """K4-K7 with the MFV zeta scaling (MfvCommon.cpp:413-416) and
        the Ewald table where the box has one: (a, gpot, overflow).  As
        in the JAX package the accuracy MACs get no per-group factors
        here (gadget2 |a| = 1e30, eigenmac 0)."""
        return tree_gravity_grouped(
            self.treespec, s.bucket_map, s.r, s.m, s.h, self.kern,
            zh=s.zeta * s.hfactor, periodic_extent=self._periodic_extent(),
            zeta_scaling="mfv", ewald_table=self.ewald_table)

    def _dt_criterion(self, s: MfvState):
        """Courant and acceleration timestep, the minimum over particles
        (MfvIntegration::Timestep)."""
        dt = 2.0 * self.courant_mult * s.h \
            / torch.clamp_min(s.vsig_max, 1e-30)
        if self.self_gravity:
            amag = torch.sqrt(torch.sum(s.a * s.a, dim=-1))
            dt = torch.minimum(dt, self.accel_mult
                               * torch.sqrt(s.h / (amag + 1e-30)))
        return torch.min(dt)

    # -- bootstrap and step ----------------------------------------------------
    def _bootstrap(self, s: MfvState) -> MfvState:
        """Density, conserved variables, gravity (a0 = a; gpot is not
        kept, as in the JAX package), gradients and the first dt."""
        ids_d, ovf = self._bin(s.r)
        s = self._density_pass(s, ids_d, ovf)
        Q0 = mfv_ops.qcons_from_state(3, s.m, s.v, s.u)
        s = s.replace(Qcons0=Q0, r0=s.r, v0=s.v)
        if self.self_gravity:
            a, _, ovg = self._gravity_pass(s)
            s = s.replace(a=a, a0=a, neib_overflow=s.neib_overflow | ovg)
        s = self._gradient_pass(s, ids_d)
        return s.replace(dt=self._dt_criterion(s))

    def _step(self, s: MfvState) -> MfvState:
        """One global MUSCL step (gandalf_tpu/sim/mfv_sim.py:449-491).
        The overflow flag is sticky across the steps of a burst.  With a
        finite tend the step's dt is clamped on the device to tend - t."""
        tend = self.params.floatparams["tend"]
        bounded = math.isfinite(tend)
        dt = s.dt
        if bounded:
            dt = torch.minimum(dt, tend - s.t)
        t = torch.clamp_max(s.t + dt, tend) if bounded else s.t + dt
        ids_old, ovf_old = self._bin(s.r)
        flux = self._flux_pass(s, dt, ids_old)
        Qcons = s.Qcons0 + flux.dQdt * dt
        overflow = s.neib_overflow | ovf_old
        if self.self_gravity:
            # drift, gravity at the drifted r and new m with the old h,
            # zeta and hfactor, then the source terms (MfvIntegration.cpp:
            # 150-170)
            m_new = Qcons[:, 3].contiguous()
            v_mid = Qcons[:, :3] / torch.clamp_min(m_new, 1e-30)[:, None]
            r = self.box.wrap(s.r0 + 0.5 * (s.v0 + v_mid) * dt)
            a, gpot, ovg = self._gravity_pass(s.replace(r=r, m=m_new))
            Qcons = mfv_ops.gravity_source_terms(
                3, dt, s.Qcons0, Qcons, s.a0, a, flux.rdmdt_dot * dt)
            m, _, v, u = mfv_ops.state_from_qcons(3, Qcons, s.ndens)
            s = s.replace(m=m.contiguous(), v=v, u=u, r=r, Qcons0=Qcons,
                          r0=r, v0=v, a=a,
                          a0=a, gpot=gpot, neib_overflow=overflow | ovg)
        else:
            m, _, v, u = mfv_ops.state_from_qcons(3, Qcons, s.ndens)
            r = self.box.wrap(s.r0 + 0.5 * (s.v0 + v) * dt)
            # the momentum as the JAX package rebuilds it after its
            # (here empty) wall reflection
            mom = v * torch.clamp_min(Qcons[:, 3], 1e-30)[:, None]
            Qcons = torch.cat([mom, Qcons[:, 3:]], -1)
            s = s.replace(m=m.contiguous(), v=v, u=u, r=r, Qcons0=Qcons,
                          r0=r, v0=v, neib_overflow=overflow)
        ids_new, ovf_new = self._bin(s.r)
        s = self._density_pass(s, ids_new, ovf_new)
        s = self._gradient_pass(s, ids_new)
        return s.replace(t=t, dt=self._dt_criterion(s), nstep=s.nstep + 1)
