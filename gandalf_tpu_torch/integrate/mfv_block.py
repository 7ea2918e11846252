"""Hierarchical (block) timesteps of the meshless finite-volume scheme.

Counterpart of ``gandalf_tpu/integrate/mfv_block.py`` (``init_schedule_mfv``,
``_grav_predict``, ``advance_mfv``, ``check_timesteps_mfv``,
``end_timestep_mfv``, ``gravity_source_terms_pp``, ``vsig_distant_dense``)
on the shared ladder of ``integrate/block.py``.  Per particle:

- ``Qcons0``  the conserved vector at the start of its own step,
- ``dQ``      the pair-flux exchange accumulated over the step,
- ``dQdt``    the flux rate taken at the step's start, which predicts the
              conserved state of a particle in mid-step each tick,
- ``rdmdt``   the mass-flux moment of the gravitational correction.

A pair's flux is committed with dt_pair = min(dt_i, dt_j) whenever the
deeper member of the pair starts a step; the power-of-two ladder tiles a
shallower particle's step with its deeper neighbour's sub-steps, so the
exchange is conservative to rounding.  Every update is a masked update
over all particles, as in the JAX package.  ``vsig_distant_dense`` is
the all-pairs oracle of the conservative limiter's bound: the tests and
the card check hold ``sim/mfv_sim.py``'s grid bound against it; the
controller never calls it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.mfv import state_from_qcons
from ..state import MfvState
from .block import (BlockConfig, BlockSchedule, _i32, _pow2,
                    compute_timestep_level, ladder_update)

Tensor = torch.Tensor


def init_schedule_mfv(cfg: BlockConfig, s: MfvState, dt_part: Tensor
                      ) -> Tuple[MfvState, BlockSchedule]:
    """The initial ladder (the resync branch at n = 0) and the flux
    accumulators set to zero."""
    alive = s.alive
    dtp = torch.where(alive, dt_part, torch.full_like(dt_part, 1e30))
    dt_min = torch.min(dtp)
    level_max = _i32(cfg.nlevels - 1, dt_part)
    dt_max = dt_min * _pow2(level_max).to(dt_min.dtype)
    level = torch.minimum(compute_timestep_level(dtp, dt_max), level_max)
    level = torch.where(alive, level, level_max)
    nstep = _pow2(level_max - level)
    nresync = _pow2(level_max)
    dt_base = dt_max / nresync.to(dt_max.dtype)
    sched = BlockSchedule(n=_i32(0, dt_part), level_max=level_max,
                          nresync=nresync, dt_base=dt_base, dt_max=dt_max,
                          nstep_part=nstep, dt_next=dtp)
    rdmdt0 = torch.zeros_like(s.r) if s.rdmdt0 is None else s.rdmdt0
    s = s.replace(level=level, levelneib=level.clone(),
                  nlast=torch.zeros_like(level),
                  tlast=s.t.expand(s.m.shape).to(s.m.dtype).clone(),
                  dQ=torch.zeros_like(s.Qcons0),
                  dQdt=torch.zeros_like(s.Qcons0),
                  rdmdt=torch.zeros_like(s.r), rdmdt0=rdmdt0)
    return s, sched


def _with_momentum_energy(Q: Tensor, dmom: Tensor, dE: Tensor,
                          ndim: int) -> Tensor:
    return torch.cat([Q[:, :ndim] + dmom, Q[:, ndim, None],
                      (Q[:, ndim + 1] + dE)[:, None]], -1)


def _grav_predict(ndim: int, Q0: Tensor, Q: Tensor, a0: Tensor,
                  dt_el: Tensor, dt_own: Tensor) -> Tensor:
    """The predicted gravitational source terms of a tick
    (MfvIntegration::AdvanceParticles): the elapsed time dt_el outside,
    the own step dt_own inside the quadratic terms, a0 at both ends."""
    irho = ndim
    dE = 0.5 * dt_el * (
        torch.sum(a0 * (Q0[:, :ndim]
                        + 0.5 * Q0[:, irho, None] * a0 * dt_own[:, None]), -1)
        + torch.sum(a0 * (Q[:, :ndim]
                          + 0.5 * Q[:, irho, None] * a0 * dt_own[:, None]),
                    -1))
    dmom = 0.5 * (Q0[:, irho, None] + Q[:, irho, None]) * a0 \
        * dt_el[:, None]
    return _with_momentum_energy(Q, dmom, dE, ndim)


def advance_mfv(s: MfvState, B: BlockSchedule
                ) -> Tuple[MfvState, Tensor, Tensor, Tensor]:
    """One tick of prediction and drift for every particle: returns
    (state, active, t, Q), Q the predicted conserved vector (committed
    only by end_timestep_mfv)."""
    n = B.n + 1
    t = s.t + B.dt_base
    dt_el = B.dt_base * (n - s.nlast).to(s.m.dtype)
    dt_own = B.dt_base * B.nstep_part.to(s.m.dtype)
    active = ((n - s.nlast) == B.nstep_part) & s.alive
    Q = torch.where(active[:, None], s.Qcons0 + s.dQ,
                    s.Qcons0 + s.dQdt * dt_el[:, None])
    Q = _grav_predict(s.ndim, s.Qcons0, Q, s.a0, dt_el, dt_own)
    m, _, v, u = state_from_qcons(s.ndim, Q, s.ndens)
    r = s.r0 + 0.5 * (s.v0 + v) * dt_el[:, None]
    return s.replace(r=r, v=v, m=m.contiguous(), u=u), active, t, Q


def check_timesteps_mfv(cfg: BlockConfig, s: MfvState, B: BlockSchedule,
                        active: Tensor
                        ) -> Tuple[Tensor, Tensor, Tensor, MfvState]:
    """The Saitoh-Makino limiter (MfvIntegration::CheckTimesteps,
    time_step_limiter = simple): an inactive particle whose neighbours
    sit more than level_diff_max levels deeper ends its step where the
    shorter step stays level-synchronised, committing its predicted
    exchange dQ = dQdt times the time elapsed.  Returns (active',
    nstep_part', level', state')."""
    n = B.n + 1
    dn = n - s.nlast
    level_new = s.levelneib - cfg.level_diff_max
    nnewstep = _pow2(B.level_max - torch.minimum(level_new, B.level_max))
    reduce_ = (~active) & s.alive \
        & ((s.levelneib - s.level) > cfg.level_diff_max) \
        & (torch.remainder(dn, nnewstep) == 0) & (dn > 0)
    dt_el = B.dt_base * dn.to(s.m.dtype)
    dQ = torch.where(reduce_[:, None], s.dQdt * dt_el[:, None], s.dQ)
    nstep = torch.where(reduce_, dn, B.nstep_part)
    level = torch.where(reduce_, level_new, s.level)
    return active | reduce_, nstep, level, s.replace(dQ=dQ)


def gravity_source_terms_pp(ndim: int, dt: Tensor, Q0: Tensor, Q: Tensor,
                            a0: Tensor, a: Tensor, rdmdt: Tensor) -> Tensor:
    """ops.mfv.gravity_source_terms with a per-particle dt (the commit of
    a block step, MfvIntegration.cpp:165-175)."""
    irho = ndim
    dtc = dt[:, None]
    dE = 0.5 * dt * (
        torch.sum(a0 * (Q0[:, :ndim] + 0.5 * Q0[:, irho, None] * a0 * dtc),
                  -1)
        + torch.sum(a * (Q[:, :ndim] + 0.5 * Q[:, irho, None] * a * dtc),
                    -1))
    dE = dE + 0.5 * torch.sum((a0 + a) * rdmdt, -1)
    dmom = 0.5 * dtc * (Q0[:, irho, None] * a0 + Q[:, irho, None] * a)
    return _with_momentum_energy(Q, dmom, dE, ndim)


def end_timestep_mfv(cfg: BlockConfig, eos, s: MfvState, B: BlockSchedule,
                     active: Tensor, level: Tensor, nstep_part: Tensor,
                     dt_crit: Tensor, t: Tensor, cooling_fn=None
                     ) -> Tuple[MfvState, BlockSchedule]:
    """Commit the particles ending their step (MfvIntegration::
    EndTimestep): Qcons = Qcons0 + dQ with the trapezoidal gravity and
    the rdmdt correction over the particle's own step, then
    `cooling_fn(Qcons, ndens, gpot, dt_own)` where given (the radiative
    term over the own step); reset dQ, dQdt and rdmdt; freeze r0, v0 and
    a0; then the ladder update."""
    nd = s.ndim
    n = B.n + 1
    dt_own = B.dt_base * (n - s.nlast).to(s.m.dtype)
    Q = s.Qcons0 + s.dQ
    Qg = gravity_source_terms_pp(nd, dt_own, s.Qcons0, Q, s.a0, s.a,
                                 s.rdmdt)
    if cooling_fn is not None:
        Qg = cooling_fn(Qg, s.ndens, s.gpot, dt_own)
    m, rho, v, u = state_from_qcons(nd, Qg, s.ndens)
    u2, pressure, sound = eos.thermal_update(torch.clamp_min(rho, 1e-30), u)
    am = active[:, None]

    def sel(x, y):
        return torch.where(am if y.dim() == 2 else active, x, y)

    zero = torch.zeros((), dtype=s.m.dtype, device=s.m.device)
    upd = dict(m=sel(m, s.m).contiguous(), v=sel(v, s.v), u=sel(u2, s.u),
               pressure=sel(pressure, s.pressure), sound=sel(sound, s.sound),
               Qcons0=sel(Qg, s.Qcons0), r0=sel(s.r, s.r0), v0=sel(v, s.v0),
               a0=sel(s.a, s.a0), rdmdt0=sel(s.rdmdt, s.rdmdt0),
               rdmdt=sel(zero, s.rdmdt), dQ=sel(zero, s.dQ),
               dQdt=sel(zero, s.dQdt))
    dt_next = torch.where(active, dt_crit, B.dt_next)
    lad, B = ladder_update(cfg, B, s.alive, active, level, s.levelneib,
                           nstep_part, s.nlast, s.tlast, dt_next, n, t)
    return s.replace(t=t, dt=B.dt_base, **lad, **upd), B


def vsig_distant_dense(box, r: Tensor, v: Tensor, h: Tensor, sound: Tensor,
                       alive: Tensor, rows: Tensor = None) -> Tensor:
    """The all-pairs distant signal-velocity bound (the oracle of the
    conservative limiter, Tree::ComputeSignalVelocityFromDistantInteractions
    leaf branch): vsig_i = max_j (c_i + c_j - dv.dr/|dr|) h_i / max(|dr|,
    h_i) over the alive j at d^2 > 0, min-imaged; 0 where there are
    none.  Of the particles `rows` (all when None); O(N) per row."""
    rows = torch.arange(r.shape[0], device=r.device) if rows is None \
        else rows.long()
    dr = box.min_image(r[None, :, :] - r[rows][:, None, :])
    drsqd = torch.sum(dr * dr, dim=-1)
    ok = (drsqd > 0) & alive[None, :]
    drmag = torch.sqrt(torch.where(ok, drsqd, 1.0))
    dv = v[None, :, :] - v[rows][:, None, :]
    dvdr = -torch.sum(dv * dr, dim=-1) / drmag
    vsig = sound[rows][:, None] + sound[None, :] - dvdr
    h_i = h[rows][:, None]
    contrib = torch.where(ok, vsig * (h_i / torch.maximum(drmag, h_i)), 0.0)
    return torch.amax(contrib, dim=1)
