"""Hierarchical (block) timesteps: power-of-two per-particle levels.

Counterpart of ``gandalf_tpu/integrate/block.py`` (``BlockSchedule``,
``BlockConfig``, ``compute_timestep_level``, ``init_schedule``,
``advance``, ``check_timesteps``, ``end_timestep``, ``ladder_update``)
for the SPH leapfrog KDK with ``u_mode`` "energy", "radws" or "none".
Every
branch is a masked update over all particles, as in the JAX package:

- integer tick counter ``n``, base tick ``dt_base = dt_max / nresync``;
- per-particle level, nstep = 2^(level_max - level), nlast, tlast;
- every particle drifts every tick from the start of its own step; only
  those with n - nlast == nstep are active and get the closing kick and
  a new level;
- the Saitoh & Makino (2009) limiter ends the step of an inactive
  particle whose neighbours sit more than ``level_diff_max`` levels
  above it;
- the ladder is rebuilt at n == nresync, and level_max grows or shrinks
  between resyncs with n, nlast and nstep rescaled by powers of two.

``dt_extra`` is the scalar timestep bound of the sinks and stars, which
always step at ``dt_base``: it deepens the ladder at a resync and can
grow ``level_max`` by at most one level a tick between resyncs.  The
JAX functions' ``axis_name`` (sharded ladder reductions) is not ported
(ROADMAP queue 1, item 13).
Integer fields are int32 tensors; the schedule's scalars are 0-d
tensors on the state's device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.radws import radws_energy_integration
from ..state import SphState

Tensor = torch.Tensor

LEVEL_CAP = 20          # ladder depth guard (nresync <= 2^20 ticks)
_I32 = torch.int32


class BlockSchedule(NamedTuple):
    """Block-timestep bookkeeping carried across ticks."""

    n: Tensor           # () int32 integer time inside the resync interval
    level_max: Tensor   # () int32 deepest occupied level
    nresync: Tensor     # () int32 2^level_max
    dt_base: Tensor     # () float one tick of simulation time
    dt_max: Tensor      # () float level-0 step (fixed between resyncs)
    nstep_part: Tensor  # (N,) int32 per-particle integer step
    dt_next: Tensor     # (N,) float most recent timestep criterion


class BlockConfig(NamedTuple):
    nlevels: int
    level_diff_max: int


def compute_timestep_level(dt: Tensor, dt_max: Tensor) -> Tensor:
    """Truncation toward zero of log2(dt_max / dt), plus one, clipped to
    [0, LEVEL_CAP]; log2 is taken as log(x) * 1/ln 2, exactly as the JAX
    package writes it, so levels at power-of-two ratios agree."""
    ratio = dt_max / torch.clamp_min(dt, 1e-30)
    lvl = (torch.log(torch.clamp_min(ratio, 1e-30))
           * 1.4426950408889634).to(_I32) + 1
    return torch.clamp(lvl, 0, LEVEL_CAP)


def _pow2(e: Tensor) -> Tensor:
    return torch.bitwise_left_shift(torch.ones_like(e, dtype=_I32),
                                    torch.clamp(e, 0, 30).to(_I32))


def _i32(x: int, like: Tensor) -> Tensor:
    return torch.tensor(x, dtype=_I32, device=like.device)


def init_schedule(cfg: BlockConfig, s: SphState, dt_part: Tensor,
                  dt_extra: Tensor = None
                  ) -> Tuple[SphState, BlockSchedule]:
    """The initial ladder (the resync branch at n = 0); `dt_extra` (a
    0-d tensor: the sinks' and stars' bound) caps its dt_min."""
    alive = s.alive
    dtp = torch.where(alive, dt_part, torch.full_like(dt_part, 1e30))
    dt_min = torch.min(dtp)
    if dt_extra is not None:
        dt_min = torch.minimum(dt_min, dt_extra)
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
    s = s.replace(level=level, levelneib=level.clone(),
                  nlast=torch.zeros_like(level),
                  tlast=s.t.expand(s.m.shape).to(s.m.dtype).clone())
    return s, sched


def advance(s: SphState, B: BlockSchedule, u_mode: str
            ) -> Tuple[SphState, Tensor, Tensor]:
    """One tick of drift for every particle.  Returns (state, active
    mask, new t); `u_mode` is "energy" (u integrated forward from du/dt),
    "radws" (u relaxed from u0 toward ueq over the particle's own time
    since its step began, EnergyRadws::EnergyIntegration) or "none"."""
    if u_mode not in ("energy", "radws", "none"):
        raise ValueError(f"unknown u_mode {u_mode!r}")
    n = B.n + 1
    t = s.t + B.dt_base
    dtp = (t - s.tlast)[:, None]
    out = {"r": s.r0 + s.v0 * dtp + 0.5 * s.a0 * dtp * dtp,
           "v": s.v0 + s.a0 * dtp}
    if u_mode == "energy":
        out["u"] = s.u0 + s.dudt0 * dtp[:, 0]
    elif u_mode == "radws":
        out["u"] = radws_energy_integration(s.u0, s.ueq, s.dt_therm,
                                            dtp[:, 0])
    active = ((n - s.nlast) == B.nstep_part) & s.alive
    return s.replace(**out), active, t


def check_timesteps(cfg: BlockConfig, s: SphState, B: BlockSchedule,
                    active: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Saitoh & Makino limiter: end the step of inactive particles whose
    neighbours are more than level_diff_max levels above them, where the
    shortened step stays level-synchronised.  Returns (active',
    nstep_part', level')."""
    n = B.n + 1
    dn = n - s.nlast
    level_new = s.levelneib - cfg.level_diff_max
    nnewstep = _pow2(B.level_max - torch.minimum(level_new, B.level_max))
    reduce_ = (~active) & s.alive \
        & ((s.levelneib - s.level) > cfg.level_diff_max) \
        & (torch.remainder(dn, nnewstep) == 0)
    nstep = torch.where(reduce_ & (dn > 0), dn, B.nstep_part)
    level = torch.where(reduce_, level_new, s.level)
    return active | reduce_, nstep, level


def end_timestep(cfg: BlockConfig, s: SphState, B: BlockSchedule,
                 active: Tensor, level: Tensor, nstep_part: Tensor,
                 dt_crit: Tensor, t: Tensor, u_mode: str,
                 dt_extra: Tensor = None) -> Tuple[SphState, BlockSchedule]:
    """Closing kick and level and ladder update for the particles ending
    their step.  `level` and `nstep_part` carry the Saitoh-Makino
    reductions; `dt_crit` is the fresh timestep criterion (read where
    active); `dt_extra` the sinks' and stars' bound (see ladder_update)."""
    n = B.n + 1
    dt_p = torch.where(active, t - s.tlast, torch.zeros_like(s.tlast))
    act3 = active[:, None]
    v = torch.where(act3, s.v + 0.5 * dt_p[:, None] * (s.a - s.a0), s.v)
    upd = {"v": v, "r0": torch.where(act3, s.r, s.r0),
           "v0": torch.where(act3, v, s.v0),
           "a0": torch.where(act3, s.a, s.a0)}
    if u_mode == "energy":
        u = s.u + 0.5 * (s.dudt - s.dudt0) * dt_p
        u = torch.where(u <= 0.0, s.u0 + s.dudt0 * dt_p, u)
        u = torch.where(active, u, s.u)
        upd["u"] = u
        upd["u0"] = torch.where(active, u, s.u0)
        upd["dudt0"] = torch.where(active, s.dudt, s.dudt0)
    elif u_mode == "radws":
        # advance() wrote u; the particles ending their step start the
        # next relaxation from it (EnergyRadws::EndTimestep)
        upd["u0"] = torch.where(active, s.u, s.u0)
        upd["dudt0"] = torch.where(active, s.dudt, s.dudt0)
    dt_next = torch.where(active, dt_crit, B.dt_next)
    lad, B = ladder_update(cfg, B, s.alive, active, level, s.levelneib,
                           nstep_part, s.nlast, s.tlast, dt_next, n, t,
                           dt_extra=dt_extra)
    s = s.replace(t=t, dt=B.dt_base, **lad, **upd)
    return s, B


def ladder_update(cfg: BlockConfig, B: BlockSchedule, alive: Tensor,
                  active: Tensor, level: Tensor, levelneib: Tensor,
                  nstep_part: Tensor, nlast: Tensor, tlast: Tensor,
                  dt_next: Tensor, n: Tensor, t: Tensor,
                  dt_extra: Tensor = None):
    """Per-particle level moves, level_max growth or shrink with the
    integer times rescaled, and the resync rebuild.  `dt_extra` (0-d,
    the sinks' and stars' bound) caps the resync's dt_min and, between
    resyncs, raises the occupied level_max to its level under dt_max,
    at most one level above the current one.  Returns
    (dict(level=, levelneib=, nlast=, tlast=), BlockSchedule)."""
    is_resync = n == B.nresync

    # resync branch (n == nresync): rebuild the ladder
    dtp_sync = torch.where(alive, dt_next, torch.full_like(dt_next, 1e30))
    dt_min = torch.min(dtp_sync)
    if dt_extra is not None:
        dt_min = torch.minimum(dt_min, dt_extra)
    lmax_sync = _i32(cfg.nlevels - 1, n)
    dtmax_sync = dt_min * _pow2(lmax_sync).to(dt_min.dtype)
    lvl_sync = torch.minimum(compute_timestep_level(dtp_sync, dtmax_sync),
                             lmax_sync)
    lvl_sync = torch.where(alive, lvl_sync, lmax_sync)

    # adjust branch: per-particle level moves
    lvl_req = torch.maximum(compute_timestep_level(dt_next, B.dt_max),
                            levelneib - cfg.level_diff_max)
    natural = active & (nstep_part == _pow2(B.level_max - level))
    # a natural end goes down one level only at a synchronised boundary.
    # A dead particle stays on the deepest level, so a shrink of the
    # ladder takes its nstep to 0; the JAX package's remainder by 0 is
    # read there only where no particle is active, and a divisor of 1
    # stands in for it
    down_ok = (lvl_req < level) & (level > 1) \
        & (torch.remainder(n, torch.clamp_min(2 * nstep_part, 1)) == 0)
    lvl_nat = torch.where(down_ok, level - 1,
                          torch.where(lvl_req > level, lvl_req, level))
    # a step shortened by the limiter can only go up
    lvl_art = torch.maximum(level, lvl_req)
    lvl_adj = torch.where(active, torch.where(natural, lvl_nat, lvl_art),
                          level)
    lvl_adj = torch.clamp(lvl_adj, 0, LEVEL_CAP)
    neib_adj = torch.where(active, torch.where(natural, lvl_req, lvl_adj),
                           levelneib)

    # level_max bookkeeping and integer-time rescaling
    lmax_old = B.level_max
    lmax_occ = torch.max(torch.where(alive, lvl_adj,
                                     torch.zeros_like(lvl_adj)))
    if dt_extra is not None:
        lvl_extra = torch.minimum(
            compute_timestep_level(dt_extra, B.dt_max), lmax_old + 1)
        lmax_occ = torch.maximum(lmax_occ, lvl_extra)
    grow = lmax_occ > lmax_old
    shrink = (~grow) & (lmax_occ <= lmax_old - 1) & (lmax_old > 1) \
        & (torch.remainder(n, 2) == 0)
    one, two = _i32(1, n), _i32(2, n)
    lmax_adj = torch.where(grow, lmax_occ,
                           torch.where(shrink, lmax_old - 1, lmax_old))
    nfac = torch.where(grow, _pow2(lmax_occ - lmax_old), one)
    ndiv = torch.where(shrink, two, one)
    # floor division of non-negative int32
    n_adj = torch.div(n * nfac, ndiv, rounding_mode="floor")
    nlast_all = torch.div(nlast * nfac, ndiv, rounding_mode="floor")
    nstep_all = torch.div(nstep_part * nfac, ndiv, rounding_mode="floor")

    nresync_adj = _pow2(lmax_adj)
    dtbase_adj = B.dt_max / nresync_adj.to(B.dt_max.dtype)
    # particles ending now get nstep for their (possibly new) level
    nstep_adj = torch.where(active, _pow2(lmax_adj - lvl_adj), nstep_all)
    nlast_adj = torch.where(active, n_adj, nlast_all)

    def sel(a, b):
        return torch.where(is_resync, a, b)

    lad = dict(level=sel(lvl_sync, lvl_adj),
               levelneib=sel(lvl_sync, neib_adj),
               nlast=sel(torch.zeros_like(nlast), nlast_adj),
               tlast=torch.where(active | is_resync, t, tlast))
    B = BlockSchedule(
        n=sel(_i32(0, n), n_adj), level_max=sel(lmax_sync, lmax_adj),
        nresync=sel(_pow2(lmax_sync), nresync_adj),
        dt_base=sel(dtmax_sync / _pow2(lmax_sync).to(dt_min.dtype),
                    dtbase_adj),
        dt_max=sel(dtmax_sync, B.dt_max),
        nstep_part=sel(_pow2(lmax_sync - lvl_sync), nstep_adj),
        dt_next=dt_next)
    return lad, B
