"""KDK leapfrog with a global timestep, and the SPH timestep criteria.

Counterpart of ``gandalf_tpu/integrate/leapfrog.py``: ``predict`` drifts
and kicks from the step-start state, ``correct`` applies the second
half-kick and latches the step-start copies, ``sph_timestep`` gives the
per-particle Courant, acceleration and energy limits.
"""

from __future__ import annotations

import dataclasses

import torch

from ..state import SphState

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    scheme: str = "lfkdk"
    energy_integration: bool = True
    td_avisc: bool = False
    courant_mult: float = 0.15
    accel_mult: float = 0.3
    energy_mult: float = 0.4

    @staticmethod
    def from_params(params, energy_integration: bool) -> "IntegratorConfig":
        return IntegratorConfig(
            scheme=params.stringparams["sph_integration"],
            energy_integration=energy_integration,
            td_avisc=params.stringparams["time_dependent_avisc"] != "none",
            courant_mult=params.floatparams["courant_mult"],
            accel_mult=params.floatparams["accel_mult"],
            energy_mult=params.floatparams["energy_mult"],
        )


def predict(cfg: IntegratorConfig, s: SphState, dt: Tensor) -> SphState:
    """KDK predictor: drift positions, kick velocities with the
    step-start acceleration.  A time-dependent alpha is left as it is
    (gandalf_tpu/integrate/leapfrog.py:52-53 sets it to itself); correct
    advances it."""
    out = {"r": s.r0 + s.v0 * dt + 0.5 * s.a0 * dt * dt,
           "v": s.v0 + s.a0 * dt}
    if cfg.energy_integration:
        out["u"] = s.u0 + s.dudt0 * dt
    return s.replace(**out)


def correct(cfg: IntegratorConfig, s: SphState, dt: Tensor,
            dalphadt: Tensor) -> SphState:
    """KDK corrector plus end-of-step bookkeeping."""
    v = s.v + 0.5 * dt * (s.a - s.a0)
    out = {"v": v, "r0": s.r, "v0": v, "a0": s.a}
    if cfg.energy_integration:
        u = s.u + 0.5 * (s.dudt - s.dudt0) * dt
        # a negative energy falls back to the first-order update
        u = torch.where(u <= 0.0, s.u0 + s.dudt0 * dt, u)
        out["u"] = u
        out["u0"] = u
        out["dudt0"] = s.dudt
    if cfg.td_avisc:
        out["alpha"] = s.alpha + dalphadt * dt
    return s.replace(**out)


def sph_timestep(cfg: IntegratorConfig, s: SphState,
                 hydro_forces: bool = True) -> Tensor:
    """Per-particle SPH timestep (N,): Courant, acceleration and, with
    energy integration, energy criteria."""
    tiny = 1e-30
    if hydro_forces:
        dt_cfl = cfg.courant_mult * s.h / (
            s.sound + s.h * torch.abs(s.div_v) + tiny)
    else:
        dt_cfl = cfg.courant_mult * s.h / (s.h * torch.abs(s.div_v) + tiny)
    amag = torch.sqrt(torch.sum(s.a * s.a, dim=-1))
    dt_acc = cfg.accel_mult * torch.sqrt(s.h / (amag + tiny))
    dt = torch.minimum(dt_cfl, dt_acc)
    if cfg.energy_integration:
        dt_en = cfg.energy_mult * s.u / (torch.abs(s.dudt) + tiny)
        # u = 0 lanes carry no thermal state
        dt = torch.minimum(dt, torch.where(s.u > 0.0, dt_en,
                                           torch.full_like(dt_en, 1e30)))
    return dt
