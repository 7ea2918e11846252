"""4th-order Hermite N-body integration (Makino & Aarseth 1992) and its
time-symmetric variants.

Counterpart of ``gandalf_tpu/integrate/hermite.py`` (NbodyHermite4,
NbodyHermite4TS, NbodyHermite6TS of src/Nbody/): the predictors, the
correctors, the end-of-step copies and the Aarseth timestep, as
elementwise torch on the state's device.  `dt` is a 0-d tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from ..state import NbodyState

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HermiteConfig:
    nbody_mult: float = 0.1
    npec: int = 1

    @staticmethod
    def from_params(params) -> "HermiteConfig":
        return HermiteConfig(nbody_mult=params.floatparams["nbody_mult"],
                             npec=params.intparams["Npec"])


def predict(s: NbodyState, dt: Tensor) -> NbodyState:
    """Hermite predictor (NbodyHermite4::AdvanceParticles, :340):
    r_p = r0 + v0 dt + a0 dt^2/2 + adot0 dt^3/6;
    v_p = v0 + a0 dt + adot0 dt^2/2."""
    dt2 = dt * dt
    r = s.r0 + s.v0 * dt + 0.5 * s.a0 * dt2 + s.adot0 * dt2 * dt / 6.0
    v = s.v0 + s.a0 * dt + 0.5 * s.adot0 * dt2
    return s.replace(r=r, v=v)


def _a2dot_a3dot(s: NbodyState, dt: Tensor):
    """The snap and crackle of the (a0, adot0, a, adot) Hermite fit."""
    invdt = 1.0 / dt
    a2dot = (-6.0 * (s.a0 - s.a) - dt * (4.0 * s.adot0 + 2.0 * s.adot)) \
        * invdt * invdt
    a3dot = (12.0 * (s.a0 - s.a) + 6.0 * dt * (s.adot0 + s.adot)) \
        * invdt * invdt * invdt
    return a2dot, a3dot


def correct(s: NbodyState, dt: Tensor) -> NbodyState:
    """Hermite corrector (NbodyHermite4::CorrectionTerms, :388-437):
    4th/5th-order position and velocity corrections from a2dot, a3dot."""
    a2dot, a3dot = _a2dot_a3dot(s, dt)
    dt3 = dt ** 3
    r = s.r + a2dot * dt3 * dt / 24.0 + a3dot * dt3 * dt * dt / 120.0
    v = s.v + a2dot * dt3 / 6.0 + a3dot * dt3 * dt / 24.0
    return s.replace(r=r, v=v, a2dot=a2dot, a3dot=a3dot)


def correct_ts4(s: NbodyState, dt: Tensor) -> NbodyState:
    """Time-symmetric 4th-order Hermite corrector
    (NbodyHermite4TS::CorrectionTerms, NbodyHermite4TS.cpp:77-120):
    v = v0 + (a0+a) dt/2 - (adot-adot0) dt^2/12;
    r = r0 + (v0+v) dt/2 - (a-a0) dt^2/12."""
    a2dot, a3dot = _a2dot_a3dot(s, dt)
    dt2 = dt * dt
    v = s.v0 + 0.5 * (s.a0 + s.a) * dt - (s.adot - s.adot0) * dt2 / 12.0
    r = s.r0 + 0.5 * (s.v0 + v) * dt - (s.a - s.a0) * dt2 / 12.0
    return s.replace(r=r, v=v, a2dot=a2dot, a3dot=a3dot)


def predict_ts6(s: NbodyState, dt: Tensor) -> NbodyState:
    """6th-order predictor with the step-start snap
    (NbodyHermite6TS::AdvanceParticles)."""
    dt2 = dt * dt
    dt3 = dt2 * dt
    dt4 = dt3 * dt
    r = s.r0 + s.v0 * dt + 0.5 * s.a0 * dt2 + s.adot0 * dt3 / 6.0 \
        + s.a2dot0 * dt4 / 24.0
    v = s.v0 + s.a0 * dt + 0.5 * s.adot0 * dt2 + s.a2dot0 * dt3 / 6.0
    return s.replace(r=r, v=v)


def correct_ts6(s: NbodyState, dt: Tensor) -> NbodyState:
    """Time-symmetric 6th-order Hermite corrector with the begin and end
    snap (NbodyHermite6TS::CorrectionTerms, NbodyHermite6TS.cpp:496-551):
    v = v0 + (a0+a) dt/2 - (adot-adot0) dt^2/10 + (a2dot+a2dot0) dt^3/120,
    and symmetrically for r."""
    invdt = 1.0 / dt
    dt2 = dt * dt
    dt3 = dt2 * dt
    a3dot = (12.0 * (s.a0 - s.a) + 6.0 * dt * (s.adot0 + s.adot)) \
        * invdt * invdt * invdt
    v = s.v0 + 0.5 * (s.a0 + s.a) * dt - 0.1 * (s.adot - s.adot0) * dt2 \
        + (s.a2dot + s.a2dot0) * dt3 / 120.0
    r = s.r0 + 0.5 * (s.v0 + v) * dt - 0.1 * (s.a - s.a0) * dt2 \
        + (s.adot + s.adot0) * dt3 / 120.0
    return s.replace(r=r, v=v, a3dot=a3dot)


def end_timestep(s: NbodyState) -> NbodyState:
    """Record the step-start quantities (NbodyHermite4::EndTimestep)."""
    return s.replace(r0=s.r, v0=s.v, a0=s.a, adot0=s.adot, a2dot0=s.a2dot)


def aarseth_timestep(cfg: HermiteConfig, s: NbodyState) -> Tensor:
    """Per-star Aarseth timestep (NbodyHermite4::Timestep,
    NbodyHermite4.cpp:538-570)."""
    tiny = 1e-20
    asqd = torch.sum(s.a * s.a, dim=-1)
    a1sqd = torch.sum(s.adot * s.adot, dim=-1)
    a2sqd = torch.sum(s.a2dot * s.a2dot, dim=-1)
    a3sqd = torch.sum(s.a3dot * s.a3dot, dim=-1)
    full = cfg.nbody_mult * torch.sqrt(
        (torch.sqrt(asqd * a2sqd) + a1sqd)
        / (torch.sqrt(a1sqd * a3sqd) + a2sqd + tiny))
    simple = cfg.nbody_mult * torch.sqrt(asqd / (a2sqd + tiny))
    accel = torch.sqrt(s.h / (torch.sqrt(asqd) + tiny))
    big = torch.full_like(asqd, 1e20)
    return torch.where(
        (a1sqd > tiny) & (a2sqd > tiny), full,
        torch.where((asqd > tiny) & (a2sqd > tiny), simple,
                    torch.where(asqd > tiny, accel, big)))
