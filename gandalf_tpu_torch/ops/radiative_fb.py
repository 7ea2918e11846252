"""Radiative feedback: the per-particle ambient temperature that the
RadWS equilibrium relaxes toward, from accretion-luminosity heating by
the sinks and a disc profile around the central ones.

Counterpart of ``gandalf_tpu/ops/radiative_fb.py`` (RadiativeFB,
SinkHeating and DiscHeating, src/Thermal/RadiativeFB.cpp:40-306):

  T_amb(x)^4 = T_inf^4 + sum_sinks 0.25 (r_source/d)^2 T_sink^4 + disc,
  T_sink     = (L / (4 pi sigma r_source^2))^(1/4),
  L          = f_n (m/msun)^3 Lsun + f_acc (m mdot / r_source)
               (1 - r_source/(2 r_sink)),

with r_source and f_n chosen by the sink's mass class (planet, brown
dwarf, star).  ``sink_luminosity`` is an O(N_sink) torch pass;
``combined_ambient_temperature`` launches K30 (``csrc/radiative_fb.cu``)
over every particle and sink slot on CUDA tensors and runs its plain
version ``combined_ambient_temperature_plain`` (the JAX arithmetic over
chunks of particles) on CPU tensors, in 1-3 dims.  ``ambient_temperature``
(the sink term alone) is the combined temperature without a disc, and
``disc_ambient_t4`` is plain torch, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import _ext

Tensor = torch.Tensor

# (particle, slot) pairs per chunk of particles in the plain version of K30
_CHUNK_PAIRS = 1 << 22


@dataclasses.dataclass(frozen=True)
class SinkHeatingConfig:
    rad_const: float = 1.0      # Stefan-Boltzmann, code units
    temp_inf: float = 5.0
    f_acc: float = 0.75
    lsun: float = 1.0           # solar luminosity, code units
    msun: float = 1.0
    mjup: float = 9.546e-4      # in msun units
    r_planet: float = 1.0e-2    # source radii, code units
    r_bdwarf: float = 1.0e-2
    r_star: float = 1.0e-2


@dataclasses.dataclass(frozen=True)
class DiscHeatingConfig:
    """DiscHeating (RadiativeFB.cpp:108-148): T^4 = temp_au^4 (d_mid^2 +
    rsmooth^2)^(-2 q) with d_mid the midplane (x-y) distance to each of
    the first n_central sinks."""

    temp_au: float = 250.0
    temp_q: float = 0.75
    rsmooth: float = 0.01
    n_central: int = 1


def sink_luminosity(cfg: SinkHeatingConfig, m: Tensor, mdot: Tensor,
                    rsink: Tensor):
    """(L, r_source) per sink (SinkLuminosity, RadiativeFB.cpp:238-256):
    stellar class at m >= 80 M_J, brown dwarf at m >= 13 M_J, planet
    below, M_J in units of msun."""
    mj = cfg.mjup * cfg.msun
    star, bdwarf = m >= 80.0 * mj, m >= 13.0 * mj

    def full(x):
        return torch.full_like(m, x)

    r_source = torch.where(star, full(cfg.r_star),
                           torch.where(bdwarf, full(cfg.r_bdwarf),
                                       full(cfg.r_planet)))
    f_n = star.to(m.dtype)
    L = f_n * (m / cfg.msun) ** 3 * cfg.lsun \
        + cfg.f_acc * (m * mdot / r_source) \
        * (1.0 - r_source / (2.0 * torch.clamp_min(rsink, 1e-30)))
    return L, r_source


def _sink_terms(cfg: SinkHeatingConfig, m_sink, mdot_sink, rad_sink):
    """Per slot 0.25 r_source^2 and T_sink^4 = L / (4 pi sigma
    max(r_source^2, 1e-30)), the factors of each particle's sink sum."""
    L, r_src = sink_luminosity(cfg, m_sink, mdot_sink, rad_sink)
    r2 = r_src * r_src
    tsink4 = L / (4.0 * math.pi * cfg.rad_const * torch.clamp_min(r2, 1e-30))
    return 0.25 * r2, tsink4


def _d2(a: Tensor, b: Tensor, dims: int) -> Tensor:
    """Squared separations (A, B) over the first `dims` components, summed
    in component order."""
    out = None
    for k in range(dims):
        d = a[:, None, k] - b[None, :, k]
        out = d * d if out is None else out + d * d
    return out


def ambient_temperature(cfg: SinkHeatingConfig, r: Tensor, r_sink: Tensor,
                        m_sink: Tensor, mdot_sink: Tensor, rad_sink: Tensor,
                        active: Tensor) -> Tensor:
    """(N,) per-particle ambient temperature from the sinks alone
    (RadiativeFB::AmbientTemp + SinkHeating::AmbientTemp): the combined
    temperature without disc heating."""
    return combined_ambient_temperature(cfg, None, r, r_sink, m_sink,
                                        mdot_sink, rad_sink, active)


def disc_ambient_t4(cfg: DiscHeatingConfig, r: Tensor, r_sink: Tensor,
                    active: Tensor) -> Tensor:
    """(N,) T^4 of the disc profile about the first n_central sinks
    (DiscHeating::AmbientTemp), over the midplane's min(2, ndim)
    components (the JAX function's r[:, :2] takes the one there is in
    1D)."""
    nc = cfg.n_central
    mid = min(2, r.shape[1])
    t4 = cfg.temp_au ** 4 * (_d2(r, r_sink[:nc], mid)
                             + cfg.rsmooth ** 2) ** (-2.0 * cfg.temp_q)
    return torch.sum(torch.where(active[None, :nc], t4, 0.0), dim=1)


def combined_ambient_temperature(sink_cfg: SinkHeatingConfig, disc_cfg,
                                 r: Tensor, r_sink: Tensor, m_sink: Tensor,
                                 mdot_sink: Tensor, rad_sink: Tensor,
                                 active: Tensor) -> Tensor:
    """RadiativeFB::AmbientTemp (RadiativeFB.cpp:88-102): (N,) T_amb with
    T^4 = T_inf^4 + the sink terms of the active slots + the disc term;
    with disc heating (`disc_cfg` not None) the first n_central slots
    leave the sink sum and enter the disc term.  K30 on CUDA tensors."""
    q, tsink4 = _sink_terms(sink_cfg, m_sink, mdot_sink, rad_sink)
    act = active
    if disc_cfg is not None:
        act = act & (torch.arange(r_sink.shape[0], device=r.device)
                     >= disc_cfg.n_central)
    if r.is_cuda:
        return _ext.ambient_temperature(r.contiguous(), r_sink.contiguous(),
                                        q.contiguous(), tsink4.contiguous(),
                                        act.contiguous(), active.contiguous(),
                                        sink_cfg.temp_inf, disc_cfg)
    return combined_ambient_temperature_plain(sink_cfg, disc_cfg, r, r_sink,
                                              q, tsink4, act, active)


def combined_ambient_temperature_plain(sink_cfg, disc_cfg, r, r_sink, q,
                                       tsink4, act, active) -> Tensor:
    """Plain version of K30 from the per-slot factors (q = 0.25
    r_source^2, T_sink^4), the sink sum's mask `act` and the disc's
    `active`: the JAX arithmetic over chunks of particles."""
    step = max(1, _CHUNK_PAIRS // max(r_sink.shape[0], 1))
    out = []
    for c0 in range(0, r.shape[0], step):
        rc = r[c0:c0 + step]
        contrib = q[None, :] / torch.clamp_min(_d2(rc, r_sink, r.shape[1]),
                                               1e-30) * tsink4[None, :]
        contrib = torch.where(act[None, :], contrib, 0.0)
        t4 = sink_cfg.temp_inf ** 4 + torch.sum(contrib, dim=1)
        if disc_cfg is not None:
            t4 = t4 + disc_ambient_t4(disc_cfg, rc, r_sink, active)
        out.append(t4 ** 0.25)
    if not out:
        return torch.zeros_like(r[:, 0])
    return torch.cat(out)
