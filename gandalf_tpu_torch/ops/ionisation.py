"""Photoionisation from point sources: the radial Stromgren balance.

Counterpart of ``gandalf_tpu/ops/ionisation.py`` (MultipleSourceIonisation,
src/Thermal/MultipleSourceIonisation.cpp:55-769, re-designed there as a
radial Stromgren integral per source).  Per source, the particles are
ranked by distance; the cumulative recombination rate

  R(<r) = sum_j alphaB (rho_j / mu_bar)^2 (m_j / rho_j)

is compared with the source's ionising rate Ndot, and the particles of
the prefix where R(<r) <= Ndot are ionised.  Where regions overlap,
``multi_source_ionisation`` splits each particle's recombinations
between the sources reaching it in proportion to the delivered flux
Ndot_s / d_ps^2 and solves the prefixes again, 8 rounds after the
independent solution.

``multi_source_ionisation`` launches K37 (``csrc/radiation.cu``) on CUDA
tensors and runs its plain version ``multi_source_ionisation_plain``
(the JAX arithmetic: a stable sort by distance, a cumulative sum, the
flags scattered back) on CPU tensors.  ``ionisation_fractions`` (the
independent solution alone) is plain torch, as are ``apply_ionisation``
and ``stromgren_radius``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import _ext

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class IonisationConfig:
    """Parameters of the reference scheme (ProcessParameters names)."""

    temp_ion: float = 10000.0      # ti
    temp_neutral: float = 10.0     # tn
    mu_ion: float = 0.678
    mu_bar: float = 2.35
    alphaB: float = 2.7e-13        # case-B recombination (code units)
    Ndotmin: float = 0.0


def recombination_rate(cfg: IonisationConfig, m: Tensor, rho: Tensor
                       ) -> Tensor:
    """alphaB n_H^2 (m / rho) per particle, n_H = rho / mu_bar."""
    n_h = rho / cfg.mu_bar
    return cfg.alphaB * n_h * n_h * (m / torch.clamp_min(rho, 1e-30))


def source_distances(r: Tensor, r_src: Tensor) -> Tensor:
    """(S, N) distances, the squares summed in axis order."""
    return torch.sqrt(torch.sum((r[None, :, :] - r_src[:, None, :]) ** 2,
                                dim=-1))


def ionisation_fractions(cfg: IonisationConfig, r: Tensor, m: Tensor,
                         rho: Tensor, r_src: Tensor, ndot_src: Tensor,
                         active_src: Tensor) -> Tensor:
    """(N,) flags: ionised where ANY source's budget reaches the particle,
    each source charged every recombination (the independent balance)."""
    rec = recombination_rate(cfg, m, rho)
    d = source_distances(r, r_src)
    order = torch.sort(d, dim=1, stable=True).indices
    cum = torch.cumsum(rec[order], dim=1)
    ion = torch.zeros_like(d, dtype=torch.bool)
    ion.scatter_(1, order, cum <= ndot_src[:, None])
    ion = ion & (active_src & (ndot_src > cfg.Ndotmin))[:, None]
    return torch.any(ion, dim=0)


def multi_source_ionisation(cfg: IonisationConfig, r: Tensor, m: Tensor,
                            rho: Tensor, r_src: Tensor, ndot_src: Tensor,
                            active_src: Tensor, n_iter: int = 8) -> Tensor:
    """(N,) ionised flags of the coupled multi-source balance
    (MultipleSourceIonisation.cpp:55-769): the independent prefixes, then
    `n_iter` rounds with each particle's recombinations split by flux
    between the sources reaching it.  K37 on CUDA tensors."""
    rec = recombination_rate(cfg, m, rho)
    src_on = active_src & (ndot_src > cfg.Ndotmin)
    if r.is_cuda:
        return _ext.stromgren_prefix(r.contiguous(), rec.contiguous(),
                                     r_src.contiguous(),
                                     ndot_src.contiguous(),
                                     src_on.contiguous(), n_iter)
    return multi_source_ionisation_plain(r, rec, r_src, ndot_src, src_on,
                                         n_iter)


def multi_source_ionisation_plain(r: Tensor, rec: Tensor, r_src: Tensor,
                                  ndot_src: Tensor, src_on: Tensor,
                                  n_iter: int = 8, cums: bool = False):
    """Plain version of K37 from the recombination rates `rec` (N,) and
    the sources' on flags: the JAX function's arithmetic, its stable
    argsort by distance fixed over the rounds.  With `cums`, also the
    last round's (S, N) cumulative sums at each particle."""
    d = source_distances(r, r_src)
    order = torch.sort(d, dim=1, stable=True).indices
    last = {}

    def solve(weights):
        w_sorted = torch.gather(weights * rec[None, :], 1, order)
        cum = torch.cumsum(w_sorted, dim=1)
        last["cum"] = cum
        reach = torch.zeros_like(d, dtype=torch.bool)
        reach.scatter_(1, order, cum <= ndot_src[:, None])
        return reach & src_on[:, None]

    reach = solve(torch.ones_like(d))
    for _ in range(n_iter):
        flux = torch.where(reach, ndot_src[:, None]
                           / torch.clamp_min(d * d, 1e-30), 0.0)
        tot = torch.sum(flux, dim=0)
        w = torch.where(tot[None, :] > 0.0,
                        flux / torch.clamp_min(tot[None, :], 1e-300), 1.0)
        reach = solve(w)
    ion = torch.any(reach, dim=0)
    if not cums:
        return ion
    at = torch.empty_like(last["cum"])
    at.scatter_(1, order, last["cum"])
    return ion, at


def apply_ionisation(cfg: IonisationConfig, gammam1: float,
                     ionised: Tensor, u: Tensor) -> Tuple[Tensor, Tensor]:
    """Internal energies for ionised and neutral gas (the temperature
    floors): (u_new, temp)."""
    u_ion = cfg.temp_ion / (gammam1 * cfg.mu_ion)
    u_neu = cfg.temp_neutral / (gammam1 * cfg.mu_bar)
    u_new = torch.where(ionised, torch.clamp_min(u, u_ion),
                        torch.clamp_min(u, u_neu))
    temp = torch.where(ionised, torch.full_like(u, cfg.temp_ion),
                       torch.full_like(u, cfg.temp_neutral))
    return u_new, temp


def stromgren_radius(ndot: float, n_H: float, alphaB: float) -> float:
    """Analytic uniform-density Stromgren radius (a test oracle)."""
    return (3.0 * ndot / (4.0 * np.pi * alphaB * n_H * n_H)) ** (1.0 / 3.0)
