"""SPH pair forces over gathered neighbour views, and the artificial
dissipation configuration.

Counterpart of ``gandalf_tpu/ops/forces.py``'s ``AVISC_*``/``ACOND_*``
codes, ``ArtificialViscosity``, ``HydroForces``, ``NeighborView`` and
``compute_hydro_forces``: the conservative grad-h pressure force, mon97
viscosity (or per-particle alpha), Wadsley or Price conductivity, the
velocity divergence and the compressive heating, over (n, K) blocks of
candidate neighbours with a validity mask.  The plain version of K9
(``ops/active_grid.py``) evaluates it on gathered candidates; the grid
pass's pair forces are K3 in ``ops/sph_grid27.py``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor

AVISC_NONE = 0
AVISC_MON97 = 1
AVISC_MON97MM97 = 2      # time-dependent alpha (Morris & Monaghan 97)
ACOND_NONE = 0
ACOND_WADSLEY2008 = 1
ACOND_PRICE2008 = 2

_AVISC_CODES = {"none": AVISC_NONE, "mon97": AVISC_MON97,
                "mon97mm97": AVISC_MON97MM97, "mon97cd2010": AVISC_MON97MM97}
_ACOND_CODES = {"none": ACOND_NONE, "wadsley2008": ACOND_WADSLEY2008,
                "price2008": ACOND_PRICE2008}


@dataclasses.dataclass(frozen=True)
class ArtificialViscosity:
    """Static dissipation configuration."""

    avisc: int = AVISC_MON97
    acond: int = ACOND_NONE
    alpha_visc: float = 1.0
    alpha_visc_min: float = 0.1
    beta_visc: float = 2.0

    @staticmethod
    def from_params(params) -> "ArtificialViscosity":
        avisc = params.stringparams["avisc"]
        # avisc = mon97 with time_dependent_avisc = mm97/cd2010 is the
        # time-dependent scheme
        if (avisc == "mon97"
                and params.stringparams["time_dependent_avisc"] != "none"):
            avisc = "mon97mm97"
        return ArtificialViscosity(
            avisc=_AVISC_CODES[avisc],
            acond=_ACOND_CODES[params.stringparams["acond"]],
            alpha_visc=params.floatparams["alpha_visc"],
            alpha_visc_min=params.floatparams["alpha_visc_min"],
            beta_visc=params.floatparams["beta_visc"],
        )


class HydroForces(NamedTuple):
    a: Tensor          # (n, 3) hydro acceleration
    dudt: Tensor       # (n,) du/dt
    div_v: Tensor      # (n,) velocity divergence
    dalphadt: Tensor   # (n,) MM97 alpha evolution


class NeighborView(NamedTuple):
    """Gathered neighbour fields, shape (n, K) (+ 3 for vectors)."""

    dr: Tensor       # r_j - r_i with periodic shifts: (n, K, 3)
    v: Tensor        # (n, K, 3)
    m: Tensor
    h: Tensor
    rho: Tensor
    u: Tensor
    pressure: Tensor
    sound: Tensor
    invomega: Tensor
    hfactor: Tensor
    alpha: Tensor
    mask: Optional[Tensor]    # validity; None = all valid


def compute_hydro_forces(kern, visc: ArtificialViscosity, v_i: Tensor,
                         h_i: Tensor, rho_i: Tensor, u_i: Tensor,
                         press_i: Tensor, sound_i: Tensor,
                         invomega_i: Tensor, hfactor_i: Tensor,
                         alpha_i: Tensor, nb: NeighborView) -> HydroForces:
    """Per-particle hydro force sums over a neighbour view: the i fields
    are (n,) or (n, 3), the view's (n, K) or (n, K, 3).  A candidate
    counts where it is valid and does not coincide with i (d > 0)."""
    drmag = torch.sqrt(torch.sum(nb.dr * nb.dr, dim=-1))
    valid = drmag > 0.0
    if nb.mask is not None:
        valid = valid & nb.mask
    zero = torch.zeros_like(drmag)
    inv_drmag = torch.where(valid, 1.0 / torch.clamp_min(drmag, 1e-300),
                            zero)
    unit = nb.dr * inv_drmag[..., None]
    invh_i = 1.0 / h_i
    invrho_i = 1.0 / rho_i
    invrho_j = 1.0 / nb.rho
    wkerni = torch.where(valid, hfactor_i[:, None]
                         * kern.w1(drmag * invh_i[:, None]), zero)
    wkernj = torch.where(valid, nb.hfactor * kern.w1(drmag * (1.0 / nb.h)),
                         zero)
    dvdr = torch.sum((nb.v - v_i[:, None, :]) * unit, dim=-1)
    div_v = -torch.sum(nb.m * dvdr * wkerni, dim=-1)
    paux = ((press_i * invomega_i * invrho_i * invrho_i)[:, None] * wkerni
            + nb.pressure * nb.invomega * invrho_j * invrho_j * wkernj)
    dudt = torch.zeros_like(rho_i)
    approach = valid & (dvdr < 0.0)
    if visc.avisc != AVISC_NONE:
        winvrho = 0.25 * (wkerni + wkernj) * (invrho_i[:, None] + invrho_j)
        if visc.avisc == AVISC_MON97:
            alpha_eff = visc.alpha_visc
        else:
            alpha_eff = 0.5 * (alpha_i[:, None] + nb.alpha)
        vsignal = sound_i[:, None] + nb.sound \
            - visc.beta_visc * alpha_eff * dvdr
        paux = paux - torch.where(approach,
                                  alpha_eff * vsignal * dvdr * winvrho, zero)
        dudt = dudt - torch.sum(torch.where(
            approach, 0.5 * nb.m * alpha_eff * vsignal * dvdr * dvdr
            * winvrho, zero), dim=-1)
        if visc.acond == ACOND_WADSLEY2008:
            cond = nb.m * dvdr * (nb.u - u_i[:, None]) * (
                invrho_i[:, None] * wkerni + invrho_j * wkernj)
            dudt = dudt + torch.sum(torch.where(approach, cond, zero), -1)
        elif visc.acond == ACOND_PRICE2008:
            cond = (0.5 * nb.m * (u_i[:, None] - nb.u) * winvrho
                    * (invrho_i[:, None] + invrho_j)
                    * torch.sqrt(torch.abs(press_i[:, None] - nb.pressure)))
            dudt = dudt + torch.sum(torch.where(approach, cond, zero), -1)
    a = torch.sum((nb.m * paux)[..., None] * unit, dim=-2)
    div_v = div_v * invrho_i
    dudt = dudt - press_i * div_v * invrho_i * invomega_i
    dalphadt = torch.zeros_like(rho_i)
    if visc.avisc == AVISC_MON97MM97:
        dalphadt = (0.1 * sound_i * (visc.alpha_visc_min - alpha_i) * invh_i
                    + torch.clamp_min(-div_v, 0.0)
                    * (visc.alpha_visc - alpha_i))
    return HydroForces(a=a, dudt=dudt, div_v=div_v, dalphadt=dalphadt)
