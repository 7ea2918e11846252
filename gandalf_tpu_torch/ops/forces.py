"""SPH pair forces over gathered neighbour views, the artificial
dissipation configuration, and the Cullen & Dehnen (2010) viscosity
switch (K21).

Counterpart of ``gandalf_tpu/ops/forces.py``'s ``AVISC_*``/``ACOND_*``
codes, ``ArtificialViscosity``, ``HydroForces``, ``NeighborView`` and
``compute_hydro_forces``: the conservative grad-h pressure force, mon97
viscosity (or per-particle alpha), Wadsley or Price conductivity, the
velocity divergence and the compressive heating, over (n, K) blocks of
candidate neighbours with a validity mask.  The plain version of K9
(``ops/active_grid.py``) evaluates it on gathered candidates; the grid
pass's pair forces are K3 in ``ops/sph_grid27.py``.

``cullen_dehnen_dense`` is the counterpart of gandalf_tpu's (the
time_dependent_avisc = cd2010 switch of a global step): the weighted
sums rr, dvw and daw over the 3^ndim-cell stencil of the alive
particles (K1 with the dead binned out, no mirror images), then the
shared finale ``_cd2010_finalize``.  It launches K21
(``csrc/cullen_dehnen.cu``) on CUDA tensors and runs its plain version
``cullen_dehnen_sums_plain`` on CPU tensors; both take any smoothing
kernel of the family (M4, the quintic, the gaussian, direct or
tabulated) and cut the sums at its kernrange.  ``cullen_dehnen_alpha``,
the JAX package's all-pairs form, is kept as a torch oracle for the
tests only (ROADMAP's "Not to port" rule for brute-force paths).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import _ext

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


# ---------------------------------------------------------------------------
# K21: the Cullen & Dehnen (2010) switch
# ---------------------------------------------------------------------------

# per-particle columns of K21's packed table, after v (ndim) and a (ndim):
# m, h, hfactor / max(rho, 1e-30), alpha, sound
CD_COLS = ("m", "h", "coef", "alpha", "sound")


def _cd2010_terms(visc: ArtificialViscosity, rr: Tensor, dvw: Tensor,
                  daw: Tensor, h: Tensor, sound: Tensor, alpha: Tensor):
    """The finale of the switch on (n, nd, nd) sums: (alpha_new,
    dalphadt, bad), gandalf_tpu/ops/forces.py:_cd2010_finalize (:224)
    with its bad-gradient flag."""
    ndim = rr.shape[-1]
    invh = 1.0 / h
    eye = torch.eye(ndim, dtype=rr.dtype, device=rr.device)
    det_ok = torch.abs(torch.linalg.det(rr)) > 1e-30
    rr_safe = torch.where(det_ok[:, None, None], rr, eye)
    T = torch.linalg.inv(rr_safe)
    modR = torch.sum(rr * rr, dim=(1, 2))
    modT = torch.sum(T * T, dim=(1, 2))
    bad = (~det_ok) | (modR * modT / (ndim * ndim) > 1e4)
    # dvdx[i][j] = T[j][k] dv[k][i]
    dvdx = torch.einsum("njk,nki->nij", T, dvw)
    dadx = torch.einsum("njk,nki->nij", T, daw)
    ddivdt = torch.einsum("nii->n", dadx) \
        - torch.einsum("nij,nji->n", dvdx, dvdx)
    divv = torch.einsum("nii->n", dvdx)
    divv2 = divv * divv
    curl = dvdx - dvdx.transpose(1, 2)
    curlv2 = 0.5 * torch.sum(curl * curl, dim=(1, 2))
    f_balsara = torch.where(
        curlv2 > 0.0, divv2 / torch.clamp_min(divv2 + curlv2, 1e-30), 1.0)
    c2 = torch.clamp_min(sound * sound, 1e-30)
    alpha_loc = torch.where(
        ddivdt < 0.0, torch.clamp_max(10.0 * h * h / c2 * f_balsara
                                      * (-ddivdt), visc.alpha_visc), 0.0)
    alpha_loc = torch.where(bad, visc.alpha_visc, alpha_loc)
    alpha_new = torch.maximum(alpha, alpha_loc)
    dalphadt = (0.1 * sound
                * (torch.clamp_min(alpha_loc, visc.alpha_visc_min)
                   - alpha_new) * invh)
    return alpha_new, dalphadt, bad


def _cd2010_finalize(visc: ArtificialViscosity, rr, dvw, daw, h, sound,
                     alpha):
    """The guarded inverse of rr (the identity where |det| <= 1e-30; bad
    there or where |rr|^2 |rr^-1|^2 / ndim^2 > 1e4), the gradients, the
    shock indicator ddivdt = tr(da/dx) - dv/dx : dv/dx^T, the Balsara
    factor and alpha_loc (alpha_visc where bad): (alpha_new =
    max(alpha, alpha_loc), dalphadt = 0.1 c (max(alpha_min, alpha_loc) -
    alpha_new) / h)."""
    return _cd2010_terms(visc, rr, dvw, daw, h, sound, alpha)[:2]


def cd_packed(v, a, m, h, rho, hfactor, alpha, sound) -> Tensor:
    """K21's per-particle table (N, 2 ndim + 5): v, a and CD_COLS."""
    coef = hfactor / torch.clamp_min(rho, 1e-30)
    return torch.cat([v, a, torch.stack([m, h, coef, alpha, sound], -1)],
                     dim=-1)


def cullen_dehnen_sums(kern, visc: ArtificialViscosity, spec, ids_d: Tensor,
                       r: Tensor, packed: Tensor):
    """The switch of every particle of K1's slot map ids_d over its
    3^ndim-cell stencil: (alpha_new, dalphadt, bad), each (N,) (zero for
    a particle without a slot).  `packed` is cd_packed's table.  K21 on
    CUDA tensors."""
    if r.is_cuda:
        return _ext.cullen_dehnen(spec, kern, visc, ids_d, r.contiguous(),
                                  packed.contiguous())
    return cullen_dehnen_sums_plain(kern, visc, spec, ids_d, r, packed)


def cullen_dehnen_sums_plain(kern, visc: ArtificialViscosity, spec, ids_d,
                             r, packed):
    """Plain version of K21: the JAX sums over a list of the slot map's
    pairs within kernrange times the largest h (beyond, W' = 0 and a
    pair adds exactly zero), with the particle itself and coincident
    partners dropped, then _cd2010_terms.  The pair list sums d^2 in the
    CUDA kernel's order, so that s = |dr| / h_i, and a table index, are
    the kernel's."""
    from . import mfv_grid27 as mg

    N, nd = r.shape
    h = torch.clamp_min(packed[:, 2 * nd + 1], 1e-30)
    slotted = torch.zeros((N,), dtype=torch.bool, device=r.device)
    ids = ids_d.reshape(-1).long()
    slotted[ids[ids >= 0]] = True
    h_big = float(torch.max(torch.where(slotted, h, 0.0))) if N else 0.0
    cut2 = (kern.kernrange * h_big) ** 2 * (1.0 + 1e-6)
    row, col, dr, d2 = mg.slot_pairs(spec, ids_d, r, cut2, True)
    invh = 1.0 / h
    coef = packed[:, 2 * nd + 2]
    w = packed[col, 2 * nd] * (invh * coef)[row] \
        * kern.w1(torch.sqrt(d2) * invh[row])
    dv = packed[col, :nd] - packed[row, :nd]
    da = packed[col, nd:2 * nd] - packed[row, nd:2 * nd]
    wdr = w[:, None] * dr

    def outer(x):
        out = torch.zeros((N, nd, nd), dtype=r.dtype, device=r.device)
        return out.index_add_(0, row, wdr[:, :, None] * x[:, None, :])

    alpha_new, dal, bad = _cd2010_terms(
        visc, outer(dr), outer(dv), outer(da), h, packed[:, 2 * nd + 4],
        packed[:, 2 * nd + 3])
    zero = torch.zeros_like(alpha_new)
    return (torch.where(slotted, alpha_new, zero),
            torch.where(slotted, dal, zero), bad & slotted)


def cullen_dehnen_dense(kern, visc: ArtificialViscosity, spec, r, v, a, m,
                        h, rho, sound, hfactor, alpha, alive):
    """The cd2010 switch of a global step (gandalf_tpu's
    cullen_dehnen_dense over bin_particles(discard=~alive)): (alpha_new,
    dalphadt) in particle order, alpha and 0 for the dead."""
    from . import sph_grid27 as g27
    from .active_grid import dense_ids

    b = g27.bin_particles(spec, r, discard=~alive)
    packed = cd_packed(v, a, m, h, rho, hfactor, alpha, sound)
    alpha_new, dal, _ = cullen_dehnen_sums(kern, visc, spec,
                                           dense_ids(spec, b), r, packed)
    return (torch.where(alive, alpha_new, alpha),
            torch.where(alive, dal, torch.zeros_like(dal)))


def cullen_dehnen_alpha(kern, visc: ArtificialViscosity, box, r, v, a, m, h,
                        rho, sound, hfactor, alpha, r_ext, v_ext, a_ext,
                        m_ext):
    """The switch over all pairs of (r, v, a) against the (r_ext, v_ext,
    a_ext, m_ext) set, min-imaged in `box`: gandalf_tpu's
    cullen_dehnen_alpha, a torch oracle for the tests (never run by the
    simulation)."""
    dr = box.min_image(r_ext[None, :, :] - r[:, None, :])
    drsqd = torch.sum(dr * dr, dim=-1)
    valid = drsqd > 0.0
    drmag = torch.sqrt(torch.where(valid, drsqd, 1.0))
    invh = 1.0 / h
    w = m_ext[None, :] * (invh * hfactor / torch.clamp_min(rho, 1e-30)
                          )[:, None] * kern.w1(drmag * invh[:, None])
    w = torch.where(valid, w, 0.0)
    dv = v_ext[None, :, :] - v[:, None, :]
    da = a_ext[None, :, :] - a[:, None, :]
    rr = torch.einsum("nk,nki,nkj->nij", w, dr, dr)
    dvw = torch.einsum("nk,nki,nkj->nij", w, dr, dv)
    daw = torch.einsum("nk,nki,nkj->nij", w, dr, da)
    return _cd2010_finalize(visc, rr, dvw, daw, h, sound, alpha)
