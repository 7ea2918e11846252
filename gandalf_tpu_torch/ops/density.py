"""Grad-h SPH density and smoothing-length iteration over gathered
candidates.

Counterpart of ``gandalf_tpu/ops/density.py``'s ``_density_sums`` and
``compute_h``: the batch iteration (fixed-point steps 0..29, bisection
up to step 150, a converged row keeps its h) against (n, K) candidate
blocks with a validity mask, starting from the rows' own h, unclamped,
with the bracket [0, hmax].  The plain version of K8
(``ops/active_grid.py``) runs it on the active particles' candidates.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor

ITER_FP = 30          # fixed-point iterations before bisection
ITER_MAX = 150


class DensityResult(NamedTuple):
    h: Tensor
    rho: Tensor
    invomega: Tensor
    zeta: Tensor
    hfactor: Tensor     # 1/h^(ndim+1)
    converged: Tensor


def _density_sums(kern, ndim: int, h: Tensor, drsqd: Tensor, m_j: Tensor,
                  mask: Optional[Tensor]):
    """rho, invomega and zeta sums at h over (n, K) candidates."""
    invh = 1.0 / h
    invhsqd = invh * invh
    ssqd = drsqd * invhsqd[:, None]
    w0 = kern.w0_s2(ssqd)
    womega = kern.womega_s2(ssqd)
    wzeta = kern.wzeta_s2(ssqd)
    if mask is not None:
        zero = torch.zeros_like(w0)
        w0 = torch.where(mask, w0, zero)
        womega = torch.where(mask, womega, zero)
        wzeta = torch.where(mask, wzeta, zero)
    hfac = invh ** ndim
    rho = hfac * torch.sum(m_j * w0, dim=-1)
    invomega = hfac * invh * torch.sum(m_j * womega, dim=-1)
    zeta = invhsqd * torch.sum(m_j * wzeta, dim=-1)
    return rho, invomega, zeta


def iterate_h(kern, ndim: int, h_fac: float, h_converge: float, m: Tensor,
              h_init: Tensor, drsqd: Tensor, m_j: Tensor,
              mask: Optional[Tensor], hmax: float,
              active: Optional[Tensor] = None):
    """The lockstep h-rho iteration: (rho, invom, zeta) sums at each
    row's final h, its converged flag, and the largest h at which any
    row's sums were taken.  Rows outside `active` start done."""
    invndim = 1.0 / ndim
    h = h_init
    lo = torch.zeros_like(h)
    hi = torch.full_like(h, hmax)
    done = (torch.zeros(h.shape, dtype=torch.bool, device=h.device)
            if active is None else ~active)
    rho = invom = zeta = torch.zeros_like(h)
    h_peak = torch.zeros((), dtype=h.dtype, device=h.device)
    it = 0
    while it < ITER_MAX and not bool(done.all()):
        h_peak = torch.maximum(h_peak, h.max())
        rho, invom, zeta = _density_sums(kern, ndim, h, drsqd, m_j, mask)
        h_target = h_fac * (m / torch.clamp_min(rho, 1e-300)) ** invndim
        ok = (rho > 0.0) & (h > 0.0)
        conv = ok & (torch.abs(h - h_target) / h < h_converge)
        too_big = (rho < 1e-30) | (h > h_target)
        if it >= ITER_FP:
            hi = torch.where(too_big & ~conv, h, hi)
            lo = torch.where(~too_big & ~conv, h, lo)
        h_new = h_target if it < ITER_FP else 0.5 * (lo + hi)
        h = torch.where(conv | done, h, h_new)
        done = done | conv
        it += 1
    return rho, invom, zeta, done, h_peak


def finish_h(ndim: int, h_fac: float, m: Tensor, rho: Tensor,
             invom: Tensor, zeta: Tensor, done: Tensor) -> DensityResult:
    """h from the final rho, the grad-h Omega and zeta corrections."""
    invndim = 1.0 / ndim
    rho_safe = torch.clamp_min(rho, 1e-300)
    h_final = torch.clamp_min(h_fac * (m / rho_safe) ** invndim, 0.0)
    invh = 1.0 / h_final
    dh_drho = -invndim * h_final / rho_safe
    invomega = 1.0 / (1.0 - dh_drho * invom)
    return DensityResult(h=h_final, rho=rho, invomega=invomega,
                         zeta=dh_drho * zeta * invomega,
                         hfactor=invh ** (ndim + 1), converged=done)


def compute_h(kern, ndim: int, h_fac: float, h_converge: float, m: Tensor,
              h_init: Tensor, drsqd: Tensor, m_j: Tensor,
              mask: Optional[Tensor] = None,
              hmax: float = 1.0e30,
              active: Optional[Tensor] = None) -> DensityResult:
    """Converge h and return the density sums (batch ComputeH): m,
    h_init (n,); drsqd, m_j, mask (n, K); rows outside `active` (n,)
    start done."""
    sums = iterate_h(kern, ndim, h_fac, h_converge, m, h_init, drsqd, m_j,
                     mask, hmax, active)
    return finish_h(ndim, h_fac, m, *sums[:4])
