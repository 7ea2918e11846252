"""Meshless finite-volume (Gizmo-style MFV) operators as plain torch.

Counterpart of ``gandalf_tpu/ops/mfv.py`` for the MUSCL global-timestep
path: conserved <-> primitive variables, the least-squares gradient
sums and their finish (B matrix, condition-number guard with the SPH
gradient fallback, cell limiter alphas), the per-neighbour cell limiters
(tvdscalar, springel2009), the pairwise Gizmo face limiter, the
primitive time derivative, the HLLC and exact Riemann solvers (with and
without zero mass flux), the face fluxes of MUSCL and RK2 (Heun) under
every slope limiter, with moving or static particles, and the gravity
source terms, plus the O(N^2) smoothed MFV gravity used as an oracle.

The functions work on the same (N, K) neighbour views as the JAX
package's, with the same formulas and guards: ``1e-300`` floors round to
0 in float32 there as here.  Primitive vector W = (v_0..v_{ndim-1}, rho,
p); conserved Q = (m v, m, E_tot).  The structured-grid drivers and the CUDA
kernels K10-K12 are in ``ops/mfv_grid27.py``; ``csrc/mfv.cuh`` holds the
same pair arithmetic in CUDA C++.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels.smoothing import SmoothingKernel

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _dist2(dr: Tensor) -> Tensor:
    """|dr|^2 over the last axis, summed in axis order with one rounding
    a term, as the CUDA kernels sum it: torch.sum on the card pairs the
    terms otherwise for some pairs, and in float32 that moves a pair at
    the edge of kernrange h or at a tabulated kernel's grid point to the
    other side."""
    d2 = dr[..., 0] * dr[..., 0]
    for k in range(1, dr.shape[-1]):
        d2 = d2 + dr[..., k] * dr[..., k]
    return d2


def _invert_small(E: Tensor, ndim: int) -> Tensor:
    """Closed-form inverse of (..., ndim, ndim) matrices for ndim 1/2/3."""
    if ndim == 1:
        return 1.0 / torch.where(E == 0.0, 1e-300, E)
    if ndim == 2:
        a, b = E[..., 0, 0], E[..., 0, 1]
        c, d = E[..., 1, 0], E[..., 1, 1]
        det = a * d - b * c
        det = torch.where(torch.abs(det) < 1e-300, 1e-300, det)
        inv = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-c, a], -1)], -2)
        return inv / det[..., None, None]
    m = E
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    det = torch.where(torch.abs(det) < 1e-300, 1e-300, det)
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    adj = torch.stack([torch.stack([c00, c10, c20], -1),
                       torch.stack([c01, c11, c21], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    return adj / det[..., None, None]


class GradientResult(NamedTuple):
    B: Tensor            # (N, ndim, ndim) inverse least-squares matrix
    grad: Tensor         # (N, nvar, ndim) primitive gradients
    alpha_slope: Tensor  # (N, nvar) cell-limiter alphas
    vsig_max: Tensor     # (N,)
    bad: Tensor          # (N,) bool: ill-conditioned E (SPH fallback)


class GradAccum(NamedTuple):
    """Per-particle running sums of the gradient pass, accumulable over
    any partition of the neighbour set."""

    E: Tensor          # (N, ndim, ndim) least-squares moment matrix
    grad_tmp: Tensor   # (N, nvar, ndim)
    grad_sph: Tensor   # (N, nvar, ndim) SPH-gradient fallback sum
    vsig_max: Tensor   # (N,)
    Wmax: Tensor       # (N, nvar) over kernel-range neighbours
    Wmin: Tensor       # (N, nvar)
    drmax_sqd: Tensor  # (N,)


def gradient_init(N: int, ndim: int, dtype, device="cpu") -> GradAccum:
    nvar = ndim + 2
    big = 1e30
    kw = dict(dtype=dtype, device=device)
    return GradAccum(
        E=torch.zeros((N, ndim, ndim), **kw),
        grad_tmp=torch.zeros((N, nvar, ndim), **kw),
        grad_sph=torch.zeros((N, nvar, ndim), **kw),
        vsig_max=torch.zeros((N,), **kw),
        Wmax=torch.full((N, nvar), -big, **kw),
        Wmin=torch.full((N, nvar), big, **kw),
        drmax_sqd=torch.zeros((N,), **kw))


def gradient_terms(kern: SmoothingKernel, ndim: int, h: Tensor,
                   ndens: Tensor, Wprim: Tensor, sound: Tensor, dr: Tensor,
                   W_j: Tensor, sound_j: Tensor, v_j: Tensor,
                   mask: Optional[Tensor]) -> GradAccum:
    """The pair terms of one (N, K) block of neighbours, before the
    reduction over K: E (N, K, nd, nd), grad_tmp and grad_sph (N, K,
    nvar, nd), and vsig, W_j and d^2 where the pair counts for the
    kernel-range statistics (-inf / +inf-like fills elsewhere, as
    gradient_accumulate masks them)."""
    drsqd = _dist2(dr)
    valid = drsqd > 0.0
    if mask is not None:
        valid = valid & mask
    invh = 1.0 / h
    invhsqd = invh * invh
    w = (invh[:, None] ** ndim) * kern.w0_s2(drsqd * invhsqd[:, None]) \
        / torch.clamp_min(ndens, 1e-300)[:, None]
    w = torch.where(valid, w, 0.0)
    E = w[..., None, None] * dr[..., :, None] * dr[..., None, :]
    dW = W_j - Wprim[:, None, :]
    dW = torch.where(valid[..., None], dW, 0.0)
    grad_tmp = w[..., None, None] * dW[..., :, None] * dr[..., None, :]
    drmag = torch.sqrt(torch.where(valid, drsqd, 1.0))
    w1 = (invh[:, None] ** (ndim + 1)) * kern.w1(drmag * invh[:, None]) \
        / torch.clamp_min(ndens, 1e-300)[:, None]
    w1 = torch.where(valid, w1, 0.0)
    unit = dr / drmag[..., None]
    grad_sph = -(w1[..., None, None] * dW[..., :, None]
                 * unit[..., None, :])
    near = valid & (drsqd <= (kern.kernrange * h[:, None]) ** 2)
    dv = v_j - Wprim[:, None, :ndim]
    dvdr = torch.sum(dv * dr, dim=-1)
    vsig = sound[:, None] + sound_j - torch.clamp_max(
        dvdr / (torch.sqrt(torch.where(valid, drsqd, 1.0)) + 1e-30), 0.0)
    big = 1e30
    return GradAccum(
        E=E, grad_tmp=grad_tmp, grad_sph=grad_sph,
        vsig_max=torch.where(near, vsig, 0.0),
        Wmax=torch.where(near[..., None], W_j, -big),
        Wmin=torch.where(near[..., None], W_j, big),
        drmax_sqd=torch.where(near, drsqd, 0.0))


def gradient_accumulate(kern: SmoothingKernel, ndim: int, acc: GradAccum,
                        h: Tensor, ndens: Tensor, Wprim: Tensor,
                        sound: Tensor, dr: Tensor, W_j: Tensor,
                        sound_j: Tensor, v_j: Tensor,
                        mask: Optional[Tensor]) -> GradAccum:
    """Accumulate one block of neighbours into the gradient sums
    (MfvCommon::ComputeGradients inner loop)."""
    t = gradient_terms(kern, ndim, h, ndens, Wprim, sound, dr, W_j,
                       sound_j, v_j, mask)
    return GradAccum(
        E=acc.E + t.E.sum(1), grad_tmp=acc.grad_tmp + t.grad_tmp.sum(1),
        grad_sph=acc.grad_sph + t.grad_sph.sum(1),
        vsig_max=torch.maximum(acc.vsig_max, t.vsig_max.amax(1)),
        Wmax=torch.maximum(acc.Wmax, t.Wmax.amax(1)),
        Wmin=torch.minimum(acc.Wmin, t.Wmin.amin(1)),
        drmax_sqd=torch.maximum(acc.drmax_sqd, t.drmax_sqd.amax(1)))


def gradient_finalize(ndim: int, acc: GradAccum, h: Tensor, Wprim: Tensor,
                      sound: Tensor) -> GradientResult:
    """Invert the moment matrix, apply the condition-number fallback and
    the cell limiter (MfvCommon::ComputeGradients tail +
    ScalarLimiter::CellLimiter)."""
    E = acc.E
    if ndim == 1:
        B = _invert_small(E[..., 0, 0], 1)[..., None, None]
    else:
        B = _invert_small(E, ndim)
    grad_ls = torch.einsum("nij,nvj->nvi", B, acc.grad_tmp)
    modE = torch.sum(E * E, dim=(-2, -1))
    modB = torch.sum(B * B, dim=(-2, -1))
    bad = (modE * modB / (ndim * ndim)) >= 1e4
    grad = torch.where(bad[:, None, None], acc.grad_sph, grad_ls)
    vsig_max = torch.maximum(acc.vsig_max, sound)
    Wmax = torch.maximum(acc.Wmax, Wprim)
    Wmin = torch.minimum(acc.Wmin, Wprim)
    drmax = torch.sqrt(acc.drmax_sqd)
    drmax = torch.maximum(drmax, 2.0 * h) * 0.51
    gradmag = torch.sqrt(torch.sum(grad * grad, dim=-1))
    dWlim = drmax[:, None] * gradmag
    dWmax = Wmax - Wprim
    dWmin = Wprim - Wmin
    lim = torch.clamp_min(dWlim, 1e-300)
    alpha = torch.where(
        dWlim != 0.0,
        torch.clamp(torch.minimum(dWmax / lim, dWmin / lim), 0.0, 1.0), 1.0)
    return GradientResult(B=B, grad=grad, alpha_slope=alpha,
                          vsig_max=vsig_max, bad=bad)


# the limiters whose cell alpha takes a second neighbour sweep
SWEEP_LIMITERS = ("tvdscalar", "springel2009")


def limiter_alpha_accumulate(limiter: str, kern: SmoothingKernel, ndim: int,
                             alpha: Tensor, h: Tensor, Wprim: Tensor,
                             grad: Tensor, dWmax: Tensor, dWmin: Tensor,
                             dr: Tensor, W_j: Tensor,
                             mask: Optional[Tensor]) -> Tensor:
    """The second neighbour sweep of the per-neighbour cell limiters
    (TVDScalarLimiter and Springel2009Limiter::CellLimiter): the running
    min of each variable's alpha over one (N, K) block of neighbours
    within kernrange h_i.  `grad` is the finalised gradient, `dWmax` and
    `dWmin` the signed extrema Wmax - W >= 0 and Wmin - W <= 0
    (springel2009 only); 0.51 is the reference's edge factor.  tvdscalar
    clips its ratio to [0, 1]; springel2009's is bounded only by the
    running min from alpha.  The 1e-300 of the live test is 0 in
    float32."""
    drsqd = _dist2(dr)
    valid = drsqd > 0.0
    if mask is not None:
        valid = valid & mask
    near = valid & (drsqd <= (kern.kernrange * h[:, None]) ** 2)
    dW = 0.51 * torch.einsum("nvi,nki->nkv", grad, dr)
    live = torch.abs(dW) > 1e-300
    dW_safe = torch.where(live, dW, 1.0)
    if limiter == "tvdscalar":
        ratio = torch.clamp((W_j - Wprim[:, None, :]) / dW_safe, 0.0, 1.0)
    elif limiter == "springel2009":
        ratio = torch.where(dW > 0.0, dWmax[:, None, :] / dW_safe,
                            dWmin[:, None, :] / dW_safe)
    else:
        raise ValueError(f"unknown per-neighbour limiter '{limiter}'")
    ratio = torch.where(near[..., None] & live, ratio, 1.0)
    return torch.minimum(alpha, torch.amin(ratio, dim=1))


# ---------------------------------------------------------------------------
# Gizmo pairwise face limiter
# ---------------------------------------------------------------------------

def _gizmo_clamp(Wi: Tensor, Wj: Tensor, dW0: Tensor, fmag: Tensor,
                 drmag: Tensor) -> Tensor:
    """phimid - Wi of GizmoLimiter::ComputeLimitedSlopes: the
    reconstruction Wi + dW0 held within the (Wi, Wj) bracket widened by
    psi1 |Wi - Wj| and around the linear interpolant by psi2 |Wi - Wj|.
    The sign tests are sign(x) with sign(0) = 0."""
    psi1, psi2 = 0.5, 0.375
    delta1 = psi1 * torch.abs(Wi - Wj)
    delta2 = psi2 * torch.abs(Wi - Wj)
    phimin = torch.minimum(Wi, Wj)
    phimax = torch.maximum(Wi, Wj)
    ratio = (fmag / torch.clamp_min(drmag, 1e-300))[..., None]
    phibar = Wi + (Wj - Wi) * ratio
    phimid0 = Wi + dW0
    phiminus = torch.where(
        torch.sign(phimin - delta1) == torch.sign(phimin), phimin - delta1,
        phimin / (1.0 + delta1 / torch.clamp_min(torch.abs(phimin),
                                                 1e-300)))
    phiplus = torch.where(
        torch.sign(phimax + delta1) == torch.sign(phimax), phimax + delta1,
        phimax / (1.0 + delta1 / torch.clamp_min(torch.abs(phimax),
                                                 1e-300)))
    phimid = torch.where(
        Wi < Wj,
        torch.maximum(phiminus, torch.minimum(phibar + delta2, phimid0)),
        torch.where(Wi > Wj,
                    torch.minimum(phiplus,
                                  torch.maximum(phibar - delta2, phimid0)),
                    Wi))
    return phimid - Wi


def gizmo_limited_dW(Wprim_i: Tensor, Wprim_j: Tensor, grad_i: Tensor,
                     alpha_i: Tensor, draux: Tensor, dr_ij: Tensor
                     ) -> Tuple[Tensor, Tensor]:
    """GizmoLimiter::ComputeLimitedSlopes over (N, K, nvar).  draux: face
    - r_i displacement (N, K, ndim); dr_ij: r_j - r_i.  Returns (dW,
    gradW) with gradW = alpha * grad broadcast to (N, K, nvar, nd)."""
    gradW = alpha_i[:, None, :, None] * grad_i[:, None, :, :]
    dW0 = torch.einsum("nkvi,nki->nkv", gradW, draux)
    drmag = torch.sqrt(torch.sum(dr_ij * dr_ij, dim=-1))
    fmag = torch.sqrt(torch.sum(draux * draux, dim=-1))
    return _gizmo_clamp(Wprim_i[:, None, :], Wprim_j, dW0, fmag,
                        drmag), gradW


def _gizmo_limited_dW_j(Wprim_j: Tensor, Wprim_i: Tensor, grad_j: Tensor,
                        alpha_j: Tensor, draux: Tensor, dr_ji: Tensor
                        ) -> Tuple[Tensor, Tensor]:
    """The Gizmo limiter from the neighbour's side ((N, K, ...) i-major
    layout)."""
    gradW = alpha_j[..., None] * grad_j
    dW0 = torch.einsum("nkvi,nki->nkv", gradW, draux)
    drmag = torch.sqrt(torch.sum(dr_ji * dr_ji, dim=-1))
    fmag = torch.sqrt(torch.sum(draux * draux, dim=-1))
    return _gizmo_clamp(Wprim_j, Wprim_i[:, None, :], dW0, fmag,
                        drmag), gradW


def _primitive_time_derivative(W: Tensor, gradW: Tensor, sound: Tensor,
                               ndim: int) -> Tensor:
    """FV::CalculatePrimitiveTimeDerivative over (..., nvar)."""
    irho, ipress = ndim, ndim + 1
    divV = torch.diagonal(gradW[..., :ndim, :], dim1=-2, dim2=-1).sum(-1)
    v = W[..., :ndim]
    adv = torch.einsum("...i,...vi->...v", v, gradW)
    rho = W[..., irho]
    vel = -adv[..., :ndim] - gradW[..., ipress, :] / rho[..., None]
    drho = -adv[..., irho] + (-rho * divV)
    dpress = -adv[..., ipress] + (-rho * sound * sound * divV)
    return torch.cat([vel, drho[..., None], dpress[..., None]], -1)


# ---------------------------------------------------------------------------
# HLLC Riemann solver
# ---------------------------------------------------------------------------

def hllc_flux(Wl: Tensor, Wr: Tensor, n: Tensor, vface: Tensor,
              gamma: float, zero_mass_flux: bool) -> Tensor:
    """HLLC flux along face normal n (HllcRiemannSolver.solve).

    Wl/Wr: (..., nvar) face-frame primitives; n, vface: (..., ndim).
    Returns the lab-frame flux (..., nvar) along n.  With zero mass flux
    the solution is boosted into the contact frame and keeps the
    lab-frame total energies, as the reference does."""
    ndim = n.shape[-1]
    irho, iE = ndim, ndim + 1

    def state(W):
        rho = W[..., irho]
        press = W[..., iE]
        v = W[..., :ndim]
        vline = torch.sum(v * n, dim=-1)
        cs = torch.sqrt(gamma * press / rho)
        e = 0.5 * rho * torch.sum(v * v, -1) + press / (gamma - 1.0)
        return rho, press, v, vline, cs, e

    rl, pl, vl_, vll, cl, el = state(Wl)
    rr, pr, vr_, vlr, cr, er = state(Wr)

    # Roe-averaged wave-speed estimates (HLL_Speeds)
    R = torch.sqrt(rr / rl)
    fl = 1.0 / (1.0 + R)
    fr = 1.0 - fl
    v_av = fl * vll + fr * vlr
    dv2 = torch.sum((vl_ - vr_) ** 2, dim=-1)
    gam_eff = torch.clamp_min((rl * cl * cl + rr * cr * cr) / (pl + pr),
                              1.0)
    cs_av = torch.sqrt(fl * cl * cl + fr * cr * cr
                       + 0.5 * fl * fr * (gam_eff - 1.0) * dv2)
    Smin = torch.minimum(vll - cl, v_av - cs_av)
    Smax = torch.maximum(vlr + cr, v_av + cs_av)

    # central wave speed (contact)
    dml = rl * (vll - Smin)
    dmr = rr * (vlr - Smax)
    Pl_ = vll * dml + pl
    Pr_ = vlr * dmr + pr
    vm = (Pr_ - Pl_) / torch.where(torch.abs(dmr - dml) < 1e-300, 1e-300,
                                   dmr - dml)
    if zero_mass_flux:
        Smin = Smin - vm
        Smax = Smax - vm
        vll = vll - vm
        vlr = vlr - vm
        vl_ = vl_ - vm[..., None] * n
        vr_ = vr_ - vm[..., None] * n
        vface = vface + vm[..., None] * n
        vm = torch.zeros_like(vm)

    def hydro_flux(rho, press, v, vline, e):
        f_v = rho[..., None] * vline[..., None] * v + press[..., None] * n
        f_rho = rho * vline
        f_E = (press + e) * vline
        return torch.cat([f_v, f_rho[..., None], f_E[..., None]], -1)

    def rh_flux(rho, press, v, vline, e, vwave):
        """Rankine-Hugoniot star-state correction (add_RH_flux)."""
        Q = torch.cat([rho[..., None] * v, rho[..., None], e[..., None]],
                      -1)
        dms = rho * (vline - vwave)
        Qs_rho = rho * (vwave - vline) / torch.where(
            torch.abs(vwave - vm) < 1e-300, 1e-300, vwave - vm)
        Qs_E = Qs_rho * (e / rho + (vm - vline)
                         * (vm - press / torch.where(
                             torch.abs(dms) < 1e-300, 1e-300, dms)))
        Qs_v = Qs_rho[..., None] * (v + (vm - vline)[..., None] * n)
        Qs = torch.cat([Qs_v, Qs_rho[..., None], Qs_E[..., None]], -1)
        return vwave[..., None] * (Qs - Q)

    f_l = hydro_flux(rl, pl, vl_, vll, el)
    f_r = hydro_flux(rr, pr, vr_, vlr, er)
    f_star_l = f_l + rh_flux(rl, pl, vl_, vll, el, Smin)
    f_star_r = f_r + rh_flux(rr, pr, vr_, vlr, er, Smax)
    flux = torch.where((Smax <= 0.0)[..., None], f_r,
                       torch.where((Smin >= 0.0)[..., None], f_l,
                                   torch.where((vm > 0.0)[..., None],
                                               f_star_l, f_star_r)))
    f_v, f_rho, f_E = flux[..., :ndim], flux[..., irho], flux[..., iE]
    if zero_mass_flux:
        f_rho = torch.zeros_like(f_rho)
    # back to the lab frame (solve():126-134)
    fE = f_E + torch.sum(f_v * vface, -1) \
        + f_rho * 0.5 * torch.sum(vface * vface, -1)
    fv = f_v + f_rho[..., None] * vface
    return torch.cat([fv, f_rho[..., None], fE[..., None]], -1)


# ---------------------------------------------------------------------------
# exact Riemann solver (Toro 1999, ch. 4), every branch evaluated
# ---------------------------------------------------------------------------

NEWTON_STEPS = 10


def _pressure_fn(p: Tensor, pk: Tensor, dk: Tensor, ck: Tensor,
                 gamma: float):
    """f_K(p) and f_K'(p), the shock form where p > p_K, else the
    rarefaction form (ExactRiemannSolver::Prefun); one pow per side."""
    ak = 2.0 / ((gamma + 1.0) * dk)
    bk = (gamma - 1.0) / (gamma + 1.0) * pk
    sq = torch.sqrt(ak / (p + bk))
    f_s = (p - pk) * sq
    fp_s = sq * (1.0 - 0.5 * (p - pk) / (p + bk))
    g1 = (gamma - 1.0) / (2.0 * gamma)
    pr = torch.clamp_min(p / pk, 1e-30)
    q = pr ** g1
    f_r = 2.0 * ck / (gamma - 1.0) * (q - 1.0)
    fp_r = q / (pr * dk * ck)
    shock = p > pk
    return torch.where(shock, f_s, f_r), torch.where(shock, fp_s, fp_r)


def exact_star_region(dl, ul, pl, cl, dr, ur, pr, cr, gamma: float,
                      n_iter: int = NEWTON_STEPS):
    """(p*, u*) by exactly `n_iter` Newton steps from Toro's adaptive
    guess (ExactRiemannSolver::ComputeStarRegion), no convergence test.
    Vacuum gives (0, 0)."""
    g1 = (gamma - 1.0) / (2.0 * gamma)
    cup = 0.25 * (dl + dr) * (cl + cr)
    ppv = torch.clamp_min(0.5 * (pl + pr) + 0.5 * (ul - ur) * cup, 0.0)
    pmin = torch.minimum(pl, pr)
    pmax = torch.maximum(pl, pr)
    pq = torch.clamp_min(pl / pr, 1e-30) ** g1
    um = (pq * ul / cl + ur / cr + 2.0 / (gamma - 1.0) * (pq - 1.0)) \
        / (pq / cl + 1.0 / cr)
    ptl = torch.clamp_min(1.0 + 0.5 * (gamma - 1.0) * (ul - um) / cl, 1e-30)
    ptr = torch.clamp_min(1.0 + 0.5 * (gamma - 1.0) * (um - ur) / cr, 1e-30)
    p_tr = 0.5 * (pl * ptl ** (1.0 / g1) + pr * ptr ** (1.0 / g1))
    gel = torch.sqrt((2.0 / ((gamma + 1.0) * dl))
                     / ((gamma - 1.0) / (gamma + 1.0) * pl + ppv))
    ger = torch.sqrt((2.0 / ((gamma + 1.0) * dr))
                     / ((gamma - 1.0) / (gamma + 1.0) * pr + ppv))
    p_ts = (gel * pl + ger * pr - (ur - ul)) / (gel + ger)
    p0 = torch.where((pmax / pmin <= 2.0) & (pmin <= ppv) & (ppv <= pmax),
                     ppv, torch.where(ppv < pmin, p_tr, p_ts))
    p = torch.clamp_min(p0, 1e-30)
    for _ in range(n_iter):
        fl, flp = _pressure_fn(p, pl, dl, cl, gamma)
        fr, frp = _pressure_fn(p, pr, dr, cr, gamma)
        p = torch.clamp_min(p - (fl + fr + ur - ul) / (flp + frp), 1e-30)
    fl, _ = _pressure_fn(p, pl, dl, cl, gamma)
    fr, _ = _pressure_fn(p, pr, dr, cr, gamma)
    u = 0.5 * (ul + ur) + 0.5 * (fr - fl)
    vacuum = (2.0 / (gamma - 1.0)) * (cl + cr) <= (ur - ul)
    return torch.where(vacuum, 0.0, p), torch.where(vacuum, 0.0, u)


def _sample_zero(pstar, ustar, dl, ul, pl, cl, dr, ur, pr, cr,
                 gamma: float):
    """(rho, u, p) of the self-similar solution at x/t = 0
    (ExactRiemannSolver::SampleExactSolution), both sides and both wave
    forms evaluated, then selected."""
    g7 = 0.5 * (gamma - 1.0)
    gp = (gamma + 1.0) / (2.0 * gamma)
    gm = (gamma - 1.0) / (2.0 * gamma)
    g6 = (gamma - 1.0) / (gamma + 1.0)

    def side(dk, uk, pk, ck, sign):
        un = sign * uk
        ratio = torch.clamp_min(pstar / pk, 1e-30)
        sK = un - ck * torch.sqrt(gp * ratio + gm)
        d_shock = dk * (ratio + g6) / (g6 * ratio + 1.0)
        shK = un - ck
        cmK = ck * ratio ** gm
        stK = sign * ustar - cmK
        cfan = (2.0 / (gamma + 1.0)) * (ck + g7 * un)
        u_fan = (2.0 / (gamma + 1.0)) * (ck + g7 * un)
        d_fan = dk * torch.clamp_min(cfan / ck, 0.0) ** (2.0 / (gamma - 1.0))
        p_fan = pk * torch.clamp_min(cfan / ck, 0.0) ** (
            2.0 * gamma / (gamma - 1.0))
        is_shock = pstar > pk
        outer = torch.where(is_shock, sK >= 0.0, shK >= 0.0)
        in_star = torch.where(is_shock, sK < 0.0, stK <= 0.0)
        d_star = torch.where(is_shock, d_shock, dk * ratio ** (1.0 / gamma))
        d = torch.where(outer, dk, torch.where(in_star, d_star, d_fan))
        u = torch.where(outer, un, torch.where(in_star, sign * ustar, u_fan))
        p = torch.where(outer, pk, torch.where(in_star, pstar, p_fan))
        return d, sign * u, p

    dl0, ul0, pl0 = side(dl, ul, pl, cl, 1.0)
    dr0, ur0, pr0 = side(dr, ur, pr, cr, -1.0)
    on_left = ustar >= 0.0
    return (torch.where(on_left, dl0, dr0), torch.where(on_left, ul0, ur0),
            torch.where(on_left, pl0, pr0))


def exact_flux(Wl: Tensor, Wr: Tensor, n: Tensor, vface: Tensor,
               gamma: float, zero_mass_flux: bool) -> Tensor:
    """The exact Godunov flux along n (ExactRiemannSolver::ComputeFluxes),
    with hllc_flux's interface: face-frame primitives in, the lab-frame
    flux along n out; the transverse velocity from the upwind side, zero
    at vacuum (p* = 0)."""
    ndim = n.shape[-1]
    irho, iE = ndim, ndim + 1
    rl, pl = Wl[..., irho], Wl[..., iE]
    rr, pr = Wr[..., irho], Wr[..., iE]
    vl, vr = Wl[..., :ndim], Wr[..., :ndim]
    vll = torch.sum(vl * n, dim=-1)
    vlr = torch.sum(vr * n, dim=-1)
    cl = torch.sqrt(gamma * pl / rl)
    cr = torch.sqrt(gamma * pr / rr)
    pstar, ustar = exact_star_region(rl, vll, pl, cl, rr, vlr, pr, cr, gamma)
    d0, u0, p0 = _sample_zero(pstar, ustar, rl, vll, pl, cl, rr, vlr, pr, cr,
                              gamma)
    vt = torch.where((u0 > 0.0)[..., None], vl - vll[..., None] * n,
                     vr - vlr[..., None] * n)
    if zero_mass_flux:
        vface = vface + u0[..., None] * n
        un = torch.zeros_like(u0)
    else:
        un = u0
    W_v = vt + un[..., None] * n + vface
    etot = 0.5 * torch.sum(W_v * W_v, -1) \
        + p0 / ((gamma - 1.0) * torch.clamp_min(d0, 1e-30))
    f_rho = d0 * un
    f_v = f_rho[..., None] * W_v + p0[..., None] * n
    f_E = d0 * etot * un + p0 * torch.sum(W_v * n, -1)
    flux = torch.cat([f_v, f_rho[..., None], f_E[..., None]], -1)
    return torch.where((pstar > 0.0)[..., None], flux, 0.0)


# ---------------------------------------------------------------------------
# Godunov flux accumulation (MUSCL and RK2)
# ---------------------------------------------------------------------------

class FluxResult(NamedTuple):
    dQdt: Tensor       # (N, nvar) conserved-variable flux rate
    rdmdt_dot: Tensor  # (N, ndim) rate of r*dm/dt bookkeeping
    dQ: Optional[Tensor] = None      # block mode: the committed exchange
    rdmdt: Optional[Tensor] = None   # block mode: its r*dm moment


RIEMANN_SOLVERS = ("hllc", "exact")
SLOPE_LIMITERS = ("gizmo", "scalar", "null", "zeroslope", "tvdscalar",
                  "springel2009")
TIME_SCHEMES = ("muscl", "rk2")
# the limiters that extrapolate with the cell alphas and no face clamp
CELL_LIMITERS = ("null", "scalar", "tvdscalar", "springel2009")


@dataclasses.dataclass(frozen=True)
class MfvConfig:
    gamma: float
    zero_mass_flux: bool = True
    static_particles: bool = False
    riemann: str = "hllc"
    slope_limiter: str = "gizmo"
    time_scheme: str = "muscl"


def check_config(cfg: MfvConfig) -> None:
    """Refuse an option name the JAX package does not know."""
    for what, value, known in (("riemann_solver", cfg.riemann,
                                RIEMANN_SOLVERS),
                               ("slope_limiter", cfg.slope_limiter,
                                SLOPE_LIMITERS),
                               ("time scheme", cfg.time_scheme,
                                TIME_SCHEMES)):
        if value not in known:
            raise ValueError(f"unrecognised {what} {value!r}: one of "
                             f"{known}")


def _sanitise(W: Tensor, ndim: int) -> Tensor:
    """The positivity floors 1e-15 of a face state's rho and p."""
    return torch.cat([W[..., :ndim], torch.clamp_min(W[..., ndim:], 1e-15)],
                     -1)


def compute_godunov_fluxes(kern: SmoothingKernel, cfg: MfvConfig, ndim: int,
                           dt, h: Tensor, ndens: Tensor, Wprim: Tensor,
                           sound: Tensor, a0: Tensor, B: Tensor,
                           grad: Tensor, alpha_slope: Tensor, bad: Tensor,
                           dr: Tensor, nb: dict,
                           mask: Optional[Tensor],
                           dt_pair: Optional[Tensor] = None,
                           pair_on: Optional[Tensor] = None) -> FluxResult:
    """Pairwise face fluxes accumulated per particle
    (MfvMuscl::ComputeGodunovFlux, MfvRungeKutta::ComputeGodunovFlux),
    every pair evaluated from both sides.  The face states take the
    slope limiter's reconstruction: the Gizmo clamp, the cell alphas
    (null: alpha = 1) or none (zeroslope); the face moves with the mean
    velocity, or not with static particles.  MUSCL predicts each state
    half a step; RK2 averages the fluxes of the states as they are and
    of the states advanced a full dt, each floored alone.

    nb keys (all (N, K, ...)): h, ndens, Wprim, sound, a0, B, grad,
    alpha_slope, bad.  `dt` is a 0-d tensor or a float.

    Block-timestep mode (MUSCL only): `dt_pair` (N, K), min(dt_own_i,
    dt_own_j), replaces dt in the half step, and the result also carries
    the committed exchange dQ = -sum_j [pair_on] f dt_pair and its moment
    rdmdt = sum_j dr [pair_on] f_rho dt_pair; `pair_on` (N, K) marks the
    pairs whose deeper member starts a step this tick."""
    check_config(cfg)
    if dt_pair is not None:
        if cfg.time_scheme != "muscl":
            raise ValueError("block mode takes the MUSCL time scheme")
        dt = dt_pair[..., None]
    irho = ndim
    drsqd = _dist2(dr)
    valid = drsqd > 0.0
    if mask is not None:
        valid = valid & mask

    invh_i = 1.0 / h
    vol_i = 1.0 / torch.clamp_min(ndens, 1e-300)
    invh_j = 1.0 / nb["h"]
    vol_j = 1.0 / torch.clamp_min(nb["ndens"], 1e-300)

    # psi-tilde face vectors (ComputeGodunovFlux:110-137)
    w0_i = (invh_i[:, None] ** ndim) * kern.w0_s2(
        drsqd * invh_i[:, None] ** 2)
    w0_j = (invh_j ** ndim) * kern.w0_s2(drsqd * invh_j ** 2)
    psi_j_ls = torch.einsum("nij,nkj->nki", B, dr) \
        * (w0_i * vol_i[:, None])[..., None]
    drmag = torch.sqrt(torch.where(valid, drsqd, 1.0))
    unit = dr / drmag[..., None]
    w1_i = (invh_i[:, None] ** (ndim + 1)) * kern.w1(drmag * invh_i[:, None])
    w1_j = (invh_j ** (ndim + 1)) * kern.w1(drmag * invh_j)
    psi_j_sph = -unit * (w1_i * vol_i[:, None])[..., None]
    psi_j = torch.where(bad[:, None, None], psi_j_sph, psi_j_ls)
    psi_i_ls = -torch.einsum("nkij,nkj->nki", nb["B"], dr) \
        * (w0_j * vol_j)[..., None]
    psi_i_sph = unit * (w1_j * vol_j)[..., None]
    psi_i = torch.where(nb["bad"][..., None], psi_i_sph, psi_i_ls)

    Aij = vol_i[:, None, None] * psi_j - vol_j[..., None] * psi_i
    Amag = torch.sqrt(torch.sum(Aij * Aij, dim=-1))
    face_ok = valid & (Amag > 0.0)
    Aunit = Aij / torch.clamp_min(Amag, 1e-300)[..., None]

    v_i = Wprim[:, :ndim]
    v_j = nb["Wprim"][..., :ndim]
    if cfg.static_particles:
        vface = torch.zeros_like(v_j)
    else:
        vface = 0.5 * (v_i[:, None, :] + v_j)
    half_dr = 0.5 * dr
    ones = torch.ones_like(Amag)[..., None]
    limiter = cfg.slope_limiter

    def reconstruct(W, Wo, g, alpha, draux, dr_own, own_row):
        """(W + dW, gradW) of one side; `own_row` broadcasts the target's
        (N, ...) fields over K."""
        if limiter == "zeroslope":
            gradW = torch.zeros_like(g)
            return W + 0.0 * ones, (gradW[:, None] if own_row else gradW)
        if limiter in CELL_LIMITERS:
            alph = torch.ones_like(alpha) if limiter == "null" else alpha
            gradW = alph[..., None] * g
            if own_row:
                gradW = gradW[:, None]
            dW = torch.einsum("nkvi,nki->nkv",
                              gradW * ones[..., None], draux)
            return W + dW, gradW
        if own_row:
            dW, gradW = gizmo_limited_dW(W[:, 0], Wo, g, alpha, draux,
                                         dr_own)
        else:
            dW, gradW = _gizmo_limited_dW_j(W, Wo, g, alpha, draux, dr_own)
        return W + dW, gradW

    def face_state(Wf, gradW, snd, acc):
        """The face-frame state and its primitive time derivative."""
        Wf = torch.cat([Wf[..., :ndim] - vface, Wf[..., ndim:]], -1)
        Wdot = _primitive_time_derivative(Wf, gradW, snd, ndim)
        Wdot = torch.cat([Wdot[..., :ndim] + acc, Wdot[..., ndim:]], -1)
        return Wf, Wdot

    Wl, gradW_i = reconstruct(Wprim[:, None, :], nb["Wprim"], grad,
                              alpha_slope, half_dr, dr, True)
    Wl, Wdot_l = face_state(Wl, gradW_i, sound[:, None], a0[:, None, :])
    Wr, gradW_j = reconstruct(nb["Wprim"], Wprim, nb["grad"],
                              nb["alpha_slope"], -half_dr, -dr, False)
    Wr, Wdot_r = face_state(Wr, gradW_j, nb["sound"], nb["a0"])
    flux_fn = exact_flux if cfg.riemann == "exact" else hllc_flux
    if cfg.time_scheme == "rk2":
        f1 = flux_fn(_sanitise(Wl, ndim), _sanitise(Wr, ndim), Aunit, vface,
                     cfg.gamma, cfg.zero_mass_flux)
        f2 = flux_fn(_sanitise(Wl + Wdot_l * dt, ndim),
                     _sanitise(Wr + Wdot_r * dt, ndim), Aunit, vface,
                     cfg.gamma, cfg.zero_mass_flux)
        flux_line = 0.5 * (f1 + f2)
    else:
        flux_line = flux_fn(_sanitise(Wl + 0.5 * Wdot_l * dt, ndim),
                            _sanitise(Wr + 0.5 * Wdot_r * dt, ndim), Aunit,
                            vface, cfg.gamma, cfg.zero_mass_flux)
    # f_var = (flux_var * n) . Aij = flux_line_var * |Aij|
    f = flux_line * Amag[..., None]
    f = torch.where(face_ok[..., None], f, 0.0)
    dQdt = -torch.sum(f, dim=1)
    rdmdt_dot = torch.sum(dr * f[..., irho, None], dim=1)
    if dt_pair is None:
        return FluxResult(dQdt=dQdt, rdmdt_dot=rdmdt_dot)
    wdt = torch.where(pair_on, dt_pair, 0.0)
    return FluxResult(dQdt=dQdt, rdmdt_dot=rdmdt_dot,
                      dQ=-torch.sum(f * wdt[..., None], dim=1),
                      rdmdt=torch.sum(dr * (f[..., irho] * wdt)[..., None],
                                      dim=1))


# ---------------------------------------------------------------------------
# conserved <-> primitive
# ---------------------------------------------------------------------------

def qcons_from_state(ndim: int, m: Tensor, v: Tensor, u: Tensor) -> Tensor:
    """Q = (m v, m, m(u + v^2/2))  (MeshlessFV Qcons convention)."""
    etot = m * (u + 0.5 * torch.sum(v * v, dim=-1))
    return torch.cat([m[:, None] * v, m[:, None], etot[:, None]], -1)


def state_from_qcons(ndim: int, Q: Tensor, ndens: Tensor):
    """(m, rho, v, u) from Q (MeshlessFV::UpdateArrayVariables), with the
    positivity floor u >= 1e-15."""
    irho, ietot = ndim, ndim + 1
    m = Q[..., irho]
    rho = m * ndens
    v = Q[..., :ndim] / torch.clamp_min(m, 1e-300)[..., None]
    u = (Q[..., ietot] / torch.clamp_min(m, 1e-300)
         - 0.5 * torch.sum(v * v, dim=-1))
    u = torch.clamp_min(u, 1e-15)
    return m, rho, v, u


# ---------------------------------------------------------------------------
# self-gravity
# ---------------------------------------------------------------------------

def mfv_smoothed_gravity(kern: SmoothingKernel, box, r: Tensor, m: Tensor,
                         h: Tensor, zeta: Tensor, hfactor: Tensor,
                         targets: Optional[Tensor] = None):
    """All-pairs kernel-softened MFV self-gravity with the grad-h zeta
    terms (MfvCommon::ComputeSmoothedGravForces), min-imaged along
    periodic dims: (a, gpot) of the rows `targets` (all particles when
    None).  The O(N^2) oracle of the tree's accuracy check."""
    N = r.shape[0]
    rows = torch.arange(N, device=r.device) if targets is None \
        else targets.long()
    dr = box.min_image(r[None, :, :] - r[rows][:, None, :])
    drsqd = torch.sum(dr * dr, dim=-1)
    eye = rows[:, None] == torch.arange(N, device=r.device)[None, :]
    drmag = torch.sqrt(torch.where(eye, 1.0, drsqd))
    inv_drmag = torch.where(eye, 0.0, 1.0 / drmag)
    unit = dr * inv_drmag[..., None]
    invh_i = (1.0 / h[rows])[:, None]
    invh_j = (1.0 / h)[None, :]
    s_i = drmag * invh_i
    s_j = drmag * invh_j
    invm_i = (1.0 / torch.clamp_min(m[rows], 1e-30))[:, None]
    zh = zeta * hfactor
    paux = 0.5 * (m[None, :] * invh_i * invh_i * kern.wgrav(s_i)
                  + m[None, :] * invh_j * invh_j * kern.wgrav(s_j)
                  + invm_i * zh[rows][:, None] * kern.w1(s_i)
                  + invm_i * zh[None, :] * kern.w1(s_j))
    gaux = 0.5 * (invh_i * kern.wpot(s_i) + invh_j * kern.wpot(s_j))
    paux = torch.where(eye, 0.0, paux)
    gaux = torch.where(eye, 0.0, gaux)
    a = torch.sum(paux[..., None] * unit, dim=1)
    gpot = torch.sum(m[None, :] * gaux, dim=1)
    return a, gpot


def gravity_source_terms(ndim: int, dt, Q0: Tensor, Q: Tensor, a0: Tensor,
                         a: Tensor, rdmdt: Tensor) -> Tensor:
    """Gravitational momentum and energy sources added to the conserved
    update (MfvIntegration.cpp:150-170):

      Q_k  += dt/2 (Q0_rho a0_k + Q_rho a_k)
      Q_E  += dt/2 sum_k [a0_k (Q0_k + Q0_rho a0_k dt/2)
                          + a_k (Q_k + Q_rho a_k dt/2)]
              + 1/2 (a0 + a) . rdmdt
    """
    irho, iE = ndim, ndim + 1
    dE = 0.5 * dt * (
        torch.sum(a0 * (Q0[..., :ndim]
                        + 0.5 * Q0[..., irho, None] * a0 * dt), -1)
        + torch.sum(a * (Q[..., :ndim]
                         + 0.5 * Q[..., irho, None] * a * dt), -1))
    dE = dE + 0.5 * torch.sum((a0 + a) * rdmdt, -1)
    dmom = 0.5 * dt * (Q0[..., irho, None] * a0 + Q[..., irho, None] * a)
    return torch.cat([Q[..., :ndim] + dmom, Q[..., irho, None],
                      (Q[..., iE] + dE)[..., None]], -1)
