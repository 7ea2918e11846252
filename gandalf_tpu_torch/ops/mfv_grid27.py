"""Meshless finite-volume passes over the structured 3^ndim-cell grid,
in 1, 2 or 3 dims: the number-density h iteration (K10), the
least-squares gradients with the cell limiter (K11), the per-neighbour
limiter sweep of tvdscalar and springel2009 (K31), the face fluxes
(K12) of MUSCL or RK2 with either Riemann solver and any slope limiter,
with a global timestep or block timesteps, and the conservative
timestep limiter's near (K32) and far (K33) passes.

Counterpart of ``gandalf_tpu/ops/mfv_grid27.py``'s
``density_mfv_grid27``, ``gradients_mfv_grid27`` (both limiter
branches), ``fluxes_mfv_grid27`` (both timestep modes),
``vsig_near_grid27``, ``vsig_cell_aggregates`` and
``vsig_far_from_agg`` (``vsig_far_cells``).  The JAX package
scatters every field into dense (*ncells, K) cell tensors and slices a
ghosted copy over 27 shifts; here particles stay in particle order and
every pass reads K1's slot map ``ids_d`` (*ncells, K) int32 (particle id
per slot, -1 empty, ``ops.active_grid.dense_ids``).  Each target visits
the 3^ndim cells around its own with wrapped indices, and a neighbour's
position is shifted by the box length where the index wrapped, the
images the ghost layers hold; no copies are made.  Outputs are in
particle order.

Each kernel has a plain PyTorch version here, built on the functions of
``ops/mfv.py`` over a list of the pairs within kernel support, and a CUDA
C++ kernel in ``csrc/`` launched through ``_ext``.  A CPU tensor takes the
plain version; a CUDA tensor takes the kernel, or the wrapper raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _ext
from ..kernels.smoothing import SmoothingKernel
from . import mfv as mfv_ops
from . import sph_grid27 as g27
from .active_grid import _row_chunk, gather_active_candidates

Tensor = torch.Tensor

ITER_FP = 30
ITER_MAX = 150


def flux_cols(ndim: int, block: bool = False):
    """The (name, width) columns of K12's table: 15, 26 and 41 columns
    in 1, 2 and 3 dims; block mode adds each particle's own step and its
    start flag (1.0 where it starts a step this tick)."""
    nvar = ndim + 2
    cols = (("h", 1), ("ndens", 1), ("W", nvar), ("sound", 1), ("a0", ndim),
            ("B", ndim * ndim), ("grad", nvar * ndim), ("alpha", nvar),
            ("bad", 1))
    return cols + ((("dt_own", 1), ("start", 1)) if block else ())


def flux_slices(ndim: int, block: bool = False):
    """Column slices of K12's table by name."""
    out, o = {}, 0
    for name, w in flux_cols(ndim, block):
        out[name] = slice(o, o + w)
        o += w
    return out


def _pair_chunk(device) -> int:
    """Pairs per chunk of the plain K11 and K12: their per-pair
    temporaries hold some 150 values each."""
    return 1 << 21 if device.type == "cuda" else 1 << 16


def slot_pairs(spec: g27.Grid27Spec, ids_d: Tensor, r: Tensor, cut2: float,
               exclude_self: bool):
    """Pairs (i, j) over the 3^ndim-cell stencil of the slot map with
    |r_j + shift - r_i|^2 <= cut2, as particle ids i, j (int64), the
    separation r_j + shift - r_i (P, ndim) and d^2 (P,).  `exclude_self`
    drops a particle's pair with itself and coincident pairs (d^2 = 0).
    The order is that of ops.sph_grid27._pair_list."""
    ids = ids_d.reshape(-1).long()
    fill = ids >= 0
    r_d = torch.where(fill[:, None], r[torch.clamp_min(ids, 0)], 0.0)
    shape = tuple(spec.ncells) + (spec.k_cell,)
    row, col, dx, d2 = g27._pair_list(spec,
                                      r_d.reshape(shape + (r.shape[1],)),
                                      fill.reshape(shape), cut2,
                                      exclude_self)
    return ids[row], ids[col], dx, d2


# ---------------------------------------------------------------------------
# K10: number-density h iteration
# ---------------------------------------------------------------------------

class MfvDensity(NamedTuple):
    h: Tensor
    ndens: Tensor
    rho: Tensor
    invomega: Tensor
    zeta: Tensor
    hfactor: Tensor
    overflow: Tensor


def density_sums(kern: SmoothingKernel, spec: g27.Grid27Spec, h_fac: float,
                 h_converge: float, hmax: float, ids_d: Tensor, r: Tensor,
                 m: Tensor, h: Tensor):
    """The number-density iteration of every particle: (ndens, invom,
    zeta) sums at its final h and its converged flag, each (N,).  K10 on
    CUDA tensors."""
    if r.is_cuda:
        return _ext.mfv_density(spec, kern, h_fac, h_converge, hmax, ids_d,
                                r, m, h)
    return density_sums_plain(kern, spec, h_fac, h_converge, hmax, ids_d,
                              r, m, h)


def density_sums_plain(kern: SmoothingKernel, spec: g27.Grid27Spec,
                       h_fac: float, h_converge: float, hmax: float,
                       ids_d: Tensor, r: Tensor, m: Tensor, h: Tensor):
    """Plain version of K10: the lockstep iteration of gandalf_tpu's
    density_mfv_grid27 (h clamped to [1e-6 hmax, hmax]; 30 fixed-point
    steps h = h_fac ndens^(-1/ndim), then bisection up to step 150; a
    converged particle, |h - h(ndens)| < h_converge, keeps its h) over a
    list of the pairs within kernrange*hmax, the farthest any h <= hmax
    reaches.  The particle itself is among its pairs."""
    nd = spec.ndim
    N = r.shape[0]
    cut2 = (kern.kernrange * hmax) ** 2 * (1.0 + 1e-6)
    row, col, _, d2 = slot_pairs(spec, ids_d, r, cut2, False)
    m_j = m[col]

    def pair_sum(x):
        return torch.zeros((N,), dtype=x.dtype,
                           device=x.device).index_add_(0, row, x)

    def sums_at(hh):
        invh = 1.0 / hh
        invhsqd = invh * invh
        ssqd = d2 * invhsqd[row]
        ndens = pair_sum(kern.w0_s2(ssqd))
        invom = pair_sum(kern.womega_s2(ssqd))
        zeta = pair_sum(m_j * kern.wzeta_s2(ssqd))
        hfac = invh ** nd
        return ndens * hfac, invom * hfac * invh, zeta * invhsqd

    hh = torch.clamp(h, 1e-6 * hmax, hmax)
    lo = torch.zeros_like(hh)
    hi = torch.full_like(hh, hmax)
    done = torch.zeros((N,), dtype=torch.bool, device=r.device)
    ndens = invom = zeta = torch.zeros_like(hh)
    it = 0
    while it < ITER_MAX and not bool(done.all()):
        ndens, invom, zeta = sums_at(hh)
        tgt = h_fac * (1.0 / torch.clamp_min(ndens, 1e-300)) ** (1.0 / nd)
        conv = (ndens > 0.0) & (torch.abs(hh - tgt) < h_converge)
        too_big = (ndens < 1e-30) | (ndens * hh ** nd > h_fac ** nd)
        if it >= ITER_FP:
            hi = torch.where(too_big & ~conv, hh, hi)
            lo = torch.where(~too_big & ~conv, hh, lo)
        h_new = tgt if it < ITER_FP else 0.5 * (lo + hi)
        hh = torch.where(conv | done, hh,
                         torch.clamp(h_new, 1e-6 * hmax, hmax))
        done = done | conv
        it += 1
    return ndens, invom, zeta, done


def density_finish(h_fac: float, hmax: float, m: Tensor, ndens: Tensor,
                   invom: Tensor, zeta: Tensor, done: Tensor,
                   ndim: int = 3) -> MfvDensity:
    """Per-particle finish of the iteration's sums: h from the last
    number density, rho = m ndens, the Omega and zeta corrections on the
    number density, hfactor, and the overflow flag (a particle did not
    converge or its h passed 0.99 hmax)."""
    invndim = 1.0 / ndim
    ndens_safe = torch.clamp_min(ndens, 1e-300)
    h_final = h_fac * (1.0 / ndens_safe) ** invndim
    invh = 1.0 / h_final
    hfactor = invh ** (ndim + 1)
    rho = m * ndens
    invomega = 1.0 / (1.0 + invndim * h_final * invom / ndens_safe)
    zeta_final = -invndim * m * h_final * zeta * invomega / ndens_safe
    overflow = torch.any(~done) | torch.any(h_final > 0.99 * hmax)
    return MfvDensity(h=h_final, ndens=ndens, rho=rho, invomega=invomega,
                      zeta=zeta_final, hfactor=hfactor, overflow=overflow)


# ---------------------------------------------------------------------------
# K11: least-squares gradients and the cell limiter
# ---------------------------------------------------------------------------

class GradExtrema(NamedTuple):
    """The signed neighbour extrema of K11 that K31 reads: Wmax - W >= 0
    and Wmin - W <= 0, each (N, ndim + 2), over the pairs within
    kernrange h_i and the particle itself."""

    dWmax: Tensor
    dWmin: Tensor


def gradients(kern: SmoothingKernel, spec: g27.Grid27Spec, ids_d: Tensor,
              r: Tensor, packed: Tensor,
              limiter: str = "gizmo") -> mfv_ops.GradientResult:
    """B (N, ndim, ndim), grad (N, nvar, ndim), alpha_slope (N, nvar),
    vsig_max (N,) and bad (N,) bool of every particle (nvar = ndim + 2).
    `packed` (N, ndim + 5) holds the columns K11 and K31 read besides r:
    h, the number density, W and the sound speed.  With a per-neighbour
    limiter (tvdscalar, springel2009) the cell alphas are K31's sweep
    from alpha = 1 over K11's gradients and extrema.  K11 and K31 on
    CUDA tensors."""
    sweep = limiter in mfv_ops.SWEEP_LIMITERS
    if r.is_cuda:
        out = _ext.mfv_gradients(spec, kern, ids_d, r, packed,
                                 extrema=sweep)
        res = mfv_ops.GradientResult(*out[:5])
        ext = GradExtrema(*out[5:]) if sweep else None
    else:
        res, ext = gradients_plain(kern, spec, ids_d, r, packed)
    if not sweep:
        return res
    return res._replace(alpha_slope=limiter_sweep(
        kern, spec, limiter, ids_d, r, packed, res.grad, ext))


def gradients_plain(kern: SmoothingKernel, spec: g27.Grid27Spec,
                    ids_d: Tensor, r: Tensor, packed: Tensor):
    """Plain version of K11: ops.mfv's gradient terms over a list of the
    pairs within kernrange * max(h) (every term beyond is zero), reduced
    per target (sums, and maxima and minima for the kernel-range
    statistics), then gradient_finalize.  Returns the GradientResult and
    the GradExtrema."""
    nd = spec.ndim
    nvar = nd + 2
    N, dt, dev = r.shape[0], r.dtype, r.device
    h = torch.clamp_min(packed[:, 0], 1e-30)
    ndens, W, sound = packed[:, 1], packed[:, 2:2 + nvar], packed[:, 2 + nvar]
    cut2 = (kern.kernrange * float(h.max())) ** 2 * (1.0 + 1e-6)
    row, col, dx, _ = slot_pairs(spec, ids_d, r, cut2, True)
    acc = mfv_ops.gradient_init(N, nd, dt, dev)
    E, gt, gs = acc.E.clone(), acc.grad_tmp.clone(), acc.grad_sph.clone()
    vs, wmax, wmin, drm = (acc.vsig_max.clone(), acc.Wmax.clone(),
                           acc.Wmin.clone(), acc.drmax_sqd.clone())
    step = _pair_chunk(dev)
    for c0 in range(0, row.numel(), step):
        i, j = row[c0:c0 + step], col[c0:c0 + step]
        t = mfv_ops.gradient_terms(
            kern, nd, h[i], ndens[i], W[i], sound[i],
            dx[c0:c0 + step][:, None, :], W[j][:, None, :],
            sound[j][:, None], W[j][:, None, :nd], None)
        E.index_add_(0, i, t.E[:, 0])
        gt.index_add_(0, i, t.grad_tmp[:, 0])
        gs.index_add_(0, i, t.grad_sph[:, 0])
        vs.scatter_reduce_(0, i, t.vsig_max[:, 0], "amax")
        iv = i[:, None].expand(-1, nvar)
        wmax.scatter_reduce_(0, iv, t.Wmax[:, 0], "amax")
        wmin.scatter_reduce_(0, iv, t.Wmin[:, 0], "amin")
        drm.scatter_reduce_(0, i, t.drmax_sqd[:, 0], "amax")
    acc = mfv_ops.GradAccum(E=E, grad_tmp=gt, grad_sph=gs, vsig_max=vs,
                            Wmax=wmax, Wmin=wmin, drmax_sqd=drm)
    ext = GradExtrema(dWmax=torch.maximum(wmax, W) - W,
                      dWmin=torch.minimum(wmin, W) - W)
    return mfv_ops.gradient_finalize(nd, acc, h, W, sound), ext


# ---------------------------------------------------------------------------
# K31: the per-neighbour limiter sweep
# ---------------------------------------------------------------------------

def limiter_sweep(kern: SmoothingKernel, spec: g27.Grid27Spec, limiter: str,
                  ids_d: Tensor, r: Tensor, packed: Tensor, grad: Tensor,
                  ext: GradExtrema) -> Tensor:
    """The cell alphas (N, nvar) of a per-neighbour limiter: K31 on CUDA
    tensors."""
    if r.is_cuda:
        return _ext.mfv_limiter(spec, kern, limiter, ids_d, r, packed, grad,
                                ext.dWmax, ext.dWmin)
    return limiter_sweep_plain(kern, spec, limiter, ids_d, r, packed, grad,
                               ext)


def limiter_sweep_plain(kern: SmoothingKernel, spec: g27.Grid27Spec,
                        limiter: str, ids_d: Tensor, r: Tensor,
                        packed: Tensor, grad: Tensor,
                        ext: GradExtrema) -> Tensor:
    """Plain version of K31: ops.mfv.limiter_alpha_accumulate from alpha
    = 1 over a list of the pairs within kernrange * max(h), one pair per
    row, the running min taken per target (pairs beyond kernrange h_i
    give 1, as the JAX sweep's `near` mask makes them)."""
    nd = spec.ndim
    nvar = nd + 2
    N = r.shape[0]
    h = torch.clamp_min(packed[:, 0], 1e-30)
    W = packed[:, 2:2 + nvar]
    cut2 = (kern.kernrange * float(h.max())) ** 2 * (1.0 + 1e-6)
    row, col, dx, _ = slot_pairs(spec, ids_d, r, cut2, True)
    alpha = torch.ones((N, nvar), dtype=r.dtype, device=r.device)
    step = _pair_chunk(r.device)
    for c0 in range(0, row.numel(), step):
        i, j = row[c0:c0 + step], col[c0:c0 + step]
        a = mfv_ops.limiter_alpha_accumulate(
            limiter, kern, nd, torch.ones((i.numel(), nvar), dtype=r.dtype,
                                          device=r.device),
            h[i], W[i], grad[i], ext.dWmax[i], ext.dWmin[i],
            dx[c0:c0 + step][:, None, :], W[j][:, None, :], None)
        alpha.scatter_reduce_(0, i[:, None].expand(-1, nvar), a, "amin")
    return alpha


# ---------------------------------------------------------------------------
# K12: face fluxes
# ---------------------------------------------------------------------------

def pack_flux_fields(h, ndens, W, sound, a0, B, grad, alpha, bad,
                     dt_own=None, start=None) -> Tensor:
    """The (N, 15 / 26 / 41) table K12 reads in 1 / 2 / 3 dims, columns
    flux_cols; with `dt_own` (N,) and `start` (N,) bool, block mode's
    two more."""
    N = h.shape[0]
    cols = [h[:, None], ndens[:, None], W, sound[:, None], a0,
            B.reshape(N, -1), grad.reshape(N, -1), alpha,
            bad.to(h.dtype)[:, None]]
    if dt_own is not None:
        cols += [dt_own[:, None], start.to(h.dtype)[:, None]]
    return torch.cat(cols, -1).contiguous()


# K12's limiter class of each slope limiter (csrc/mfv.cuh): the Gizmo
# clamp, the cell alphas (null's all 1), none
FLUX_LIMITER_CLASS = {"gizmo": 0, "zeroslope": 2,
                      **{lim: 1 for lim in mfv_ops.CELL_LIMITERS}}


def flux_modes(cfg: mfv_ops.MfvConfig, block: bool = False
               ) -> _ext.FluxModes:
    """K12's modes under `cfg`, in block mode with `block`."""
    return _ext.FluxModes(
        gamma=float(cfg.gamma), exact=int(cfg.riemann == "exact"),
        limiter=FLUX_LIMITER_CLASS[cfg.slope_limiter],
        rk2=int(cfg.time_scheme == "rk2"), static=int(cfg.static_particles),
        zmf=int(cfg.zero_mass_flux), block=int(block))


def flux_count(spec: g27.Grid27Spec, cfg: mfv_ops.MfvConfig,
               block: bool = False, kern: SmoothingKernel = None) -> str:
    """The LAUNCHES key of K12 under `cfg` on `spec`'s dims with the
    smoothing kernel `kern` (None: M4's key)."""
    return _ext.mfv_flux_count(spec, flux_modes(cfg, block), kern)


def fluxes_kernel(kern: SmoothingKernel, cfg: mfv_ops.MfvConfig,
                  spec: g27.Grid27Spec, dt: Tensor, ids_d: Tensor,
                  r: Tensor, packed: Tensor, block: bool = False,
                  mapping: str = "auto") -> mfv_ops.FluxResult:
    """K12 under `cfg` on CUDA tensors, in the slot `mapping` (in block
    mode with `block`, `packed` then with its columns): null runs the
    cell class on a copy of `packed` whose alphas are all 1."""
    if cfg.slope_limiter == "null":
        packed = packed.clone()
        packed[:, flux_slices(spec.ndim)["alpha"]] = 1.0
    modes = flux_modes(cfg, block)
    return mfv_ops.FluxResult(*_ext.mfv_fluxes(
        spec, kern, modes, dt, ids_d, r, packed, mapping=mapping))


def fluxes(kern: SmoothingKernel, cfg: mfv_ops.MfvConfig,
           spec: g27.Grid27Spec, dt: Tensor, ids_d: Tensor, r: Tensor,
           packed: Tensor, block: bool = False) -> mfv_ops.FluxResult:
    """dQdt (N, nvar) and rdmdt_dot (N, ndim) of every particle from the
    face fluxes with all its neighbours under `cfg`'s Riemann solver,
    slope limiter, time scheme (the MUSCL half step or the RK2 full step
    over `dt`, a 0-d tensor read on the device) and face velocity.
    `packed` from pack_flux_fields; with `block` (and the block columns
    in `packed`), the MUSCL
    half step of each pair takes min(dt_own_i, dt_own_j) and the result
    also carries the committed dQ and rdmdt of the pairs where either
    member starts a step (ops.mfv.compute_godunov_fluxes' block mode).
    K12 on CUDA tensors."""
    mfv_ops.check_config(cfg)
    if r.is_cuda:
        return fluxes_kernel(kern, cfg, spec, dt, ids_d, r, packed, block)
    return fluxes_plain(kern, cfg, spec, dt, ids_d, r, packed, block)


def fluxes_plain(kern: SmoothingKernel, cfg: mfv_ops.MfvConfig,
                 spec: g27.Grid27Spec, dt: Tensor, ids_d: Tensor, r: Tensor,
                 packed: Tensor, block: bool = False) -> mfv_ops.FluxResult:
    """Plain version of K12: ops.mfv.compute_godunov_fluxes over a list
    of the pairs within kernrange * max(h) (beyond both supports the face
    area is 0 and the pair adds nothing), one pair per row, summed per
    target; block mode with `block`."""
    nd = spec.ndim
    nvar = nd + 2
    N, dev = r.shape[0], r.device
    sl = flux_slices(nd, block)

    def col(x, name):
        return x[..., sl[name]]

    h = col(packed, "h")[:, 0]
    cut2 = (kern.kernrange * float(h.max())) ** 2 * (1.0 + 1e-6)
    row, cl, dx, _ = slot_pairs(spec, ids_d, r, cut2, True)
    dQdt = torch.zeros((N, nvar), dtype=r.dtype, device=dev)
    rdmdt = torch.zeros((N, nd), dtype=r.dtype, device=dev)
    dQ, rdm = torch.zeros_like(dQdt), torch.zeros_like(rdmdt)
    step = _pair_chunk(dev)
    for c0 in range(0, row.numel(), step):
        i, j = row[c0:c0 + step], cl[c0:c0 + step]
        pi, pj = packed[i], packed[j][:, None, :]
        nb = {"h": col(pj, "h")[..., 0], "ndens": col(pj, "ndens")[..., 0],
              "Wprim": col(pj, "W"), "sound": col(pj, "sound")[..., 0],
              "a0": col(pj, "a0"),
              "B": col(pj, "B").reshape(-1, 1, nd, nd),
              "grad": col(pj, "grad").reshape(-1, 1, nvar, nd),
              "alpha_slope": col(pj, "alpha"),
              "bad": col(pj, "bad")[..., 0] > 0.5}
        kw = {}
        if block:
            kw["dt_pair"] = torch.minimum(col(pi, "dt_own"),
                                          col(pj, "dt_own")[..., 0])
            kw["pair_on"] = (col(pi, "start") > 0.5) \
                | (col(pj, "start")[..., 0] > 0.5)
        res = mfv_ops.compute_godunov_fluxes(
            kern, cfg, nd, dt, torch.clamp_min(col(pi, "h")[:, 0], 1e-30),
            col(pi, "ndens")[:, 0], col(pi, "W"), col(pi, "sound")[:, 0],
            col(pi, "a0"), col(pi, "B").reshape(-1, nd, nd),
            col(pi, "grad").reshape(-1, nvar, nd), col(pi, "alpha"),
            col(pi, "bad")[:, 0] > 0.5, dx[c0:c0 + step][:, None, :], nb,
            None, **kw)
        dQdt.index_add_(0, i, res.dQdt)
        rdmdt.index_add_(0, i, res.rdmdt_dot)
        if block:
            dQ.index_add_(0, i, res.dQ)
            rdm.index_add_(0, i, res.rdmdt)
    if block:
        return mfv_ops.FluxResult(dQdt=dQdt, rdmdt_dot=rdmdt, dQ=dQ,
                                  rdmdt=rdm)
    return mfv_ops.FluxResult(dQdt=dQdt, rdmdt_dot=rdmdt)


# ---------------------------------------------------------------------------
# K32 and K33: the conservative timestep limiter's distant signal velocity
# ---------------------------------------------------------------------------

def vsig_near(spec: g27.Grid27Spec, ids_d: Tensor, cell_of: Tensor,
              r: Tensor, v: Tensor, sound: Tensor, h: Tensor) -> Tensor:
    """The near field of the conservative limiter (N,): each particle's
    largest (c_i + c_j - dv.dr/|dr|) h_i / max(|dr|, h_i) over every
    particle of the 3^ndim cells around its own (its flat id in
    `cell_of`, K1's binning) at d^2 > 0, with no support cut, 0 where
    there is none.  K32 on CUDA tensors (it walks the slot map by
    cell and needs no `cell_of`)."""
    if r.is_cuda:
        return _ext.mfv_vsig_near(spec, ids_d, r, v, sound, h)
    return vsig_near_plain(spec, ids_d, cell_of, r, v, sound, h)


def vsig_near_plain(spec: g27.Grid27Spec, ids_d: Tensor, cell_of: Tensor,
                    r: Tensor, v: Tensor, sound: Tensor, h: Tensor
                    ) -> Tensor:
    """Plain version of K32: gandalf_tpu's vsig_near_grid27 over the
    candidate gather of ops.active_grid, in chunks of particles."""
    N = r.shape[0]
    out = torch.zeros((N,), dtype=r.dtype, device=r.device)
    idx = torch.nonzero(ids_d.reshape(-1) >= 0).flatten()
    idx = ids_d.reshape(-1)[idx].long()
    step = _row_chunk(3 ** spec.ndim * spec.k_cell, r.device)
    for c0 in range(0, idx.numel(), step):
        sel = idx[c0:c0 + step]
        cand, dr = gather_active_candidates(spec, cell_of, ids_d, r, sel)
        cid = torch.clamp_min(cand, 0)
        d2 = dr[..., 0] * dr[..., 0]
        for k in range(1, spec.ndim):
            d2 = d2 + dr[..., k] * dr[..., k]
        ok = (cand >= 0) & (d2 > 0)
        drmag = torch.sqrt(torch.where(ok, d2, 1.0))
        dvdr = torch.sum((v[sel][:, None, :] - v[cid]) * dr, -1) / drmag
        vs = sound[sel][:, None] + sound[cid] - dvdr
        h_i = h[sel][:, None]
        contrib = torch.where(ok, vs * (h_i / torch.maximum(drmag, h_i)),
                              0.0)
        out[sel] = torch.clamp_min(contrib.amax(dim=1), 0.0)
    return out


def far_geometry(spec: g27.Grid27Spec):
    """K33's static geometry per dim: the grid's lower corner, the cell
    size and the stencil's reach (1.0001 cell sizes, qz of them along dim
    0), as gandalf_tpu's vsig_far_from_agg takes them."""
    csize = [spec.extents[k] / spec.ncells[k] for k in range(spec.ndim)]
    reach = [c * 1.0001 for c in csize]
    reach[0] *= float(spec.qz)
    return list(spec.lo), csize, reach


def vsig_far(spec: g27.Grid27Spec, ids_d: Tensor, v: Tensor,
             sound: Tensor):
    """The far-field bound of the conservative limiter per cell: (A, Bc),
    each (C,) in z-major cell order; a particle's far-field signal
    velocity is at most h_i max(c_i A + Bc, 0) of its cell.  K33 on CUDA
    tensors."""
    lo, csize, reach = far_geometry(spec)
    if v.is_cuda:
        return _ext.mfv_vsig_far(spec, ids_d, v, sound, lo, csize, reach)
    return vsig_far_plain(spec, ids_d, v, sound)


def vsig_cell_aggregates_plain(spec: g27.Grid27Spec, ids_d: Tensor,
                               v: Tensor, sound: Tensor):
    """Per cell (C,) the largest sound speed (0 where empty), occupancy,
    and (C, ndim) the largest and least velocity (-1e30 and 1e30 where
    empty): gandalf_tpu's vsig_cell_aggregates from the slot map."""
    C, K = spec.total_cells, spec.k_cell
    ids = ids_d.reshape(C, K).long()
    fill = ids >= 0
    cid = torch.clamp_min(ids, 0)
    snd = torch.where(fill, sound[cid], -1e30)
    maxsound = torch.clamp_min(snd.amax(dim=1), 0.0)
    occ = fill.any(dim=1)
    vv = v[cid]
    vmax = torch.where(fill[..., None], vv, -1e30).amax(dim=1)
    vmin = torch.where(fill[..., None], vv, 1e30).amin(dim=1)
    return maxsound, occ, vmax, vmin


def vsig_far_plain(spec: g27.Grid27Spec, ids_d: Tensor, v: Tensor,
                   sound: Tensor):
    """Plain version of K33: vsig_cell_aggregates_plain, then
    gandalf_tpu's vsig_far_from_agg over chunks of target cells (the
    periodic wrap with torch.round, half to even as jnp.round)."""
    nd = spec.ndim
    C = spec.total_cells
    dt, dev = v.dtype, v.device
    maxsound, occ, vmax, vmin = vsig_cell_aggregates_plain(spec, ids_d, v,
                                                           sound)
    lo, csize, reach = far_geometry(spec)
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in spec.ncells],
                               indexing="ij"), -1).reshape(C, nd)
    centres = torch.as_tensor(np.asarray(lo)[None, :] + (idx + 0.5)
                              * np.asarray(csize)[None, :], dtype=dt,
                              device=dev)
    cs = torch.as_tensor(csize, dtype=dt, device=dev)
    re = torch.as_tensor(reach, dtype=dt, device=dev)
    A = torch.empty((C,), dtype=dt, device=dev)
    Bc = torch.empty((C,), dtype=dt, device=dev)
    step = max(1, (1 << 22) // max(C, 1))
    for c0 in range(0, C, step):
        rows = slice(c0, min(C, c0 + step))
        dr = centres[None, :, :] - centres[rows, None, :]
        cols = []
        for k in range(nd):
            x = dr[..., k]
            if spec.periodic[k]:
                e = float(spec.extents[k])
                x = x - e * torch.round(x / e)
            cols.append(x)
        dr = torch.stack(cols, -1)
        gap = torch.clamp_min(torch.abs(dr) - cs, 0.0)
        near = torch.all(torch.abs(dr) <= re, dim=-1)
        valid = occ[None, :] & ~near
        rmin = torch.sqrt(torch.where(valid, torch.sum(gap * gap, -1), 1.0))
        pos = dr > 0
        edge = torch.where(pos, vmin[None, :, :] - vmax[rows, None, :],
                           vmax[None, :, :] - vmin[rows, None, :])
        dvdr = torch.sum(torch.where(pos, gap, -gap) * edge, -1) / rmin
        A[rows] = torch.where(valid, 1.0 / rmin, 0.0).amax(dim=1)
        Bc[rows] = torch.where(valid, (maxsound[None, :] - dvdr) / rmin,
                               -1e30).amax(dim=1)
    return A, Bc


def vsig_conservative(spec: g27.Grid27Spec, ids_d: Tensor,
                      cell_of: Tensor, r: Tensor, v: Tensor, sound: Tensor,
                      h: Tensor) -> Tensor:
    """The conservative limiter's distant signal velocity (N,): the
    near field (K32) and the cell-aggregate far field (K33), h_i max(c_i
    A + Bc, 0) of the particle's cell (`cell_of`, K1's binning, clipped
    to the grid), the larger of the two
    (gandalf_tpu/sim/mfv_sim.py:_vsig_conservative on the grid)."""
    cell = torch.clamp(cell_of.long(), 0, spec.total_cells - 1)
    near = vsig_near(spec, ids_d, cell, r, v, sound, h)
    A, Bc = vsig_far(spec, ids_d, v, sound)
    far = h * torch.clamp_min(sound * A[cell] + Bc[cell], 0.0)
    return torch.maximum(near, far)
