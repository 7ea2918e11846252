"""Structured 3^ndim-shift grid hydro pass, in 1, 2 or 3 dims:
binning (K1), grad-h density (K2), SPH pair forces (K3) and the mirror
images of mirror and wall boundaries (K19).

Counterpart of ``gandalf_tpu/ops/sph_grid27.py`` without the z-slab
(``qz > 1``) plan.  Particles are binned to a uniform grid whose cells
are at least one kernel support wide, and scattered into dense per-cell
storage shaped (*ncells, K[, ndim]); every particle's neighbours then lie
in the 3^ndim cells around its own.  A mirror or wall side adds one
image-cell layer beyond the wall, which holds the reflected copies of
the particles within a cell of it (``grid_mirror_extend``), so the same
kernels see mirror ghosts as ordinary neighbours.  Public functions keep
the JAX package's dense layout.

Each kernel has a plain PyTorch version here and a CUDA C++ kernel in
``csrc/``, launched through ``_ext``.  A CPU tensor takes the plain
version; a CUDA tensor takes the kernel, or the wrapper raises.  Neither
uses ghost-layer copies: both wrap neighbour cell indices and shift
positions by the box length along periodic dims.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .. import _ext
from ..kernels.smoothing import SmoothingKernel
from ..state import DomainBox, SphState
from .forces import (ACOND_PRICE2008, ACOND_WADSLEY2008, AVISC_MON97,
                     AVISC_MON97MM97, AVISC_NONE, ArtificialViscosity)

Tensor = torch.Tensor

ITER_FP = 30
ITER_MAX = 150


# order of the packed per-slot scalars handed to the force kernel
FORCE_SCALARS = ("m", "h", "rho", "u", "pressure", "sound", "invomega",
                 "hfactor", "alpha")


@dataclasses.dataclass(frozen=True)
class Grid27Spec:
    """Static grid geometry (same fields as gandalf_tpu's Grid27Spec).

    The port plans only ``qz == 1``; the field stays so a JAX plan copies
    across unchanged.  With mirror walls, ncells, lo and extents include
    the image-cell layers beyond the walls."""

    ndim: int
    ncells: Tuple[int, ...]        # dim 0 slowest in the flat cell id
    lo: Tuple[float, ...]
    extents: Tuple[float, ...]
    k_cell: int
    periodic: Tuple[bool, ...]
    qz: int = 1
    mirror: Tuple[Tuple[int, int], ...] = ()

    @property
    def total_cells(self) -> int:
        return int(np.prod(self.ncells))


def hmax_of(spec: Grid27Spec, kernrange: float) -> float:
    """Largest h whose kernel support the shift stencil still covers."""
    reach = [spec.qz * spec.extents[0] / spec.ncells[0]]
    reach += [spec.extents[k] / spec.ncells[k]
              for k in range(1, spec.ndim)]
    return min(reach) / kernrange


def plan_grid27(box: DomainBox, r: np.ndarray, h_max: float,
                kernrange: float, k_slack: float = 1.35) -> Grid27Spec:
    """Host-side grid plan: cells at least one support (kernrange*h_max)
    wide, K = ceil(max occupancy * k_slack) + 1 slots per cell.  A mirror
    or wall side anchors the grid at the wall and adds one image-cell
    layer beyond it; the occupancy counts the images that land there."""
    r = np.asarray(r)
    ndim = r.shape[1]
    support = float(kernrange * h_max)
    pdims = box.periodic_dims()
    walls = box.mirror_walls()
    mlo = [(k, 0) in walls for k in range(ndim)]
    mhi = [(k, 1) in walls for k in range(ndim)]
    lo, hi, periodic = [], [], []
    for k in range(ndim):
        if k in pdims:
            lo.append(box.boxmin[k])
            hi.append(box.boxmax[k])
            periodic.append(True)
        else:
            lo.append(box.boxmin[k] if mlo[k]
                      else float(r[:, k].min()) - 1e-6)
            hi.append(box.boxmax[k] if mhi[k]
                      else float(r[:, k].max()) + 1e-6)
            periodic.append(False)
    ncells = [max(int(np.floor((hi[k] - lo[k]) / support)), 1)
              for k in range(ndim)]
    # one image-cell layer beyond each wall; the occupancy counts the
    # images of the particles within a cell of the wall
    r_occ = [r]
    for k in range(ndim):
        if not (mlo[k] or mhi[k]):
            continue
        cell_k = (hi[k] - lo[k]) / ncells[k]
        for side, on in ((0, mlo[k]), (1, mhi[k])):
            if not on:
                continue
            bound = box.boxmin[k] if side == 0 else box.boxmax[k]
            img = r[np.abs(r[:, k] - bound) < cell_k].copy()
            img[:, k] = 2.0 * bound - img[:, k]
            r_occ.append(img)
            ncells[k] += 1
            if side == 0:
                lo[k] -= cell_k
            else:
                hi[k] += cell_k
    r_occ = np.concatenate(r_occ, axis=0) if len(r_occ) > 1 else r
    ncells = tuple(ncells)
    extents = tuple(hi[k] - lo[k] for k in range(ndim))
    cid = np.zeros(r_occ.shape[0], dtype=np.int64)
    for k in range(ndim):
        ck = np.clip(np.floor((r_occ[:, k] - lo[k]) / extents[k]
                              * ncells[k]).astype(np.int64),
                     0, ncells[k] - 1)
        cid = cid * ncells[k] + ck
    counts = np.bincount(cid, minlength=int(np.prod(ncells)))
    k_cell = int(np.ceil(counts.max() * k_slack)) + 1
    return Grid27Spec(ndim=ndim, ncells=ncells, lo=tuple(lo),
                      extents=extents, k_cell=k_cell,
                      periodic=tuple(periodic), mirror=tuple(walls))


# ---------------------------------------------------------------------------
# K1: binning
# ---------------------------------------------------------------------------

class GridBinning(NamedTuple):
    cell_of: Tensor     # (N,) int32 flat cell id per particle (C: discarded)
    slot_of: Tensor     # (N,) int32 slot in its cell, clamped to K-1
    overflow: Tensor    # () bool: some cell holds more than K particles


def bin_particles(spec: Grid27Spec, r: Tensor,
                  discard: Tensor = None) -> GridBinning:
    """Cell id and stable slot rank (original particle order within a
    cell) per particle.  `discard` (N,) bool routes particles to the
    virtual cell C = total_cells, where they take no slot and raise no
    overflow.  K1 on a CUDA tensor."""
    if r.is_cuda:
        return GridBinning(*_ext.grid27_bin(spec, r, discard))
    return bin_particles_plain(spec, r, discard)


def bin_particles_plain(spec: Grid27Spec, r: Tensor,
                        discard: Tensor = None) -> GridBinning:
    """Plain version of K1: stable sort by cell id, rank within runs.
    The discarded are ranked among themselves, as in the JAX package
    (K1 gives them slot 0; nothing reads either)."""
    N = r.shape[0]
    cid = torch.zeros((N,), dtype=torch.int32, device=r.device)
    for k in range(spec.ndim):
        # a tensor divisor: CUDA turns division by a Python scalar into a
        # product with its reciprocal, which moves particles on a cell
        # face into the next cell when the extent is not a power of two
        ext = torch.tensor(spec.extents[k], dtype=r.dtype, device=r.device)
        ck = torch.floor((r[:, k] - spec.lo[k]) / ext
                         * spec.ncells[k]).to(torch.int32)
        cid = cid * spec.ncells[k] + torch.clamp(ck, 0, spec.ncells[k] - 1)
    if discard is not None:
        cid = torch.where(discard, spec.total_cells, cid)
    order = torch.sort(cid, stable=True).indices
    cid_sorted = cid[order]
    idx = torch.arange(N, dtype=torch.int64, device=r.device)
    first = torch.ones((N,), dtype=torch.bool, device=r.device)
    first[1:] = cid_sorted[1:] != cid_sorted[:-1]
    run_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    slot = torch.empty((N,), dtype=torch.int32, device=r.device)
    slot[order] = (idx - run_start).to(torch.int32)
    over = slot >= spec.k_cell
    if discard is not None:
        over = over & ~discard
    return GridBinning(cell_of=cid,
                       slot_of=torch.clamp(slot, max=spec.k_cell - 1),
                       overflow=torch.any(over))


def _flat_slot(spec: Grid27Spec, b: GridBinning) -> Tensor:
    return b.cell_of.long() * spec.k_cell + b.slot_of.long()


def to_dense(spec: Grid27Spec, b: GridBinning, x: Tensor) -> Tensor:
    """(N, ...) -> (*ncells, K, ...) dense cell tensor (zeros in empty
    slots; discarded particles dropped)."""
    K, C = spec.k_cell, spec.total_cells
    out = torch.zeros(((C + 1) * K,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[_flat_slot(spec, b)] = x
    return out[:C * K].reshape(tuple(spec.ncells) + (K,)
                               + tuple(x.shape[1:]))


def dense_fill_mask(spec: Grid27Spec, b: GridBinning) -> Tensor:
    K, C = spec.k_cell, spec.total_cells
    fill = torch.zeros(((C + 1) * K,), dtype=torch.bool,
                       device=b.cell_of.device)
    fill[_flat_slot(spec, b)] = True
    return fill[:C * K].reshape(tuple(spec.ncells) + (K,))


def from_dense(spec: Grid27Spec, b: GridBinning, x_d: Tensor) -> Tensor:
    """(*ncells, K, ...) -> (N, ...), for a binning without discarded
    particles."""
    K, C = spec.k_cell, spec.total_cells
    flat = x_d.reshape((C * K,) + tuple(x_d.shape[spec.ndim + 1:]))
    return flat[_flat_slot(spec, b)]


# ---------------------------------------------------------------------------
# K19: mirror images
# ---------------------------------------------------------------------------

def mirror_planes(box: DomainBox, spec: Grid27Spec):
    """(dim, plane, radius) of each mirror or wall side: the radius is
    the image-cell layer's width along the dim (qz layers on dim 0)."""
    out = []
    for (k, side) in box.mirror_walls():
        bound = box.boxmin[k] if side == 0 else box.boxmax[k]
        layers = spec.qz if k == 0 else 1
        out.append((k, bound, layers * spec.extents[k] / spec.ncells[k]))
    return out


def grid_mirror_extend(box: DomainBox, spec: Grid27Spec, r: Tensor,
                       v: Tensor, alive: Tensor = None):
    """Reflected whole-set copies for the grid path, one per mirror wall:
    (r_ext, v_ext, keep) with leading axis (1+W)*N, copy 0 the particles
    and copy w their images in wall w (r_k -> 2 wall - r_k, v_k -> -v_k);
    keep is alive for copy 0 and, for an image, alive and within one
    image layer of the wall (the images any deeper are beyond the reach
    of every particle and are discarded by K1).  K19 on CUDA tensors."""
    walls = mirror_planes(box, spec)
    if r.is_cuda:
        return _ext.grid27_mirror(walls, r, v, alive)
    return grid_mirror_extend_plain(walls, r, v, alive)


def grid_mirror_extend_plain(walls, r: Tensor, v: Tensor,
                             alive: Tensor = None):
    """Plain version of K19 (gandalf_tpu's grid_mirror_extend) for the
    walls of `mirror_planes`: the plane 2 wall and the wall and radius of
    the keep test rounded to r's dtype, as the kernel takes them."""
    live = (torch.ones((r.shape[0],), dtype=torch.bool, device=r.device)
            if alive is None else alive)

    def const(x):
        return torch.full((), x, dtype=r.dtype, device=r.device)

    rs, vs, keeps = [r], [v], [live]
    for (k, bound, rad) in walls:
        r_w, v_w = r.clone(), v.clone()
        r_w[:, k] = const(2.0 * bound) - r[:, k]
        v_w[:, k] = -v[:, k]
        rs.append(r_w)
        vs.append(v_w)
        keeps.append(live & (torch.abs(r[:, k] - const(bound))
                             < const(rad)))
    return torch.cat(rs), torch.cat(vs), torch.cat(keeps)


# ---------------------------------------------------------------------------
# Neighbour tables for the plain versions
# ---------------------------------------------------------------------------

def _shifts(ndim: int):
    """The 3^ndim cell offsets in the kernels' order (dim 0 slowest);
    the centre one, (0, ..., 0), is the cell itself."""
    return tuple(itertools.product((-1, 0, 1), repeat=ndim))


def _neighbour_table(spec: Grid27Spec, device):
    """(C, S) neighbour cell ids, (C, S, ndim) coordinate shifts (±L
    where a periodic dim wraps) and (C, S) in-range mask (open dims),
    S = 3^ndim."""
    n, nd = spec.ncells, spec.ndim
    shifts = _shifts(nd)
    coords = np.stack(np.meshgrid(*[np.arange(nk) for nk in n],
                                  indexing="ij"), -1).reshape(-1, nd)
    C, S = coords.shape[0], len(shifts)
    nb = np.zeros((C, S), dtype=np.int64)
    off = np.zeros((C, S, nd))
    ok = np.ones((C, S), dtype=bool)
    for s, d in enumerate(shifts):
        c = coords + np.asarray(d)
        for k in range(nd):
            below, above = c[:, k] < 0, c[:, k] >= n[k]
            if spec.periodic[k]:
                off[:, s, k] = np.where(below, -spec.extents[k],
                                        np.where(above, spec.extents[k], 0.0))
                c[:, k] %= n[k]
            else:
                ok[:, s] &= ~(below | above)
                c[:, k] = np.clip(c[:, k], 0, n[k] - 1)
        flat = np.zeros(C, dtype=np.int64)
        for k in range(nd):
            flat = flat * n[k] + c[:, k]
        nb[:, s] = flat
    return (torch.as_tensor(nb, device=device),
            torch.as_tensor(off, device=device),
            torch.as_tensor(ok, device=device))


def _pair_list(spec: Grid27Spec, r_d: Tensor, fill: Tensor, cut2: float,
               exclude_self: bool):
    """Candidate pairs (i, j) over the 3^ndim-cell stencil with both
    slots filled and |r_j - r_i|^2 <= cut2, as flat slot indices row (i)
    and col (j), separations r_j - r_i (P, ndim) and d^2 (P,), ordered by
    row, then by stencil position.  With `exclude_self`, a slot's pair
    with itself (same slot, centre shift) and coincident pairs are
    dropped.  Built over chunks of the filled slots that bound the
    (slots, S K) candidate block: 2^25 candidates on a GPU (a few hundred
    MB), 2^21 on a CPU."""
    K, C, nd = spec.k_cell, spec.total_cells, spec.ndim
    S = 3 ** nd
    dev = r_d.device
    r_s = r_d.reshape(C * K, nd)
    r_f = r_d.reshape(C, K, nd)
    fill_s = fill.reshape(C * K)
    fill_f = fill.reshape(C, K)
    nb, off, ok = _neighbour_table(spec, dev)
    slots = torch.nonzero(fill_s).flatten()
    budget = 1 << 25 if dev.type == "cuda" else 1 << 21
    step = max(1, budget // (S * K))
    jj_all = torch.arange(S * K, device=dev)
    parts = []
    for c0 in range(0, slots.numel(), step):
        rows = slots[c0:c0 + step]
        cells = rows // K
        nbc = nb[cells]
        # neighbour positions shifted by +-L where a periodic dim wraps
        r_tab = (r_f[nbc] + off[cells].to(r_d.dtype)[:, :, None, :]
                 ).reshape(-1, S * K, nd)
        f_tab = (fill_f[nbc] & ok[cells][..., None]).reshape(-1, S * K)
        r_i = r_s[rows]
        dx = [r_tab[:, :, k] - r_i[:, None, k] for k in range(nd)]
        d2 = dx[0] * dx[0]
        for x in dx[1:]:
            d2 = d2 + x * x
        keep = f_tab & (d2 <= cut2)
        if exclude_self:
            self_pair = jj_all[None, :] == (S // 2) * K + (rows % K)[:, None]
            keep &= ~self_pair & (d2 > 0.0)
        b, jj = keep.nonzero(as_tuple=True)
        row = rows[b]
        col = nb[cells[b], jj // K] * K + jj % K
        parts.append((row, col, torch.stack([x[keep] for x in dx], dim=-1),
                      d2[keep]))
    if not parts:
        z = torch.zeros((0,), dtype=torch.int64, device=dev)
        return (z, z, torch.zeros((0, nd), dtype=r_d.dtype, device=dev),
                torch.zeros((0,), dtype=r_d.dtype, device=dev))
    return tuple(torch.cat(x) for x in zip(*parts))


# ---------------------------------------------------------------------------
# K2: grad-h density iteration
# ---------------------------------------------------------------------------

class Grid27Density(NamedTuple):
    h: Tensor
    rho: Tensor
    invomega: Tensor
    zeta: Tensor
    hfactor: Tensor
    overflow: Tensor


def density_sums(kern: SmoothingKernel, spec: Grid27Spec, h_fac: float,
                 h_converge: float, hmax: float, r_d: Tensor, m_d: Tensor,
                 h_d: Tensor, fill: Tensor, target: Tensor = None):
    """The h-rho iteration of every filled slot (of the filled `target`
    slots, (*ncells, K) bool, where given: the others are neighbours only
    and come back with zero sums, converged): (rho, invom, zeta) sums at
    its final h and its converged flag, each (*ncells, K).  K2 on CUDA
    tensors."""
    if r_d.is_cuda:
        return _ext.grid27_density(spec, kern, h_fac, h_converge, hmax,
                                   r_d, m_d, h_d, fill, target)
    return density_sums_plain(kern, spec, h_fac, h_converge, hmax,
                              r_d, m_d, h_d, fill, target)


def density_sums_plain(kern: SmoothingKernel, spec: Grid27Spec,
                       h_fac: float, h_converge: float, hmax: float,
                       r_d: Tensor, m_d: Tensor, h_d: Tensor, fill: Tensor,
                       target: Tensor = None):
    """Plain version of K2: the lockstep iteration of gandalf_tpu's
    density_grid27 (30 fixed-point steps, bisection up to step 150; a
    converged slot keeps its h) over a list of the pairs within
    kernrange*hmax, the farthest any h <= hmax reaches."""
    K, C, nd = spec.k_cell, spec.total_cells, spec.ndim
    # pairs beyond the cut have s > kernrange at every h <= hmax: their
    # terms are exactly zero (the margin covers rounding of s)
    cut2 = (kern.kernrange * hmax) ** 2 * (1.0 + 1e-6)
    row, col, _, d2 = _pair_list(spec, r_d, fill, cut2, False)
    fill_f = fill.reshape(-1)
    m_j = m_d.reshape(-1)[col]
    m_t = torch.clamp_min(m_d.reshape(-1), 1e-30)

    def pair_sum(x):
        return torch.zeros((C * K,), dtype=x.dtype,
                           device=x.device).index_add_(0, row, m_j * x)

    def sums_at(h):
        invh = 1.0 / h
        invhsqd = invh * invh
        ssqd = d2 * invhsqd[row]
        rho = pair_sum(kern.w0_s2(ssqd))
        invom = pair_sum(kern.womega_s2(ssqd))
        zeta = pair_sum(kern.wzeta_s2(ssqd))
        hfac = invh ** nd
        return rho * hfac, invom * hfac * invh, zeta * invhsqd

    h = torch.clamp(torch.where(fill_f, h_d.reshape(-1), 0.5 * hmax),
                    1e-6 * hmax, hmax)
    lo = torch.zeros_like(h)
    hi = torch.full_like(h, hmax)
    iterate = fill_f if target is None else fill_f & target.reshape(-1)
    done = ~iterate
    rho = invom = zeta = torch.zeros_like(h)
    it = 0
    while it < ITER_MAX and not bool(done.all()):
        rho, invom, zeta = sums_at(h)
        h_target = h_fac * (m_t / torch.clamp_min(rho, 1e-300)) ** (1.0 / nd)
        conv = (rho > 0.0) & (torch.abs(h - h_target) / h < h_converge)
        too_big = (rho < 1e-30) | (h > h_target)
        if it >= ITER_FP:
            hi = torch.where(too_big & ~conv, h, hi)
            lo = torch.where(~too_big & ~conv, h, lo)
        h_new = h_target if it < ITER_FP else 0.5 * (lo + hi)
        h = torch.where(conv | done, h, torch.clamp(h_new, 1e-6 * hmax, hmax))
        done = done | conv
        it += 1
    if target is not None:
        zero = torch.zeros_like(h)
        rho, invom, zeta = (torch.where(iterate, x, zero)
                            for x in (rho, invom, zeta))
    shape = tuple(spec.ncells) + (K,)
    return tuple(x.reshape(shape) for x in (rho, invom, zeta, done))


def density_grid27(kern: SmoothingKernel, spec: Grid27Spec,
                   h_fac: float, h_converge: float, r_d: Tensor,
                   m_d: Tensor, h_d: Tensor, fill: Tensor,
                   hmax: float, count_fill: Tensor = None) -> Grid27Density:
    """Grad-h h-rho iteration over the 3^ndim-cell stencil, then the
    per-slot finish.  Dense (*ncells, K) in and out.  `count_fill`
    (default `fill`) are the slots that iterate and decide overflow: the
    mirror path's parents; its images are neighbours only."""
    sums = density_sums(kern, spec, h_fac, h_converge, hmax, r_d, m_d, h_d,
                        fill, count_fill)
    return density_finish(spec, h_fac, hmax, m_d, fill, *sums,
                          count_fill=count_fill)


def density_finish(spec: Grid27Spec, h_fac: float, hmax: float,
                   m_d: Tensor, fill: Tensor, rho: Tensor, invom: Tensor,
                   zeta: Tensor, done: Tensor,
                   count_fill: Tensor = None) -> Grid27Density:
    """Per-slot finish of the iteration's sums: h from rho, invomega,
    zeta, hfactor, the overflow flag (a slot of `count_fill`, default
    `fill`, did not converge or its h passed 0.99 hmax:
    gandalf_tpu/ops/sph_grid27.py:494-496), and benign values outside
    it."""
    nd = spec.ndim
    invndim = 1.0 / nd
    rho_safe = torch.clamp_min(rho, 1e-300)
    h_final = h_fac * (torch.clamp_min(m_d, 1e-30) / rho_safe) ** invndim
    invh = 1.0 / h_final
    hfactor = invh ** (nd + 1)
    dh_drho = -invndim * h_final / rho_safe
    invomega = 1.0 / (1.0 - dh_drho * invom)
    zeta_final = dh_drho * zeta * invomega
    cfill = fill if count_fill is None else count_fill
    overflow = torch.any(cfill & ~done) | torch.any(
        torch.where(cfill, h_final, 0.0) > 0.99 * hmax)

    # empty slots (and images) take benign values: they are masked
    # neighbours in the force pass, where NaN would poison valid pairs
    # through 0*NaN
    def sane(x, v):
        return torch.where(cfill, x, v)

    return Grid27Density(h=sane(h_final, 1.0), rho=sane(rho, 1.0),
                         invomega=sane(invomega, 1.0),
                         zeta=sane(zeta_final, 0.0),
                         hfactor=sane(hfactor, 0.0), overflow=overflow)


# ---------------------------------------------------------------------------
# K3: SPH pair forces
# ---------------------------------------------------------------------------

def force_sums(kern: SmoothingKernel, visc: ArtificialViscosity,
               spec: Grid27Spec, r_d: Tensor, v_d: Tensor, packed: Tensor,
               fill: Tensor):
    """Pair sums of every slot: acceleration (*ncells, K, ndim), and du/dt
    and the unnormalised -sum m_j dvdr W'_i (*ncells, K), before the
    epilogue.  `packed` holds FORCE_SCALARS on its last axis.  K3 on
    CUDA tensors."""
    if r_d.is_cuda:
        return _ext.grid27_forces(spec, kern, visc, r_d, v_d, packed, fill)
    return force_sums_plain(kern, visc, spec, r_d, v_d, packed, fill)


def force_sums_plain(kern: SmoothingKernel, visc: ArtificialViscosity,
                     spec: Grid27Spec, r_d: Tensor, v_d: Tensor,
                     packed: Tensor, fill: Tensor):
    """Plain version of K3: gandalf_tpu's _force_shifts over a list of the
    pairs within kernrange times the largest h, with the separations and
    (v_j - v_i).(r_j - r_i) computed directly.  A pair counts when j is a
    filled slot, is not i itself (same slot, centre shift) and does not
    coincide with i."""
    K, C, nd = spec.k_cell, spec.total_cells, spec.ndim
    fill_f = fill.reshape(-1)
    pk = packed.reshape(C * K, len(FORCE_SCALARS))
    col_of = {k: i for i, k in enumerate(FORCE_SCALARS)}
    # beyond kernrange*max(h) both kernel gradients of a pair vanish and
    # every term of the pair is exactly zero
    h_big = float(torch.max(torch.where(fill_f, pk[:, col_of["h"]], 0.0)))
    cut2 = (kern.kernrange * h_big) ** 2 * (1.0 + 1e-6)
    row, col, dx, d2 = _pair_list(spec, r_d, fill, cut2, True)
    v_f = v_d.reshape(C * K, nd)

    def own(key):
        return pk[row, col_of[key]]

    def nbr(key):
        return pk[col, col_of[key]]

    invh_i = 1.0 / torch.clamp_min(own("h"), 1e-30)
    invrho_i = 1.0 / torch.clamp_min(own("rho"), 1e-300)
    press_i, sound_i, u_i = own("pressure"), own("sound"), own("u")
    m_j = nbr("m")
    invrho_j = 1.0 / nbr("rho")
    drmag = torch.sqrt(d2)
    inv_drmag = 1.0 / drmag
    wkerni = own("hfactor") * kern.w1(drmag * invh_i)
    wkernj = nbr("hfactor") * kern.w1(drmag / nbr("h"))
    dvdr = torch.sum((v_f[col] - v_f[row]) * dx, dim=-1) * inv_drmag
    paux = (press_i * own("invomega") * invrho_i * invrho_i * wkerni
            + nbr("pressure") * nbr("invomega") * invrho_j * invrho_j
            * wkernj)
    du = torch.zeros_like(d2)
    if visc.avisc != AVISC_NONE:
        approach = dvdr < 0.0
        winvrho = 0.25 * (wkerni + wkernj) * (invrho_i + invrho_j)
        if visc.avisc == AVISC_MON97:
            alpha_eff = visc.alpha_visc
        else:
            alpha_eff = 0.5 * (own("alpha") + nbr("alpha"))
        vsignal = sound_i + nbr("sound") - visc.beta_visc * alpha_eff * dvdr
        paux = paux - torch.where(approach,
                                  alpha_eff * vsignal * dvdr * winvrho, 0.0)
        du = du - torch.where(approach, 0.5 * m_j * alpha_eff * vsignal
                              * dvdr * dvdr * winvrho, 0.0)
        if visc.acond == ACOND_WADSLEY2008:
            du = du + torch.where(
                approach, m_j * dvdr * (nbr("u") - u_i)
                * (invrho_i * wkerni + invrho_j * wkernj), 0.0)
        elif visc.acond == ACOND_PRICE2008:
            du = du + torch.where(
                approach, 0.5 * m_j * (u_i - nbr("u")) * winvrho
                * (invrho_i + invrho_j)
                * torch.sqrt(torch.abs(press_i - nbr("pressure"))), 0.0)
    w_pair = m_j * paux * inv_drmag

    def pair_sum(x):
        out = torch.zeros((C * K,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, row, x)

    shape = tuple(spec.ncells) + (K,)
    return (pair_sum(w_pair[:, None] * dx).reshape(shape + (nd,)),
            pair_sum(du).reshape(shape),
            pair_sum(-m_j * dvdr * wkerni).reshape(shape))


def forces_grid27(kern: SmoothingKernel, visc: ArtificialViscosity,
                  spec: Grid27Spec, dense: Dict[str, Tensor], fill: Tensor):
    """Hydro forces over the 3^ndim-cell stencil.  dense: (*ncells,
    K[, ndim]) tensors r, v and FORCE_SCALARS.  Returns dense (a, dudt,
    div_v, dalphadt)."""
    packed = torch.stack([dense[k] for k in FORCE_SCALARS], dim=-1)
    a, dudt, div_v = force_sums(kern, visc, spec, dense["r"], dense["v"],
                                packed, fill)
    invh_i = 1.0 / torch.clamp_min(dense["h"], 1e-30)
    invrho_i = 1.0 / torch.clamp_min(dense["rho"], 1e-300)
    div_v = div_v * invrho_i
    dudt = dudt - dense["pressure"] * div_v * invrho_i * dense["invomega"]
    dalphadt = torch.zeros_like(invh_i)
    if visc.avisc == AVISC_MON97MM97:
        alpha_i = dense["alpha"]
        dalphadt = (0.1 * dense["sound"] * (visc.alpha_visc_min - alpha_i)
                    * invh_i + torch.clamp_min(-div_v, 0.0)
                    * (visc.alpha_visc - alpha_i))
    return a, dudt, div_v, dalphadt


# ---------------------------------------------------------------------------
# The hydro pass
# ---------------------------------------------------------------------------

def hydro_pass_grid27(kern, visc, box: DomainBox, spec: Grid27Spec, eos,
                      h_fac, h_converge, hydro_forces: bool,
                      s: SphState, alive: Tensor = None) -> SphState:
    """Full grid hydro pass: bin -> dense -> density -> EOS -> forces ->
    back to particle order.  The overflow flag is this pass's own.  With
    mirror layers in the plan the pass takes the reflected images
    (_hydro_pass_grid27_mirror).

    `alive` (N,) bool masks dead particles (accreted gas) out of the
    dense fill mask, as gandalf_tpu's hydro_pass_grid27 (:809-864) does:
    they still take their slots (K1 bins every particle), count in no
    sum, and their own fields come back as h = rho = invomega = 1,
    u = 1e-30 and zeros."""
    if spec.qz != 1:
        raise NotImplementedError(
            "z-slab plans are not ported yet (ROADMAP queue 1, item 13)")
    if spec.mirror:
        return _hydro_pass_grid27_mirror(kern, visc, box, spec, eos, h_fac,
                                         h_converge, hydro_forces, s, alive)
    b = bin_particles(spec, s.r)
    hmax = hmax_of(spec, kern.kernrange)

    def d(x):
        return to_dense(spec, b, x)

    fill = dense_fill_mask(spec, b)
    if alive is not None:
        fill = fill & d(alive)
    r_d, v_d, m_d, h_d = d(s.r), d(s.v), d(s.m), d(s.h)
    dens = density_grid27(kern, spec, h_fac, h_converge, r_d, m_d, h_d,
                          fill, hmax)
    # the radiation wrappers blend with the ionisation fraction
    # (gandalf_tpu/ops/sph_grid27.py:834-835)
    eos_kw = {"ionfrac": d(s.ionfrac)} if eos.needs_ionfrac else {}
    u_d, pressure_d, sound_d = eos.thermal_update(
        torch.clamp_min(dens.rho, 1e-30), d(s.u), **eos_kw)
    if hydro_forces:
        dense_fields = {
            "r": r_d, "v": v_d, "m": m_d, "h": dens.h, "rho": dens.rho,
            "u": u_d, "pressure": pressure_d, "sound": sound_d,
            "invomega": dens.invomega, "hfactor": dens.hfactor,
            "alpha": d(s.alpha),
        }
        a_d, dudt_d, div_v_d, _ = forces_grid27(kern, visc, spec,
                                                dense_fields, fill)
    else:
        a_d = torch.zeros_like(r_d)
        dudt_d = torch.zeros_like(m_d)
        div_v_d = torch.zeros_like(m_d)

    def back(x_d, dead=None):
        x = from_dense(spec, b, x_d)
        if alive is None:
            return x
        keep = alive if x.dim() == 1 else alive[:, None]
        return torch.where(keep, x, dead)

    return s.replace(
        h=back(dens.h, 1.0), rho=back(dens.rho, 1.0),
        invomega=back(dens.invomega, 1.0), zeta=back(dens.zeta, 0.0),
        hfactor=back(dens.hfactor, 0.0), u=back(u_d, 1e-30),
        pressure=back(pressure_d, 0.0), sound=back(sound_d, 0.0),
        a=back(a_d, 0.0), dudt=back(dudt_d, 0.0), div_v=back(div_v_d, 0.0),
        neib_overflow=dens.overflow | b.overflow)


def _hydro_pass_grid27_mirror(kern, visc, box: DomainBox, spec: Grid27Spec,
                              eos, h_fac, h_converge, hydro_forces: bool,
                              s: SphState, alive: Tensor = None) -> SphState:
    """The mirror-wall pass (gandalf_tpu's _hydro_pass_grid27_mirror,
    :737-804): the particles and their reflected images (K19) are binned
    together, the images beyond their layer discarded (K1), so K2 and K3
    see mirror ghosts as ordinary neighbours.  Only the parents iterate
    h and decide overflow (images at the edge of the band legitimately
    run past hmax); the EOS runs on the particles, and every image slot
    takes its parent's fields before the force pass, as the reference
    copies ghost data from parents each step."""
    N = s.N
    live = (torch.ones((N,), dtype=torch.bool, device=s.r.device)
            if alive is None else alive)
    r_ext, v_ext, keep = grid_mirror_extend(box, spec, s.r, s.v, alive)
    n_img = r_ext.shape[0] // N

    def tile(x):
        return x.repeat((n_img,) + (1,) * (x.dim() - 1))

    b = bin_particles(spec, r_ext, discard=~keep)
    hmax = hmax_of(spec, kern.kernrange)

    def d(x):
        return to_dense(spec, b, x)

    fill = dense_fill_mask(spec, b)
    r_d = d(r_ext)
    is_parent = torch.arange(r_ext.shape[0], device=s.r.device) < N
    dens = density_grid27(kern, spec, h_fac, h_converge, r_d, d(tile(s.m)),
                          d(tile(s.h)), fill, hmax,
                          count_fill=d(keep & is_parent))
    # a parent outside `alive` was discarded (K1's virtual cell C): it
    # reads slot 0 of cell 0, and `sane` replaces what it read
    parents = GridBinning(torch.where(live, b.cell_of[:N], 0),
                          torch.where(live, b.slot_of[:N], 0), b.overflow)

    def sane(x_d, v0):
        x = from_dense(spec, parents, x_d)
        return torch.where(live if x.dim() == 1 else live[:, None], x, v0)

    h_new, rho_new = sane(dens.h, 1.0), sane(dens.rho, 1.0)
    invom_new, zeta_new = sane(dens.invomega, 1.0), sane(dens.zeta, 0.0)
    hfac_new = sane(dens.hfactor, 0.0)
    eos_kw = {"ionfrac": s.ionfrac} if eos.needs_ionfrac else {}
    u_new, press_new, sound_new = eos.thermal_update(
        torch.clamp_min(rho_new, 1e-30), s.u, **eos_kw)
    u_new = torch.where(live, u_new, 1e-30)
    press_new = torch.where(live, press_new, 0.0)
    sound_new = torch.where(live, sound_new, 0.0)
    if hydro_forces:
        dense_fields = {
            "r": r_d, "v": d(v_ext), "m": d(tile(s.m)),
            "h": d(tile(h_new)), "rho": d(tile(rho_new)),
            "u": d(tile(u_new)), "pressure": d(tile(press_new)),
            "sound": d(tile(sound_new)), "invomega": d(tile(invom_new)),
            "hfactor": d(tile(hfac_new)), "alpha": d(tile(s.alpha)),
        }
        a_d, dudt_d, div_v_d, _ = forces_grid27(kern, visc, spec,
                                                dense_fields, fill)
        a_new, dudt_new = sane(a_d, 0.0), sane(dudt_d, 0.0)
        div_v_new = sane(div_v_d, 0.0)
    else:
        a_new = torch.zeros_like(s.r)
        dudt_new = torch.zeros_like(s.m)
        div_v_new = torch.zeros_like(s.m)
    return s.replace(
        h=h_new, rho=rho_new, invomega=invom_new, zeta=zeta_new,
        hfactor=hfac_new, u=u_new, pressure=press_new, sound=sound_new,
        a=a_new, dudt=dudt_new, div_v=div_v_new,
        neib_overflow=s.neib_overflow | dens.overflow | b.overflow)
