"""TreeRay-style reverse ray tracing on the structured grid.

Counterpart of ``gandalf_tpu/ops/treeray.py`` (the reference's TreeRay,
src/Radiation/TreeRay.cpp and TreeRayOnTheSpot.cpp, re-designed there as
fixed-step ray marching through per-cell fields of the grid of
``ops/sph_grid27.py``):

- ``healpix_directions(nside)``: the HEALPix RING-scheme pixel centres
  (12 nside^2 equal-area directions), host numpy;
- ``cell_field``: the volume-averaged per-cell rho and n_H^2 of the
  binned particles, sum_slots f_p (m_p / rho_p) / V_cell (K34 on CUDA
  tensors);
- ``march``: the midpoint integral of a per-cell field along straight
  rays, a fixed number of samples each (K35 on CUDA tensors);
- ``column_density_map``: columns from each particle to the domain edge
  along given directions;
- ``treeray_ionisation``: OnTheSpot ionisation with shadowing, particle i
  ionised by source s when Ndot_s / (4 pi d_is^2) >= alphaB int n_H^2 dl
  along the ray from i toward s.

K34 and K35 live in ``csrc/radiation.cu``; their plain versions
(``cell_field_plain``, ``march_plain``) repeat the JAX arithmetic and run
on CPU tensors.  The ray set-up around K35 (directions, lengths, the
flux test) is elementwise torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _ext
from . import sph_grid27 as g27

Tensor = torch.Tensor

# (ray, sample) pairs per chunk of rays in the plain version of K35
_CHUNK_SAMPLES = 1 << 24


# ---------------------------------------------------------------------------
# HEALPix RING-scheme pixel centres (chealpix pix2vec_ring)
# ---------------------------------------------------------------------------

def healpix_directions(nside: int) -> np.ndarray:
    """(12 nside^2, 3) unit vectors of the HEALPix RING pixel centres
    (Gorski et al. 2005, eqs. 2-6).

    North polar cap: rings i = 1..nside-1 with 4i pixels,
        z = 1 - i^2/(3 nside^2),  phi = (pi/2i)(j + 1/2).
    Equatorial belt: rings i = nside..3*nside with 4 nside pixels,
        z = 4/3 - 2i/(3 nside),   phi = (pi/2ns)(j + s/2),
        s = (i - nside + 1) mod 2.
    The south cap mirrors the north."""
    n = nside
    npix = 12 * n * n
    ncap = 2 * n * (n - 1)
    z = np.empty(npix)
    phi = np.empty(npix)

    def cap_ring(p):
        """Ring index i >= 1 such that 2 i (i-1) <= p < 2 (i+1) i."""
        i = ((1.0 + np.sqrt(1.0 + 2.0 * p)) / 2.0).astype(np.int64)
        i = np.maximum(i, 1)
        over = 2 * i * (i - 1) > p
        while over.any():
            i = i - over.astype(np.int64)
            over = 2 * i * (i - 1) > p
        under = 2 * (i + 1) * i <= p
        while under.any():
            i = i + under.astype(np.int64)
            under = 2 * (i + 1) * i <= p
        return i

    if ncap > 0:
        p = np.arange(ncap)
        i = cap_ring(p)
        j = p - 2 * i * (i - 1)
        z[:ncap] = 1.0 - (i * i) / (3.0 * n * n)
        phi[:ncap] = (np.pi / (2.0 * i)) * (j + 0.5)
        # the south cap: mirrored, with the in-ring order reversed
        q = npix - 1 - np.arange(npix - ncap, npix)
        i_s = cap_ring(q)
        j_s = q - 2 * i_s * (i_s - 1)
        z[npix - ncap:] = -(1.0 - (i_s * i_s) / (3.0 * n * n))
        phi[npix - ncap:] = (np.pi / (2.0 * i_s)) * (4 * i_s - j_s - 0.5)

    belt = np.arange(ncap, npix - ncap) - ncap
    i_b = belt // (4 * n) + n
    j_b = belt % (4 * n)
    z[ncap:npix - ncap] = 4.0 / 3.0 - (2.0 * i_b) / (3.0 * n)
    s = (i_b - n + 1) % 2
    phi[ncap:npix - ncap] = (np.pi / (2.0 * n)) * (j_b + 0.5 * s)

    st = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([st * np.cos(phi), st * np.sin(phi), z], axis=-1)


# ---------------------------------------------------------------------------
# K34: per-cell fields
# ---------------------------------------------------------------------------

def cell_volume(spec) -> float:
    v = 1.0
    for k in range(spec.ndim):
        v *= spec.extents[k] / spec.ncells[k]
    return v


def cell_field(spec, b: g27.GridBinning, m: Tensor, rho: Tensor,
               mu_bar: float = 1.0):
    """Volume-averaged per-cell (rho, n_H^2), each of shape *ncells, from
    the binned particles: <f> = sum_slots f_p (m_p / rho_p) / V_cell.
    K34 on CUDA tensors."""
    if m.is_cuda:
        rho_c, nh2_c = _ext.cell_field(spec, b.cell_of, b.slot_of,
                                       m.contiguous(), rho.contiguous(),
                                       mu_bar, cell_volume(spec))
        shape = tuple(spec.ncells)
        return rho_c.reshape(shape), nh2_c.reshape(shape)
    return cell_field_plain(spec, b, m, rho, mu_bar)


def cell_field_plain(spec, b: g27.GridBinning, m: Tensor, rho: Tensor,
                     mu_bar: float = 1.0):
    """Plain version of K34: the JAX function's dense slots and sums."""
    vol_cell = cell_volume(spec)
    fill = g27.dense_fill_mask(spec, b)
    dense_w = torch.where(fill, g27.to_dense(
        spec, b, m / torch.clamp_min(rho, 1e-30)), 0.0)
    rho_d = torch.where(fill, g27.to_dense(spec, b, rho), 0.0)
    rho_cell = torch.sum(dense_w * rho_d, dim=-1) / vol_cell
    nh2_cell = torch.sum(dense_w * (rho_d / mu_bar) ** 2, dim=-1) / vol_cell
    return rho_cell, nh2_cell


# ---------------------------------------------------------------------------
# K35: ray marching
# ---------------------------------------------------------------------------

def cell_indexer(spec, dtype, device):
    """The map (..., nd) positions -> (flat cell index int64, inside
    mask) of `spec`'s grid: periodic dims wrap as lo + jnp.mod(x - lo,
    extent) (the remainder takes the extent's sign), open dims mask,
    floor((x - lo) inv_cell) with inv_cell = ncells / extent."""
    nd = spec.ndim
    lo = torch.tensor(spec.lo[:nd], dtype=dtype, device=device)
    ext = torch.tensor(spec.extents[:nd], dtype=dtype, device=device)
    inv = torch.tensor([spec.ncells[k] / spec.extents[k] for k in range(nd)],
                       dtype=dtype, device=device)
    ncells = torch.tensor(spec.ncells[:nd], dtype=torch.int32, device=device)
    strides = [1] * nd
    for k in range(nd - 2, -1, -1):
        strides[k] = strides[k + 1] * spec.ncells[k + 1]
    periodic = [k for k in range(nd) if spec.periodic[k]]

    def index(pos: Tensor):
        if periodic:
            pos = pos.clone()
            for k in periodic:
                rem = torch.fmod(pos[..., k] - lo[k], ext[k])
                rem = torch.where((rem != 0) & ((rem < 0) != (ext[k] < 0)),
                                  rem + ext[k], rem)
                pos[..., k] = lo[k] + rem
        ix = torch.floor((pos - lo) * inv).to(torch.int32)
        inside = torch.all((ix >= 0) & (ix < ncells), dim=-1)
        ix = torch.minimum(torch.clamp_min(ix, 0), ncells - 1).long()
        flat = ix[..., nd - 1]
        for k in range(nd - 1):
            flat = flat + ix[..., k] * strides[k]
        return flat, inside

    return index


def flat_cell_index(spec, pos: Tensor):
    """(..., nd) positions -> (flat cell index int64, inside mask) of
    `spec`'s grid (cell_indexer)."""
    return cell_indexer(spec, pos.dtype, pos.device)(pos)


def march(spec, field: Tensor, r0: Tensor, dirs: Tensor, lengths: Tensor,
          n_steps: int) -> Tensor:
    """Integrate the per-cell `field` (shape *ncells) along straight rays
    r(t) = r0 + t dir, t in (0, length), by the midpoint rule with
    n_steps samples.  r0 (N, nd); dirs (N, D, nd), or (D, nd) shared by
    every particle; lengths (N, D).  Returns the (N, D) integrals.  K35
    on CUDA tensors."""
    if r0.is_cuda:
        return _ext.ray_march(spec, field.reshape(-1).contiguous(),
                              r0.contiguous(), dirs.contiguous(),
                              lengths.contiguous(), n_steps)
    return march_plain(spec, field, r0, dirs, lengths, n_steps)


def march_plain(spec, field: Tensor, r0: Tensor, dirs: Tensor,
                lengths: Tensor, n_steps: int) -> Tensor:
    """Plain version of K35: every sample position formed as the JAX
    function forms it, r0 + (length t) dir with t = (k + 0.5) / n_steps,
    over chunks of rays."""
    N, D = lengths.shape
    if dirs.dim() == 2:
        dirs = dirs.expand(N, D, dirs.shape[-1])
    ts = (torch.arange(n_steps, device=r0.device).to(r0.dtype) + 0.5) \
        / n_steps
    flat_field = field.reshape(-1)
    out = torch.empty((N, D), dtype=r0.dtype, device=r0.device)
    chunk = max(1, _CHUNK_SAMPLES // max(D * n_steps, 1))
    for a in range(0, N, chunk):
        ln = lengths[a:a + chunk]
        pos = r0[a:a + chunk, None, None, :] + (
            ln[..., None, None] * ts[None, None, :, None]
            * dirs[a:a + chunk, :, None, :])
        flat, inside = flat_cell_index(spec, pos)
        samp = torch.where(inside, flat_field[flat], 0.0)
        out[a:a + chunk] = torch.sum(samp, dim=-1) * ln / n_steps
    return out


def column_density_map(spec, rho_cell: Tensor, r: Tensor,
                       dirs: np.ndarray, n_steps: int = 32) -> Tensor:
    """(N, D) column densities int rho dl from each particle to the
    domain edge along each direction (the TreeRay ambient integral)."""
    nd = spec.ndim
    lo = torch.tensor(spec.lo[:nd], dtype=r.dtype, device=r.device)
    hi = lo + torch.tensor(spec.extents[:nd], dtype=r.dtype,
                           device=r.device)
    d = torch.as_tensor(np.asarray(dirs), dtype=r.dtype, device=r.device)
    eps = 1e-30
    safe = torch.where(torch.abs(d) > eps, d, eps)[None, :, :]
    t_hi = (hi[None, None, :] - r[:, None, :]) / safe
    t_lo = (lo[None, None, :] - r[:, None, :]) / safe
    t_exit = torch.amin(torch.maximum(t_hi, t_lo), dim=-1)
    t_exit = torch.clamp_min(t_exit, 0.0)
    return march(spec, rho_cell, r, d, t_exit, n_steps)


def treeray_ionisation(spec, nh2_cell: Tensor, r: Tensor, r_src: Tensor,
                       ndot_src: Tensor, active_src: Tensor, alphaB: float,
                       n_steps: int = 48) -> Tensor:
    """OnTheSpot ionisation with shadowing (TreeRayOnTheSpot): particle i
    is ionised by source s when the photon flux at i exceeds the
    recombinations along the path,
        ndot_s / (4 pi d_is^2)  >=  alphaB int_0^d n_H^2 dl.
    The rays run from each particle toward each source, min-imaged on
    periodic dims.  Returns the (N,) ionised mask (any source)."""
    dr = r_src[None, :, :] - r[:, None, :]
    for k in range(spec.ndim):
        if spec.periodic[k]:
            ext = spec.extents[k]
            dr[..., k] = dr[..., k] + (-ext * torch.round(dr[..., k] / ext))
    d = torch.sqrt(torch.sum(dr * dr, dim=-1))
    dirs = dr / torch.clamp_min(d, 1e-30)[..., None]
    integral = march(spec, nh2_cell, r, dirs, d, n_steps)
    flux = ndot_src[None, :] / (4.0 * math.pi
                                * torch.clamp_min(d, 1e-30) ** 2)
    ion = (flux >= alphaB * integral) & active_src[None, :] \
        & (ndot_src[None, :] > 0.0)
    return torch.any(ion, dim=-1)
