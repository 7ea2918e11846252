"""Active-subset hydro pass over the structured grid: the density (K8)
and forces (K9) of a listed subset of particles, the pair work of a
block-timestep tick; and the neighbour-level pass (K22) of the dense
block tick (with sinks or dust, and of block MFV); each in 1-3 dims.

Counterpart of ``gandalf_tpu/ops/active_grid.py``.  Every particle is
binned (K1) into the grid's dense slot map, which holds each slot's
particle id (-1 empty); the pair work is done only for the listed
particles, each over the 3^ndim cells around its own (wrapped
indices, ±L shifts on periodic dims).  The JAX package gathers an
(n_cap, 3^ndim K) candidate block per listed particle from ghost-layer
copies (``gather_active_candidates``) and pads the list to a power of two
with masked rows; the port walks the cells in place and does not pad.

Order inside the pass, as in the JAX package: K8's h, rho, invomega,
zeta, hfactor and the EOS values of the listed rows are written back to
the particle arrays before K9 runs, so K9 reads fresh values for listed
neighbours and their last values (with the tick's EOS refresh) for the
others.  The neighbour-level scatter of K9 (Saitoh-Makino ``levelneib``)
runs with or without hydro forces.

Each kernel has a plain PyTorch version here (the candidate gather of
the JAX package followed by ``ops/density.py:compute_h`` or
``ops/forces.py:compute_hydro_forces``) and a CUDA C++ kernel in
``csrc/``, launched through ``_ext``.  A CPU tensor takes the plain
version; a CUDA tensor takes the kernel, or the wrapper raises.

``levelneib_grid27`` is gandalf_tpu/sim/simulation.py:_levelneib_pass
(:1682-1702) and gandalf_tpu/sim/mfv_sim.py:_levelneib_pass (:345-363),
the same pass: every alive particle's largest neighbour level within
kernrange * max(h_i, h_j), itself included, over the alive particles
binned into the grid (the dead binned out); it overwrites levelneib, and
the dead get 0.  Unlike K9's scatter, it is one-sided.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..state import SphState
from . import sph_grid27 as g27
from .density import finish_h, iterate_h
from .forces import NeighborView, compute_hydro_forces

Tensor = torch.Tensor


def dense_ids(spec: g27.Grid27Spec, b: g27.GridBinning) -> Tensor:
    """K1's slot map: (*ncells, K) int32 particle id per slot, -1
    empty; discarded particles (virtual cell C) take no slot."""
    K, C = spec.k_cell, spec.total_cells
    N = b.cell_of.shape[0]
    dev = b.cell_of.device
    ids = torch.full(((C + 1) * K,), -1, dtype=torch.int32, device=dev)
    ids[g27._flat_slot(spec, b)] = torch.arange(N, dtype=torch.int32,
                                                device=dev)
    return ids[:C * K].reshape(tuple(spec.ncells) + (K,))


def _row_chunk(n_cand: int, device) -> int:
    """Listed rows per chunk of a plain version: at most 2^25 candidates
    per chunk on a GPU, 2^21 on a CPU."""
    budget = 1 << 25 if device.type == "cuda" else 1 << 21
    return max(1, budget // max(n_cand, 1))


def _compact_columns(keep: Tensor, *xs: Tensor):
    """Per row, the columns where `keep` holds moved to the front in
    their order, and every array cut to the largest count: (keep, *xs)
    on (n, c) columns."""
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    c = int(keep.sum(1).max()) if keep.numel() else 0
    order = order[:, :c]

    def take(x):
        ix = order if x.dim() == 2 else order[..., None].expand(
            -1, -1, x.shape[-1])
        return torch.gather(x, 1, ix)

    return (take(keep),) + tuple(take(x) for x in xs)


def gather_active_candidates(spec: g27.Grid27Spec, cell_of: Tensor,
                             ids_d: Tensor, r: Tensor, idx: Tensor):
    """The S K candidates of each listed particle, S = 3^ndim: ids
    (n, S K) int64 (-1 invalid) and dr = r_cand - r_i (n, S K, ndim)
    with periodic shifts applied.  The particle itself is among its
    candidates."""
    K, nd = spec.k_cell, spec.ndim
    S = 3 ** nd
    nb, off, ok = g27._neighbour_table(spec, r.device)
    il = idx.long()
    c = cell_of[il].long()
    cand = ids_d.reshape(-1, K)[nb[c]].long()              # (n, S, K)
    cand = torch.where(ok[c][..., None], cand, -1).reshape(il.numel(), -1)
    shift = off[c].to(r.dtype)                              # (n, S, nd)
    r_c = r[torch.clamp_min(cand, 0)].reshape(il.numel(), S, K, nd)
    dr = ((r_c + shift[:, :, None, :]).reshape(il.numel(), S * K, nd)
          - r[il][:, None, :])
    return cand, dr


# ---------------------------------------------------------------------------
# K8: the listed particles' h-rho iteration
# ---------------------------------------------------------------------------

def active_density(kern, spec: g27.Grid27Spec, h_fac: float,
                   h_converge: float, hmax: float, idx: Tensor,
                   cell_of: Tensor, ids_d: Tensor, r: Tensor, m: Tensor,
                   h: Tensor):
    """(rho, invom, zeta) sums at each listed particle's final h and its
    converged flag, each (n,).  K8 on CUDA tensors."""
    if r.is_cuda:
        return _ext.active_density(spec, kern, h_fac, h_converge, hmax,
                                   idx, cell_of, ids_d, r, m, h)
    return active_density_plain(kern, spec, h_fac, h_converge, hmax, idx,
                                cell_of, ids_d, r, m, h)


def active_density_plain(kern, spec, h_fac, h_converge, hmax, idx, cell_of,
                         ids_d, r, m, h):
    """Plain version of K8: gandalf_tpu's candidate gather and compute_h
    (from the rows' own h, bracket [0, hmax], no clamp) over chunks of
    listed rows.  The iteration runs on the candidates within kernrange
    times a bound on h (the rows' largest h or hmax); every term beyond
    is exactly zero.  A row whose h passes the bound (a fixed-point step
    can) has its chunk redone on all its candidates."""
    il = idx.long()
    step = _row_chunk(3 ** spec.ndim * spec.k_cell, r.device)
    parts = []
    for c0 in range(0, il.numel(), step):
        sel = il[c0:c0 + step]
        cand, dr = gather_active_candidates(spec, cell_of, ids_d, r, sel)
        mask = cand >= 0
        m_j = torch.where(mask, m[torch.clamp_min(cand, 0)], 0.0)
        d2 = torch.sum(dr * dr, dim=-1)
        h_bound = max(float(h[sel].max()), hmax)
        near = mask & (d2 <= (kern.kernrange * h_bound) ** 2
                       * (1.0 + 1e-6))
        args = _compact_columns(near, d2, m_j)
        out = iterate_h(kern, spec.ndim, h_fac, h_converge, m[sel], h[sel],
                        args[1], args[2], args[0], hmax)
        if float(out[4]) > h_bound:
            out = iterate_h(kern, spec.ndim, h_fac, h_converge, m[sel],
                            h[sel], d2, m_j, mask, hmax)
        parts.append(out[:4])
    if not parts:
        empty = torch.zeros((0,), dtype=r.dtype, device=r.device)
        return (empty, empty, empty,
                torch.zeros((0,), dtype=torch.bool, device=r.device))
    return tuple(torch.cat(x) for x in zip(*parts))


# ---------------------------------------------------------------------------
# K9: the listed particles' pair forces and the levelneib scatter
# ---------------------------------------------------------------------------

def active_forces(kern, visc, spec: g27.Grid27Spec, idx: Tensor,
                  cell_of: Tensor, ids_d: Tensor, r: Tensor, v: Tensor,
                  packed: Tensor, level: Tensor, levelneib: Tensor,
                  hydro_forces: bool):
    """a (n, ndim), dudt and div_v (n,) of the listed particles (zero
    without hydro forces) and levelneib (N,) raised by the neighbour
    levels in both directions.  `packed` (N, 9) holds
    ops.sph_grid27.FORCE_SCALARS per particle.  K9 on CUDA tensors."""
    if r.is_cuda:
        return _ext.active_forces(spec, kern, visc, idx, cell_of, ids_d, r,
                                  v, packed, level, levelneib, hydro_forces)
    return active_forces_plain(kern, visc, spec, idx, cell_of, ids_d, r, v,
                               packed, level, levelneib, hydro_forces)


def active_forces_plain(kern, visc, spec, idx, cell_of, ids_d, r, v,
                        packed, level, levelneib, hydro_forces):
    """Plain version of K9: gandalf_tpu's candidate gather, its
    compute_hydro_forces and its two scatter-max passes of levelneib (a
    candidate within kernrange * max(h_i, h_j), the particle itself
    included), over chunks of listed rows."""
    col = {k: i for i, k in enumerate(g27.FORCE_SCALARS)}
    il = idx.long()
    dt, dev = r.dtype, r.device
    a = torch.zeros((il.numel(), spec.ndim), dtype=dt, device=dev)
    dudt = torch.zeros((il.numel(),), dtype=dt, device=dev)
    div_v = torch.zeros((il.numel(),), dtype=dt, device=dev)
    lneib = levelneib.clone()
    step = _row_chunk(3 ** spec.ndim * spec.k_cell, dev)
    for c0 in range(0, il.numel(), step):
        sel = il[c0:c0 + step]
        cand, dr = gather_active_candidates(spec, cell_of, ids_d, r, sel)
        mask = cand >= 0
        cid = torch.clamp_min(cand, 0)
        h_i = packed[sel, col["h"]]
        h_j = torch.where(mask, packed[cid, col["h"]], 1.0)
        # d^2 and the support radius in the kernel's rounding steps
        d2 = dr[..., 0] * dr[..., 0]
        for k in range(1, spec.ndim):
            d2 = d2 + dr[..., k] * dr[..., k]
        rad = kern.kernrange * torch.maximum(h_i[:, None], h_j)
        within = mask & (d2 <= rad * rad)
        zero = torch.zeros_like(cand)
        lvl_cand = torch.where(within, level[cid], zero).amax(dim=1)
        lneib.scatter_reduce_(0, sel, lvl_cand.to(lneib.dtype), "amax")
        lvl_i = level[sel][:, None].expand_as(cand)
        lneib.scatter_reduce_(0, cid[within], lvl_i[within], "amax")
        if not hydro_forces:
            continue
        # beyond kernrange * max(h_i, h_j) every pair term is exactly 0
        mask, cid, dr = _compact_columns(within, cid, dr)
        pj = packed[cid]                                    # (n, c, 9)
        pi = packed[sel]

        def nbr(key, empty):
            return torch.where(mask, pj[..., col[key]], empty)

        nb = NeighborView(
            dr=dr, v=torch.where(mask[..., None], v[cid], 0.0),
            m=nbr("m", 0.0), h=nbr("h", 1.0), rho=nbr("rho", 1.0),
            u=nbr("u", 0.0), pressure=nbr("pressure", 0.0),
            sound=nbr("sound", 0.0), invomega=nbr("invomega", 1.0),
            hfactor=nbr("hfactor", 0.0), alpha=nbr("alpha", 0.0),
            mask=mask)
        f = compute_hydro_forces(
            kern, visc, v[sel], h_i, pi[:, col["rho"]], pi[:, col["u"]],
            pi[:, col["pressure"]], pi[:, col["sound"]],
            pi[:, col["invomega"]], pi[:, col["hfactor"]],
            pi[:, col["alpha"]], nb)
        a[c0:c0 + step] = f.a
        dudt[c0:c0 + step] = f.dudt
        div_v[c0:c0 + step] = f.div_v
    return a, dudt, div_v, lneib


# ---------------------------------------------------------------------------
# The active hydro pass
# ---------------------------------------------------------------------------

def active_hydro_pass(kern, visc, spec: g27.Grid27Spec, eos, h_fac: float,
                      h_converge: float, s: SphState, idx: Tensor,
                      hydro_forces: bool = True):
    """Density, EOS and hydro forces of the particles idx (n,) int32 only.
    Returns (state, overflow): only rows idx change (and levelneib where
    a neighbour was raised); every other particle keeps its values.
    Overflow: a cell held more than K particles, or a listed particle did
    not converge or its h passed 0.99 hmax."""
    if spec.mirror or spec.qz != 1:
        raise NotImplementedError(
            "mirror layers and z-slab plans are not ported yet (ROADMAP "
            "queue 1, items 8 and 13)")
    b = g27.bin_particles(spec, s.r)
    hmax = g27.hmax_of(spec, kern.kernrange)
    ids_d = dense_ids(spec, b)
    sums = active_density(kern, spec, h_fac, h_converge, hmax, idx,
                          b.cell_of, ids_d, s.r, s.m, s.h)
    il = idx.long()
    dens = finish_h(spec.ndim, h_fac, s.m[il], *sums)
    eos_kw = {"ionfrac": s.ionfrac[il]} if eos.needs_ionfrac else {}
    u_a, press_a, sound_a = eos.thermal_update(
        torch.clamp_min(dens.rho, 1e-30), s.u[il], **eos_kw)

    def put(f, x):
        return f.index_copy(0, il, x)

    s = s.replace(h=put(s.h, dens.h), rho=put(s.rho, dens.rho),
                  invomega=put(s.invomega, dens.invomega),
                  zeta=put(s.zeta, dens.zeta),
                  hfactor=put(s.hfactor, dens.hfactor), u=put(s.u, u_a),
                  pressure=put(s.pressure, press_a),
                  sound=put(s.sound, sound_a))
    packed = torch.stack([getattr(s, k) for k in g27.FORCE_SCALARS], -1)
    a, dudt, div_v, lneib = active_forces(
        kern, visc, spec, idx, b.cell_of, ids_d, s.r, s.v, packed, s.level,
        s.levelneib, hydro_forces)
    s = s.replace(a=put(s.a, a), dudt=put(s.dudt, dudt),
                  div_v=put(s.div_v, div_v), levelneib=lneib)
    overflow = b.overflow | torch.any(~dens.converged) | torch.any(
        dens.h > 0.99 * hmax)
    return s, overflow


# ---------------------------------------------------------------------------
# K22: the neighbour-level pass of the dense block tick
# ---------------------------------------------------------------------------

def levelneib_grid27(kern, spec: g27.Grid27Spec, r: Tensor, h: Tensor,
                     level: Tensor, alive: Tensor, b=None) -> Tensor:
    """The largest level (N,) int32 among each alive particle's alive
    candidates within kernrange * max(h_i, h_j) (itself included), 0 for
    the dead, in 1-3 dims.  K1 (with the dead discarded; `b`, a binning
    of r with them discarded, is taken where given), then K22 on CUDA
    tensors."""
    if spec.mirror or spec.qz != 1:
        raise NotImplementedError(
            "the neighbour-level pass takes grids without mirror layers "
            "(ROADMAP queue 1, item 8)")
    if b is None:
        b = g27.bin_particles(spec, r, discard=~alive)
    ids_d = dense_ids(spec, b)
    if r.is_cuda:
        return _ext.levelneib(spec, kern, ids_d, r, h, level)
    return levelneib_plain(kern, spec, b.cell_of, ids_d, r, h, level, alive)


def levelneib_plain(kern, spec, cell_of, ids_d, r, h, level, alive):
    """Plain version of K22: gandalf_tpu's candidate gather over chunks
    of the alive particles, d^2 summed and the radius squared as there."""
    out = torch.zeros_like(level)
    idx = torch.nonzero(alive).flatten()
    step = _row_chunk(3 ** spec.ndim * spec.k_cell, r.device)
    for c0 in range(0, idx.numel(), step):
        sel = idx[c0:c0 + step]
        cand, dr = gather_active_candidates(spec, cell_of, ids_d, r, sel)
        mask = cand >= 0
        cid = torch.clamp_min(cand, 0)
        d2 = dr[..., 0] * dr[..., 0]
        for k in range(1, spec.ndim):
            d2 = d2 + dr[..., k] * dr[..., k]
        rad = kern.kernrange * torch.maximum(h[sel][:, None], h[cid])
        near = mask & (d2 <= rad * rad)
        out[sel] = torch.where(near, level[cid],
                               torch.zeros_like(cand, dtype=level.dtype)
                               ).amax(dim=1)
    return out
