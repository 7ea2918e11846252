"""Barnes-Hut gravity over host-planned KD buckets: bucket gather (K4),
tree moments (K5), frontier walk with far field (K6) and near field
(K7).

Counterpart of ``gandalf_tpu/ops/tree.py`` for the frontier walk with
the geometric, gadget2 or eigenmac MAC, monopole or quadrupole moments
evaluated at every particle or expanded about each group's box centre
(the fast multipoles), with or without the Ewald sum of a periodic box
(``ops/ewald.py``).  The host part (``TreeSpec``, the cap laws and the
planners) is numpy; the planners call the port's copy of the C++ library
(``native``) through its ctypes signatures and raise when it cannot be
built, since the numpy KD planner and the worst-case cap law are not
ported.

The device part works on two tables, in ndim = 1, 2 or 3 dims (the
columns of ``layout(ndim)``; ndim is read from the tables' widths, as
the JAX package reads it from r's):

- the slot table ``ptab`` (G*L, ndim + 3): x[ndim], m, h, zh of every
  bucket slot, in bucket order, with positions unwrapped per bucket
  about its first real slot (periodic dims), and ``alive`` (G*L,) bool.
  An empty slot has m = 0, h = 1, zh = 0, position 0 and alive False;
- the cell table ``ctab`` (2^(D+1) - 1, 1 + 3 ndim + ndim (ndim + 1) /
  2: 16, 10 or 5): row (1 << l) - 1 + c is cell c of level l, leaves at
  level D, columns m, com[ndim], half[ndim], the quadrupole's upper
  triangle in the JAX package's ``tri`` order and centre[ndim].  An
  empty cell has m = 0 and COM and box at the far sentinel.

Below 3D the quadrupole is the JAX package's 3 sum m dr dr^T - tr I,
which is not traceless there; the Ewald sum is 3D only, as in the JAX
package.

Each kernel has a plain PyTorch version in this module and a CUDA C++
kernel in ``csrc/``, launched through ``_ext``.  A CPU tensor takes the
plain version; a CUDA tensor takes the kernel, or the wrapper raises.

Three places differ from the JAX package on purpose (ROADMAP queue 3):
pair separations are computed directly, not from a dot-product
expansion; each near pair is evaluated once (F6): with the symmetric
softened formula where d < kernrange * max(h_i, h_j), with the Newtonian
one elsewhere, where the two are equal; and a group without live slots
walks nothing (the JAX package walks it from its far-sentinel centre,
which under the Ewald min-image can open cells and raise overflow, with
no effect on any live particle's result).  Self pairs are excluded by
identity and coincident pairs by d^2 = 0 (F2).  The two agree in
float64; in float32 the port keeps the close pairs' digits.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _ext, native
from . import ewald as ew

Tensor = torch.Tensor

# far sentinel of empty cells, and the bound of min/max over live slots
# (gandalf_tpu build_tree's `far` and `big`)
FAR = 1e15
BIG = 1e30


def tri(ndim: int) -> tuple:
    """(i, j), i <= j, of the quadrupole's columns: the upper triangle
    row by row (gandalf_tpu/ops/tree.py:342)."""
    return tuple((i, j) for i in range(ndim) for j in range(i, ndim))


# the 3D order
_TRI = tri(3)


class Layout(NamedTuple):
    """Columns of the slot and cell tables and width of a group's fast
    expansion in `ndim` dims (csrc/tree.cuh's Layout<NDIM>)."""

    ndim: int
    pcols: int      # slot table: x[ndim], m, h, zh
    p_m: int
    p_h: int
    p_zh: int
    ccols: int      # cell table: m, com, half, q (tri order), centre
    c_com: int
    c_half: int
    c_q: int
    c_cen: int
    nq: int
    fast_cols: int  # a0[ndim], pot0, Jacobian row by row
    tri: tuple


def layout(ndim: int) -> Layout:
    if ndim not in (1, 2, 3):
        raise ValueError(f"the tree takes 1-3 dims, not {ndim}")
    nq = ndim * (ndim + 1) // 2
    return Layout(ndim=ndim, pcols=ndim + 3, p_m=ndim, p_h=ndim + 1,
                  p_zh=ndim + 2, ccols=1 + 3 * ndim + nq, c_com=1,
                  c_half=1 + ndim, c_q=1 + 2 * ndim,
                  c_cen=1 + 2 * ndim + nq, nq=nq,
                  fast_cols=ndim + 1 + ndim * ndim, tri=tri(ndim))


def table_ndim(ptab: Tensor) -> int:
    """The dims of a slot table (G*L, ndim + 3)."""
    return layout(ptab.shape[1] - 3).ndim


C_M = 0
EWALD_BELOW_3D = ("Ewald periodic self-gravity requires a 3D box "
                  "(matches the reference, Ewald.cpp ndim == 3 guard)")


def require_3d_ewald(ndim: int, ewald) -> None:
    """Refuse an Ewald sum below 3D, as the JAX package does
    (gandalf_tpu/sim/simulation.py:908-911)."""
    if ewald is not None and ndim != 3:
        raise NotImplementedError(EWALD_BELOW_3D)


# ---------------------------------------------------------------------------
# Host part: geometry, caps and planners
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Static tree geometry (same fields as gandalf_tpu's TreeSpec)."""

    n_pad: int          # padded particle count (power-of-two multiple of L)
    leaf_size: int      # L
    depth: int          # number of levels below the root (leaves at `depth`)
    frontier: int       # max opened cells per level (W)
    theta_sqd: float    # geometric MAC opening angle^2
    quadrupole: bool = True
    fast: bool = False
    near_cap: int = 0   # max near-field leaves per group (Wn)
    group_chunk: int = 32
    support_cap: int = 64   # max kernel-support leaves per group (Ws)
    mac: str = "geometric"
    macerror: float = 1e-4
    mp_cap: int = 0
    # per-level frontier caps (depth+1 ints; entry l = padded width
    # entering level l), or None for min(frontier, 2^l)
    frontier_levels: tuple = None

    @property
    def n_leaves(self) -> int:
        return self.n_pad // self.leaf_size

    def level_cap(self, ell: int) -> int:
        """Width of the frontier entering level `ell` (ell >= 1)."""
        w = min(self.frontier, 1 << ell)
        if self.frontier_levels is not None:
            w = min(w, self.frontier_levels[ell])
        return w


def plan_tree(N: int, leaf_size: int = 32, frontier: int = None,
              theta_sqd: float = 0.1, quadrupole: bool = True,
              fast: bool = False, near_cap: int = None) -> TreeSpec:
    """gandalf_tpu's plan_tree: the worst-case cap law where no cap is
    given.  `group_chunk` is set as the JAX package sets it, so that the
    two specs compare equal; the port's plain versions chunk by
    `_chunk_groups` instead."""
    n_leaves = max(1, -(-N // leaf_size))
    n_leaves = 1 << int(np.ceil(np.log2(n_leaves)))
    if near_cap is None:
        near_cap = int(13.0 * leaf_size
                       * (0.1 / max(theta_sqd, 1e-3)) ** 1.5) + 48
        near_cap = min(near_cap, n_leaves)
    if frontier is None:
        frontier = min(max(2 * near_cap, 64), 2 * n_leaves)
    group_chunk = int(np.clip(2 ** 24 // max(leaf_size * leaf_size
                                             * near_cap, 1), 8, 128))
    return TreeSpec(n_pad=n_leaves * leaf_size, leaf_size=leaf_size,
                    depth=int(np.log2(n_leaves)), frontier=frontier,
                    theta_sqd=theta_sqd, quadrupole=quadrupole, fast=fast,
                    near_cap=near_cap, group_chunk=group_chunk)


def grow_tree_caps(spec: TreeSpec, factor: float = 1.6) -> TreeSpec:
    """Cap growth after an overflow; never shrinks a cap."""
    fl = spec.frontier_levels
    if fl is not None:
        fl = tuple(max(w, min(int(w * factor) + 16,
                              min(1 << ell, 2 * spec.n_leaves)))
                   for ell, w in enumerate(fl))
    return dataclasses.replace(
        spec,
        near_cap=max(spec.near_cap,
                     min(int(spec.near_cap * factor) + 8, spec.n_leaves)),
        frontier=max(spec.frontier,
                     min(int(spec.frontier * factor) + 16,
                         2 * spec.n_leaves)),
        support_cap=max(spec.support_cap,
                        min(int(spec.support_cap * factor) + 8,
                            spec.n_leaves)),
        frontier_levels=fl)


def plan_tree_for_buckets(gmap: np.ndarray, theta_sqd: float = 0.1,
                          quadrupole: bool = True, fast: bool = False,
                          near_cap: int = None, frontier: int = None,
                          mac: str = "geometric",
                          macerror: float = 1e-4) -> TreeSpec:
    """TreeSpec matching a bucket gather map; eigenmac needs the
    quadrupole moments, so it switches them on."""
    G_pad, L = gmap.shape
    spec = plan_tree(G_pad * L, leaf_size=L, theta_sqd=theta_sqd,
                     quadrupole=quadrupole or mac == "eigenmac",
                     fast=fast, near_cap=near_cap, frontier=frontier)
    assert spec.n_pad == G_pad * L, (spec.n_pad, gmap.shape)
    return dataclasses.replace(spec, mac=mac, macerror=macerror)


def native_planner():
    """The C++ planner library (``native``); raises when g++ cannot
    build it."""
    return native.load()


def plan_buckets_kd(r: np.ndarray, leaf_size: int) -> np.ndarray:
    """Balanced KD buckets by the C++ planner: gather map (G_pad, L)
    int32, -1 = empty slot, G_pad a power of two."""
    lib = native_planner()
    N, ndim = r.shape
    r_c = np.ascontiguousarray(r, dtype=np.float64)
    g_max = 1
    while g_max * leaf_size < 2 * N + leaf_size:
        g_max *= 2
    gmap = np.full((g_max, leaf_size), -1, np.int32)
    n_used = lib.kd_plan_buckets(r_c.ctypes.data, N, ndim, leaf_size,
                                 gmap.ctypes.data, g_max)
    if n_used <= 0:
        raise RuntimeError(f"kd_plan_buckets failed ({n_used}) for "
                           f"N = {N}, ndim = {ndim}")
    G_pad = 1 << int(np.ceil(np.log2(max(n_used, 1))))
    return np.ascontiguousarray(gmap[:G_pad])


def walk_stats_levels_native(r: np.ndarray, gmap: np.ndarray,
                             theta_sqd: float, m: np.ndarray = None,
                             h: np.ndarray = None, kernrange: float = 2.0,
                             sample: int = 2048):
    """Measured walk demand by the C++ planner: (near_max, front_max,
    sup_max, per-level frontier maxima (depth+1,))."""
    lib = native_planner()
    G_pad, L = gmap.shape
    depth = int(np.log2(G_pad))
    r_c = np.ascontiguousarray(r, dtype=np.float64)
    g_c = np.ascontiguousarray(gmap, dtype=np.int32)
    m_c = None if m is None else np.ascontiguousarray(m, dtype=np.float64)
    h_c = None if h is None else np.ascontiguousarray(h, dtype=np.float64)
    out = np.zeros(3, dtype=np.int32)
    out_levels = np.zeros(depth + 1, dtype=np.int32)
    rc = lib.tree_walk_stats_levels(
        r_c.ctypes.data, None if m_c is None else m_c.ctypes.data,
        None if h_c is None else h_c.ctypes.data,
        r_c.shape[0], r_c.shape[1], g_c.ctypes.data, G_pad, L,
        float(theta_sqd), float(kernrange), int(sample), out.ctypes.data,
        out_levels.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"tree_walk_stats_levels failed ({rc})")
    return int(out[0]), int(out[1]), int(out[2]), out_levels


# ---------------------------------------------------------------------------
# K4: gather into bucket order, per-bucket periodic unwrap
# ---------------------------------------------------------------------------

def gather_to_buckets(spec: TreeSpec, gmap: Tensor, r: Tensor, m: Tensor,
                      h: Optional[Tensor] = None, zh: Optional[Tensor] = None,
                      periodic_extent=None, alive: Optional[Tensor] = None):
    """Slot table (G*L, ndim + 3) and alive (G*L,) from particle-order
    fields, r (N, ndim), through `gmap` (G, L) int32.  `periodic_extent`
    (per dim, 0 = open) or None.  `alive` (N,) bool, or None for all
    alive: a dead particle keeps its slot's row but its slot is not
    alive (alive_s = in_map & alive[gmap], gandalf_tpu/ops/tree.py:1373).
    K4 on CUDA tensors."""
    if r.is_cuda:
        return _ext.tree_gather(spec, gmap, r, m, h, zh, periodic_extent,
                                alive)
    return gather_to_buckets_plain(spec, gmap, r, m, h, zh, periodic_extent,
                                   alive)


def gather_to_buckets_plain(spec, gmap, r, m, h=None, zh=None,
                            periodic_extent=None, alive=None):
    """Plain version of K4: gandalf_tpu's gather plus unwrap_to_buckets,
    anchored on each bucket's first real slot."""
    G, L = spec.n_leaves, spec.leaf_size
    nd = layout(r.shape[1]).ndim
    flat = gmap.reshape(-1).long()
    in_map = flat >= 0
    safe = torch.clamp_min(flat, 0)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    r_s = torch.where(in_map[:, None], r[safe], zero)
    if periodic_extent is not None:
        r_g = r_s.reshape(G, L, nd)
        first = torch.argmax(in_map.reshape(G, L).to(torch.uint8), dim=1)
        anchor = r_g[torch.arange(G, device=r.device), first]
        delta = r_g - anchor[:, None, :]
        cols = []
        for k in range(nd):
            ext = float(periodic_extent[k])
            d = delta[..., k]
            cols.append(d - ext * torch.round(d / ext) if ext > 0 else d)
        r_u = (anchor[:, None, :] + torch.stack(cols, -1)).reshape(-1, nd)
        r_s = torch.where(in_map[:, None], r_u, zero)
    one = torch.ones((), dtype=r.dtype, device=r.device)
    m_s = torch.where(in_map, m[safe], zero)
    h_s = torch.where(in_map, h[safe], one) if h is not None \
        else one.expand(G * L)
    zh_s = torch.where(in_map, zh[safe], zero) if zh is not None \
        else zero.expand(G * L)
    ptab = torch.cat([r_s, m_s[:, None], h_s[:, None], zh_s[:, None]], -1)
    slot_alive = in_map if alive is None else in_map & alive[safe]
    return ptab.contiguous(), slot_alive


# ---------------------------------------------------------------------------
# K5: cell moments, leaves to root
# ---------------------------------------------------------------------------

def build_tree(spec: TreeSpec, ptab: Tensor, alive: Tensor) -> Tensor:
    """Level-concatenated cell table (2^(D+1) - 1, layout(ndim).ccols).
    K5 on CUDA tensors."""
    if ptab.is_cuda:
        return _ext.tree_build(spec, ptab, alive)
    return build_tree_plain(spec, ptab, alive)


def _div_com(num: Tensor, den: Tensor) -> Tensor:
    safe = torch.clamp_min(den, 1e-30)
    return torch.where((den > 0.0)[..., None], num / safe[..., None], FAR)


def _trace(q: Tensor) -> Tensor:
    tr = q[..., 0, 0]
    for k in range(1, q.shape[-1]):
        tr = tr + q[..., k, k]
    return tr


def _quad_of(q: Tensor) -> Tensor:
    """3 q - tr I (traceless in 3D only, as the JAX package's)."""
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    return 3.0 * q - _trace(q)[..., None, None] * eye


def _clamp_com(com: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """The COM held inside its cell's box (fault F30): sum(m r) / sum(m)
    of a cell with one live particle can round an ulp off that
    particle, outside its zero-width box, and the walk would then take
    the group's own leaf as a far cell at ~1e-17 (gandalf_tpu's
    build_tree does not clamp).  Inside the box the clamp changes
    nothing."""
    return torch.minimum(torch.maximum(com, lo), hi)


def build_tree_plain(spec: TreeSpec, ptab: Tensor,
                     alive: Tensor) -> Tensor:
    """Plain version of K5: gandalf_tpu's build_tree (mass, COM, box over
    live slots and occupied children, far sentinel for empty cells,
    quadrupole 3 q - tr I with dead slots and empty children masked),
    each COM clamped into its box (_clamp_com, fault F30)."""
    G, L = spec.n_leaves, spec.leaf_size
    lay = layout(table_ndim(ptab))
    nd = lay.ndim
    al = alive.reshape(G, L)
    r = ptab[:, :nd].reshape(G, L, nd)
    m = torch.where(al, ptab[:, lay.p_m].reshape(G, L), 0.0)
    m_tot = m.sum(1)
    com = _div_com((m[..., None] * r).sum(1), m_tot)
    lo = torch.where(al[..., None], r, BIG).amin(1)
    hi = torch.where(al[..., None], r, -BIG).amax(1)
    empty = (m_tot <= 0.0)[:, None]
    lo = torch.where(empty, FAR, lo)
    hi = torch.where(empty, FAR, hi)
    com = _clamp_com(com, lo, hi)
    if spec.quadrupole:
        dr = torch.where(al[..., None], r - com[:, None, :], 0.0)
        q = _quad_of(torch.einsum("lp,lpi,lpj->lij", m, dr, dr))
    else:
        q = torch.zeros((G, nd, nd), dtype=r.dtype, device=r.device)
    levels = [(m_tot, com, lo, hi, q)]
    for _ in range(spec.depth):
        m0, c0, lo0, hi0, q0 = levels[0]
        m2 = m0.reshape(-1, 2)
        c2 = c0.reshape(-1, 2, nd)
        mm = m2.sum(1)
        cc = _div_com((m2[..., None] * c2).sum(1), mm)
        occ = (m2 > 0.0)[..., None]
        lo2 = torch.where(occ, lo0.reshape(-1, 2, nd), BIG).amin(1)
        hi2 = torch.where(occ, hi0.reshape(-1, 2, nd), -BIG).amax(1)
        par_empty = (mm <= 0.0)[:, None]
        lo2 = torch.where(par_empty, FAR, lo2)
        hi2 = torch.where(par_empty, FAR, hi2)
        cc = _clamp_com(cc, lo2, hi2)
        if spec.quadrupole:
            d = torch.where(occ, c2 - cc[:, None, :], 0.0)
            dq = torch.einsum("lp,lpi,lpj->lij", m2, d, d)
            qq = (q0.reshape(-1, 2, nd, nd).sum(1) + 3.0 * dq
                  - _trace(dq)[:, None, None] * torch.eye(
                      nd, dtype=dq.dtype, device=dq.device))
        else:
            qq = torch.zeros((mm.shape[0], nd, nd), dtype=r.dtype,
                             device=r.device)
        levels.insert(0, (mm, cc, lo2, hi2, qq))
    rows = []
    for mm, cc, lo_, hi_, qq in levels:
        q6 = torch.stack([qq[:, i, j] for i, j in lay.tri], -1)
        rows.append(torch.cat([mm[:, None], cc, 0.5 * (hi_ - lo_), q6,
                               0.5 * (lo_ + hi_)], -1))
    return torch.cat(rows, 0).contiguous()


def level_rows(spec: TreeSpec, ctab: Tensor, ell: int) -> Tensor:
    """The 2^ell rows of level `ell` of a cell table."""
    return ctab[(1 << ell) - 1:(1 << (ell + 1)) - 1]


# ---------------------------------------------------------------------------
# K6: frontier walk and far field
# ---------------------------------------------------------------------------

def mac_factors(spec: TreeSpec, gmap: Tensor, alive: Tensor,
                amag: Optional[Tensor] = None,
                gpot: Optional[Tensor] = None,
                dtype=torch.float64) -> Optional[Tensor]:
    """The per-group factor (G,) of an accuracy MAC (gandalf_tpu/ops/
    tree.py:318-333), from particle-order fields through `gmap`: gadget2
    takes each group's least |a_prev| over live slots (1e30 without
    `amag`), eigenmac its largest gpot^(-2/3) over live slots with gpot
    > 0 (0 without `gpot`).  None for the geometric MAC."""
    G, L = spec.n_leaves, spec.leaf_size
    dev = alive.device
    if spec.mac == "gadget2":
        if amag is None:
            return torch.full((G,), BIG, dtype=dtype, device=dev)
        safe = torch.clamp_min(gmap.reshape(-1).long(), 0)
        big = torch.tensor(BIG, dtype=amag.dtype, device=dev)
        return torch.where(alive, amag[safe], big).reshape(G, L).amin(1)
    if spec.mac == "eigenmac":
        if gpot is None:
            return torch.zeros((G,), dtype=dtype, device=dev)
        safe = torch.clamp_min(gmap.reshape(-1).long(), 0)
        g = torch.where(alive, gpot[safe], 0.0)
        mf = torch.where(alive & (g > 0.0),
                         torch.clamp_min(g, 1e-30) ** (-2.0 / 3.0), 0.0)
        return mf.reshape(G, L).amax(1)
    return None


def tree_walk(spec: TreeSpec, ctab: Tensor, ptab: Tensor, alive: Tensor,
              group_ids: Optional[Tensor] = None,
              gfac: Optional[Tensor] = None, ewald=None):
    """Per group of L slots, level by level: the MAC against the group
    box, the far field of accepted cells at every live slot (or, with
    spec.fast, its expansion about the group's box centre), the children
    of opened cells as the next frontier, the opened leaves as the near
    list.  Returns far a (G*L, ndim), far pot (G*L,), near list (G, Wn)
    int32 (-1 padded) and overflow (); with spec.fast the first two are
    the groups' expansions (G, layout(ndim).fast_cols) (a0, pot0, the
    Jacobian row by row) and None.  `gfac` (G,) is the accuracy MAC's
    per-group factor (mac_factors; its default where None); `ewald` an
    (EwaldTable, periodic extent) pair for the periodic walk (3D only).
    With `group_ids` (G_act,) int32 only the listed groups walk; the other
    groups' rows are zero (near: -1).  K6 on CUDA tensors."""
    if spec.mac != "geometric" and gfac is None:
        gfac = mac_factors(spec, None, alive, dtype=ptab.dtype)
    if ptab.is_cuda:
        return _ext.tree_walk(spec, ctab, ptab, alive, group_ids, gfac,
                              ewald)
    return tree_walk_plain(spec, ctab, ptab, alive, group_ids, gfac=gfac,
                           ewald=ewald)


def _safe_invr(d2: Tensor) -> Tensor:
    eps = 1e-24 if d2.dtype == torch.float32 else 1e-60
    return torch.where(d2 > eps, torch.rsqrt(torch.clamp_min(d2, eps)), 0.0)


def _stable_compact(valid: Tensor, values: Tensor, cap: int):
    """Per row, `values[valid]` in order into a (B, cap) tensor padded
    with -1, and the per-row counts (entries beyond cap are dropped)."""
    B = valid.shape[0]
    pos = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    keep = valid & (pos < cap)
    out = torch.full((B, cap + 1), -1, dtype=values.dtype,
                     device=values.device)
    dest = torch.where(keep, pos, cap)
    out.scatter_(1, dest, torch.where(keep, values, -1))
    return out[:, :cap], valid.sum(1)


def _chunk_groups(G: int, pairs_per_group: int, device) -> int:
    """Groups per chunk of a plain version: at most 2^25 (target, source)
    pairs per chunk on a GPU, 2^21 on a CPU."""
    budget = 1 << 25 if device.type == "cuda" else 1 << 21
    return max(1, min(G, budget // max(pairs_per_group, 1)))


def _groups_of(spec: TreeSpec, group_ids: Optional[Tensor], device):
    """The walked group ids (int64): the list, or every group."""
    if group_ids is None:
        return torch.arange(spec.n_leaves, device=device)
    return group_ids.long()


def _sum_sq(x: Tensor) -> Tensor:
    """sum_k x_k^2 over the last axis, term by term in K6's order."""
    s = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k] * x[..., k]
    return s


def _multipole(dr: Tensor, m: Tensor, q6: Optional[Tensor]):
    """Field and potential of cells of mass m (and quadrupole q6, the
    upper triangle) at dr = com - r (..., ndim): gandalf_tpu's
    _mp_accel."""
    inv_r = _safe_invr((dr * dr).sum(-1))
    inv_r3 = inv_r * inv_r * inv_r
    a = (m * inv_r3)[..., None] * dr
    p = m * inv_r
    if q6 is not None:
        qdr, drqdr = _quad_terms(q6, dr)
        inv_r5 = inv_r3 * inv_r * inv_r
        a = a - inv_r5[..., None] * qdr + (
            2.5 * drqdr * inv_r5 * inv_r * inv_r)[..., None] * dr
        p = p + 0.5 * drqdr * inv_r5
    return a, p


def tree_walk_plain(spec: TreeSpec, ctab: Tensor, ptab: Tensor,
                    alive: Tensor, group_ids: Optional[Tensor] = None,
                    stats: Optional[dict] = None,
                    gfac: Optional[Tensor] = None, ewald=None):
    """Plain version of K6: gandalf_tpu's walk_group over chunks of the
    walked groups, with the far field evaluated at dr = com - r (fast:
    com - gc) directly, min-imaged and corrected with the Ewald sum.  A
    `stats` dict receives the walk's work: "mac_tests" (live cells
    tested), "far_terms" (accepted cell times live slot of its group)
    and "fast_terms" (accepted cells, with spec.fast)."""
    G, L, D = spec.n_leaves, spec.leaf_size, spec.depth
    dt, dev = ptab.dtype, ptab.device
    lay = layout(table_ndim(ptab))
    nd, cq, nq = lay.ndim, lay.c_q, lay.nq
    require_3d_ewald(nd, ewald)
    Wn, th2 = spec.near_cap, spec.theta_sqd
    table, period = _ewald_parts(ewald)
    leaves = level_rows(spec, ctab, D)
    wmax = max([1] + [spec.level_cap(ell) for ell in range(1, D + 1)])
    groups = _groups_of(spec, group_ids, dev)
    B = _chunk_groups(G, L * wmax, dev)
    if spec.fast:
        far = torch.zeros((G, lay.fast_cols), dtype=dt, device=dev)
    else:
        a_far = torch.zeros((G, L, nd), dtype=dt, device=dev)
        pot_far = torch.zeros((G, L), dtype=dt, device=dev)
    near = torch.full((G, Wn), -1, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    ptab_g = ptab.reshape(G, L, lay.pcols)
    eye = torch.eye(nd, dtype=dt, device=dev)
    for c0 in range(0, groups.numel(), B):
        gsel = groups[c0:c0 + B]
        nb = gsel.numel()
        al = alive.reshape(G, L)[gsel]
        # a group without live slots walks nothing (as K6)
        glive = al.any(1)
        rt = ptab_g[gsel, :, :nd]
        gc = leaves[gsel, lay.c_cen:lay.c_cen + nd]
        gh = leaves[gsel, lay.c_half:lay.c_half + nd]
        gf = None if gfac is None else gfac[gsel]
        a_acc = torch.zeros((nb, L, nd), dtype=dt, device=dev)
        p_acc = torch.zeros((nb, L), dtype=dt, device=dev)
        jac = torch.zeros((nb, nd, nd), dtype=dt, device=dev)
        a0 = torch.zeros((nb, nd), dtype=dt, device=dev)
        pot0 = torch.zeros((nb,), dtype=dt, device=dev)
        front = torch.zeros((nb, 1), dtype=torch.int64, device=dev)
        ovf = torch.zeros((nb,), dtype=torch.bool, device=dev)
        for ell in range(D + 1):
            valid = (front >= 0) & glive[:, None]
            idx = torch.clamp_min(front, 0)
            tab = level_rows(spec, ctab, ell)[idx]     # (nb, W, ccols)
            m_c = torch.where(valid, tab[..., C_M], 0.0)
            com = tab[..., lay.c_com:lay.c_com + nd]
            half = tab[..., lay.c_half:lay.c_half + nd]
            d = com - gc[:, None, :]
            if table is not None:
                d = ew.min_image(d, period)
            gap = torch.clamp_min(torch.abs(d) - gh[:, None, :], 0.0)
            # sums written out in K6's order: both take the same MAC
            # decisions, bit for bit, in either precision
            dsqd = _sum_sq(gap)
            rmax_sqd = _sum_sq(half)
            live = valid & (m_c > 0.0)
            accept = live & (dsqd * th2 > rmax_sqd)
            if spec.mac == "gadget2":
                extra = (dsqd * dsqd * gf[:, None] * spec.macerror
                         < rmax_sqd * m_c)
                accept = accept & ~extra
            elif spec.mac == "eigenmac" and spec.quadrupole:
                q = tab[..., cq:cq + nq]
                # the diagonal's and the off-diagonal's squares, each in
                # the tri order (none off the diagonal in 1D)
                on = [c for c, (i, j) in enumerate(lay.tri) if i == j]
                off = [c for c, (i, j) in enumerate(lay.tri) if i != j]
                diag = _sum_sq(q[..., on])
                offd = _sum_sq(q[..., off]) if off else torch.zeros_like(diag)
                trq2 = diag + 2.0 * offd
                lam = 2.0 * torch.sqrt(torch.clamp_min(trq2, 0.0) / 6.0)
                cellmac = (0.5 * lam / spec.macerror) ** (2.0 / 3.0)
                accept = accept & ~(dsqd < cellmac * gf[:, None])
            open_ = live & ~accept
            if stats is not None:
                n_live = al.sum(1)
                stats["mac_tests"] = stats.get("mac_tests", 0) \
                    + int(live.sum())
                stats["far_terms"] = stats.get("far_terms", 0) \
                    + int((accept.sum(1) * n_live).sum())
                stats["fast_terms"] = stats.get("fast_terms", 0) \
                    + int(accept.sum())
            b, w = accept.nonzero(as_tuple=True)
            if b.numel() and spec.fast:
                # the accepted cells about the group's box centre
                dr = d[b, w]                                  # (n, 3)
                m_a = m_c[b, w]
                q6 = tab[b, w, cq:cq + nq] if spec.quadrupole else None
                a_c, p_c = _multipole(dr, m_a, q6)
                if table is not None:
                    e_a, e_p = ew.ewald_correction(table, dr)
                    a_c = a_c + m_a[:, None] * e_a
                    p_c = p_c + m_a * e_p
                inv_r = _safe_invr((dr * dr).sum(-1))
                inv_r3 = inv_r * inv_r * inv_r
                inv_r5 = inv_r3 * inv_r * inv_r
                outer = dr[:, :, None] * dr[:, None, :]
                j_c = m_a[:, None, None] * (
                    3.0 * outer * inv_r5[:, None, None]
                    - eye * inv_r3[:, None, None])
                a0.index_add_(0, b, a_c)
                pot0.index_add_(0, b, p_c)
                jac.index_add_(0, b, j_c)
            elif b.numel():
                # far field of the accepted cells at every slot of their
                # group
                dr = com[b, w][:, None, :] - rt[b]          # (n, L, nd)
                if table is not None:
                    dr = ew.min_image(dr, period)
                m_a = m_c[b, w][:, None]
                q6 = (tab[b, w, cq:cq + nq][:, None] if spec.quadrupole
                      else None)
                a_c, p_c = _multipole(dr, m_a, q6)
                if table is not None:
                    e_a, e_p = ew.ewald_correction(table, dr)
                    a_c = a_c + m_a[..., None] * e_a
                    p_c = p_c + m_a * e_p
                a_acc.index_add_(0, b, a_c)
                p_acc.index_add_(0, b, p_c)
            if ell < D:
                kids = torch.stack([torch.where(open_, 2 * idx, -1),
                                    torch.where(open_, 2 * idx + 1, -1)],
                                   -1).reshape(nb, -1)
                cap = spec.level_cap(ell + 1)
                front, count = _stable_compact(kids >= 0, kids,
                                               min(cap, kids.shape[1]))
                ovf |= count > cap
            else:
                ids, count = _stable_compact(open_, idx, Wn)
                near[gsel] = ids.to(torch.int32)
                ovf |= count > Wn
        if spec.fast:
            far[gsel] = torch.cat([a0, pot0[:, None],
                                   jac.reshape(nb, nd * nd)], -1)
        else:
            # every slot of a live group, dead ones too (K6)
            a_far[gsel] = a_acc
            pot_far[gsel] = p_acc
        overflow |= ovf.any()
    if spec.fast:
        return far, None, near, overflow
    return a_far.reshape(-1, nd), pot_far.reshape(-1), near, overflow


def _ewald_parts(ewald):
    """(table, min-image period) of an (EwaldTable, extent) pair, or
    (None, None)."""
    if ewald is None:
        return None, None
    table, extent = ewald
    return table, ew.period_of(extent)


def _quad_terms(q6: Tensor, dr: Tensor):
    """Q.dr and dr.Q.dr from upper-triangle components."""
    nd = dr.shape[-1]
    q = {p: q6[..., i] for i, p in enumerate(tri(nd))}
    qdr = torch.stack([sum(q[(min(i, j), max(i, j))] * dr[..., j]
                           for j in range(nd)) for i in range(nd)], -1)
    return qdr, (qdr * dr).sum(-1)


# ---------------------------------------------------------------------------
# K7: near field, support check and scatter to particle order
# ---------------------------------------------------------------------------

def tree_near(spec: TreeSpec, kern, ctab: Tensor, ptab: Tensor,
              alive: Tensor, near: Tensor, a_far: Tensor,
              pot_far: Optional[Tensor], out_index: Tensor, n_out: int,
              group_ids: Optional[Tensor] = None, zeta_scaling: str = "sph",
              ewald=None):
    """Near-field pair sums over each group's near leaves, plus the far
    field, written to row out_index[slot] of (n_out, ndim) and (n_out,)
    outputs for every slot with a row (out_index >= 0) in a group with
    a live slot, dead slots included; overflow () when some group's
    kernel-support leaves exceed min(support_cap, near_cap).  `kern`
    None evaluates Newtonian pairs only.  With `group_ids` only the
    listed groups' slots are written (zero elsewhere).  `zeta_scaling`
    "sph" adds the grad-h zeta term to the softened force as m_j *
    (zh_i w1_i + zh_j w1_j) / 2, "mfv" as (1/m_i) (zh_i w1_i + zh_j
    w1_j) / 2, not scaled by m_j and zero where m_j <= 0
    (MfvCommon.cpp:413-416).  With spec.fast `a_far` is K6's (G,
    layout(ndim).fast_cols) expansions and `pot_far` None: the far field
    of a slot is a0 + J (r - gc) and pot0 + a0 . (r - gc) about its
    group's box centre.  With `ewald`, an (EwaldTable, periodic extent)
    pair (3D only), each pair is min-imaged and adds the table's
    correction.  K7 on CUDA tensors."""
    if zeta_scaling not in ("sph", "mfv"):
        raise ValueError(f"zeta_scaling must be 'sph' or 'mfv', not "
                         f"{zeta_scaling!r}")
    if ptab.is_cuda:
        return _ext.tree_near(spec, kern, ctab, ptab, alive, near, a_far,
                              pot_far, out_index, n_out, group_ids,
                              zeta_scaling, ewald)
    return tree_near_plain(spec, kern, ctab, ptab, alive, near, a_far,
                           pot_far, out_index, n_out, group_ids,
                           zeta_scaling, ewald)


def tree_near_plain(spec: TreeSpec, kern, ctab, ptab, alive, near, a_far,
                    pot_far, out_index, n_out, group_ids=None,
                    zeta_scaling="sph", ewald=None):
    """Plain version of K7 over chunks of the walked groups: each pair of
    a group's target slot i and a live partner j in its near leaves (not i
    itself, d > 0; min-imaged with the Ewald sum) adds the symmetric
    softened force and potential, with the zeta term of `zeta_scaling`,
    where d < kernrange * max(h_i, h_j) in a leaf of the support
    selection, and m/d^3, m/d beyond; with the
    Ewald sum also m_j times the table's correction."""
    G, L, D = spec.n_leaves, spec.leaf_size, spec.depth
    dt, dev = ptab.dtype, ptab.device
    lay = layout(table_ndim(ptab))
    nd, pm, ph, pzh = lay.ndim, lay.p_m, lay.p_h, lay.p_zh
    cen, hlf = slice(lay.c_cen, lay.c_cen + nd), slice(lay.c_half,
                                                        lay.c_half + nd)
    require_3d_ewald(nd, ewald)
    table, period = _ewald_parts(ewald)
    Wn = near.shape[1]
    # targets: the slots with a row in groups with a live slot, dead ones
    # included (gandalf_tpu/ops/tree.py:1389-1392 scatters every mapped
    # slot); a group without live slots walks nothing (as K6, K7)
    target = ((out_index.reshape(G, L) >= 0)
              & alive.reshape(G, L).any(1, keepdim=True)).reshape(-1)
    leaves = level_rows(spec, ctab, D)
    groups = _groups_of(spec, group_ids, dev)
    B = _chunk_groups(G, L * Wn * L, dev)
    a_s = torch.zeros((G, L, nd), dtype=dt, device=dev)
    p_s = torch.zeros((G, L), dtype=dt, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    Ws = min(spec.support_cap, Wn)
    slot_l = torch.arange(L, device=dev)
    ptab_g = ptab.reshape(G, L, lay.pcols)
    for c0 in range(0, groups.numel(), B):
        gsel = groups[c0:c0 + B]
        nb = gsel.numel()
        own = ptab_g[gsel]
        al = alive.reshape(G, L)[gsel]
        tg = target.reshape(G, L)[gsel]
        nid = near[gsel].long()                              # (nb, Wn)
        nvalid = nid >= 0
        col = (torch.clamp_min(nid, 0)[..., None] * L + slot_l).reshape(
            nb, Wn * L)
        part = ptab[col]                                 # (nb, P, pcols)
        pal = alive[col] & nvalid.repeat_interleave(L, dim=1)
        rows = gsel[:, None] * L + slot_l
        # separations per component, (nb, L, P) each
        dr = [part[:, None, :, k] - own[:, :, None, k] for k in range(nd)]
        if table is not None:
            dr = [x - period[k] * torch.round(x / period[k])
                  for k, x in enumerate(dr)]
        d2 = dr[0] * dr[0]
        for x in dr[1:]:
            d2 = d2 + x * x
        use = (pal[:, None, :] & tg[..., None]
               & (col[:, None, :] != rows[..., None]) & (d2 > 0.0))
        m_j = torch.where(use, part[:, None, :, pm], 0.0)
        inv_d = torch.rsqrt(torch.where(use, d2, 1.0))
        coef = m_j * inv_d * inv_d * inv_d
        pot = m_j * inv_d
        if kern is not None:
            # the support selection of gandalf_tpu: the near leaves whose
            # box gap to the group's is below kernrange times the larger
            # of the group's and the leaf's h (over live slots); kept for
            # its overflow, and a pair is softened only in such a leaf
            # (which decides only for a dead target, whose h = 1 is not
            # in the group's)
            hg = torch.where(al, own[..., ph], 0.0).amax(1)
            hp = torch.where(pal & (part[..., pm] > 0.0), part[..., ph],
                             0.0).reshape(nb, Wn, L).amax(2)
            cell = leaves[torch.clamp_min(nid, 0)]
            gcell = leaves[gsel]
            dgc = cell[..., cen] - gcell[:, None, cen]
            if table is not None:
                dgc = ew.min_image(dgc, period)
            gap = torch.clamp_min(
                torch.abs(dgc) - cell[..., hlf] - gcell[:, None, hlf], 0.0)
            sup = kern.kernrange * torch.maximum(hg[:, None], hp)
            in_sup = nvalid & ((gap * gap).sum(-1) < sup * sup)
            overflow |= (in_sup.sum(1) > Ws).any()
            # softened pairs, few of the block, evaluated as a list
            h_i, h_j = own[..., ph][..., None], part[:, None, :, ph]
            rad = kern.kernrange * torch.maximum(h_i, h_j)
            # a slack on d^2; the test on d below decides
            soft = (use & in_sup.repeat_interleave(L, dim=1)[:, None, :]
                    & (d2 < rad * rad * 1.0001))
            b, i, p = soft.nonzero(as_tuple=True)
            d = torch.sqrt(d2[b, i, p])
            soft_d = d < rad[b, i, p]
            b, i, p, d = b[soft_d], i[soft_d], p[soft_d], d[soft_d]
            invh_i, invh_j = 1.0 / own[b, i, ph], 1.0 / part[b, p, ph]
            s_i, s_j = d * invh_i, d * invh_j
            paux = 0.5 * (invh_i * invh_i * kern.wgrav(s_i)
                          + invh_j * invh_j * kern.wgrav(s_j))
            zterm = 0.5 * (own[b, i, pzh] * kern.w1(s_i)
                           + part[b, p, pzh] * kern.w1(s_j))
            gaux = 0.5 * (invh_i * kern.wpot(s_i) + invh_j * kern.wpot(s_j))
            mj = m_j[b, i, p]
            if zeta_scaling == "sph":
                coef[b, i, p] = mj * (paux + zterm) / d
            else:
                invm_i = 1.0 / torch.clamp_min(own[b, i, pm], 1e-30)
                coef[b, i, p] = (mj * paux / d + torch.where(
                    mj > 0.0, invm_i * zterm, 0.0) / d)
            pot[b, i, p] = m_j[b, i, p] * gaux
        a_s[gsel] = torch.stack([(coef * x).sum(2) for x in dr], -1)
        p_s[gsel] = pot.sum(2)
        if table is not None:
            # the correction of the pairs in use, summed per target slot
            b, i, q = use.nonzero(as_tuple=True)
            e_a, e_p = ew.ewald_correction(
                table, torch.stack([x[b, i, q] for x in dr], -1))
            mj = m_j[b, i, q]
            row = b * L + i
            a_s[gsel] += torch.zeros((nb * L, 3), dtype=dt, device=dev) \
                .index_add_(0, row, mj[:, None] * e_a).reshape(nb, L, nd)
            p_s[gsel] += torch.zeros((nb * L,), dtype=dt, device=dev) \
                .index_add_(0, row, mj * e_p).reshape(nb, L)
    if spec.fast:
        # the groups' expansions about their box centres, at each slot
        f = a_far.reshape(G, lay.fast_cols)
        delta = ptab.reshape(G, L, lay.pcols)[..., :nd] \
            - leaves[:, None, cen]
        jac = f[:, nd + 1:].reshape(G, nd, nd)
        a_far = (f[:, None, :nd]
                 + torch.einsum("gij,glj->gli", jac, delta)).reshape(-1, nd)
        pot_far = (f[:, None, nd]
                   + torch.einsum("gj,glj->gl", f[:, :nd], delta)).reshape(-1)
    a_s = a_s.reshape(-1, nd) + a_far
    p_s = p_s.reshape(-1) + pot_far
    a = torch.zeros((n_out, nd), dtype=dt, device=dev)
    gpot = torch.zeros((n_out,), dtype=dt, device=dev)
    written = target
    if group_ids is not None:
        listed = torch.zeros((G,), dtype=torch.bool, device=dev)
        listed[groups] = True
        written = target & listed.repeat_interleave(L)
    idx = out_index.reshape(-1).long()[written]
    a[idx] = a_s[written]
    gpot[idx] = p_s[written]
    return a, gpot, overflow


# ---------------------------------------------------------------------------
# The gravity pass
# ---------------------------------------------------------------------------

def tree_gravity(spec: TreeSpec, ctab: Tensor, ptab: Tensor, alive: Tensor,
                 kern=None, gfac: Optional[Tensor] = None, ewald=None):
    """K6 then K7 on a built tree: (a (G*L, ndim), gpot (G*L,), overflow) in
    bucket order (zero in empty slots).  `kern` None is Newtonian;
    `gfac` and `ewald` as for tree_walk."""
    a_far, pot_far, near, ovf_walk = tree_walk(spec, ctab, ptab, alive,
                                               gfac=gfac, ewald=ewald)
    n = ptab.shape[0]
    order = torch.where(alive, torch.arange(n, dtype=torch.int32,
                                            device=ptab.device), -1)
    a, gpot, ovf_near = tree_near(spec, kern, ctab, ptab, alive, near,
                                  a_far, pot_far, order, n, ewald=ewald)
    return a, gpot, ovf_walk | ovf_near


def tree_gravity_grouped(spec: TreeSpec, gmap: Tensor, r: Tensor, m: Tensor,
                         h: Optional[Tensor] = None, kern=None,
                         zh: Optional[Tensor] = None, periodic_extent=None,
                         zeta_scaling: str = "sph", ewald_table=None,
                         amag: Optional[Tensor] = None,
                         gpot_prev: Optional[Tensor] = None,
                         alive: Optional[Tensor] = None):
    """Gravity with host-planned buckets: gather and unwrap (K4), build
    (K5), walk (K6), near field and scatter (K7, with the zeta term of
    `zeta_scaling`).  Returns (a, gpot, overflow) in particle order.
    Without `h` (or `kern`) the pairs are Newtonian.  `ewald_table`
    (an ops.ewald.EwaldTable) adds the periodic correction, min-imaged
    over `periodic_extent`; `amag` (gadget2) and `gpot_prev` (eigenmac)
    give the accuracy MAC its per-group factors (mac_factors).  `alive`
    (N,) bool masks dead particles out as sources; as targets they get
    the field at their frozen positions, as in the JAX package, except
    in a bucket with no alive particle, which walks nothing and gives
    them zero (ROADMAP queue 3, F12)."""
    ptab, alive = gather_to_buckets(spec, gmap, r, m, h, zh,
                                    periodic_extent, alive)
    ctab = build_tree(spec, ptab, alive)
    gfac = mac_factors(spec, gmap, alive, amag, gpot_prev, dtype=r.dtype)
    ewald = (None if ewald_table is None
             else (ewald_table, periodic_extent))
    a_far, pot_far, near, ovf_walk = tree_walk(spec, ctab, ptab, alive,
                                               gfac=gfac, ewald=ewald)
    a, gpot, ovf_near = tree_near(
        spec, kern if h is not None else None, ctab, ptab, alive, near,
        a_far, pot_far, gmap.reshape(-1), r.shape[0],
        zeta_scaling=zeta_scaling, ewald=ewald)
    return a, gpot, ovf_walk | ovf_near


def tree_gravity_active(spec: TreeSpec, gmap: Tensor, r: Tensor, m: Tensor,
                        h: Optional[Tensor], kern, zh: Optional[Tensor],
                        group_ids: Tensor, periodic_extent=None):
    """Gravity of the listed groups only (the block-timestep walk, where
    only buckets holding active particles pay): gather (K4) and build
    (K5) over all buckets, walk (K6) and near field (K7) over
    `group_ids` (G_act,) int32.  Returns (a, gpot, overflow) in particle
    order, zero in the rows of unlisted groups.  As in the JAX package
    (ROADMAP fault F11) the walk takes no Ewald sum and the accuracy
    MACs their factors' defaults (gadget2 |a| = 1e30, eigenmac 0); the
    fast multipoles apply."""
    ptab, alive = gather_to_buckets(spec, gmap, r, m, h, zh,
                                    periodic_extent)
    ctab = build_tree(spec, ptab, alive)
    a_far, pot_far, near, ovf_walk = tree_walk(spec, ctab, ptab, alive,
                                               group_ids)
    a, gpot, ovf_near = tree_near(
        spec, kern if h is not None else None, ctab, ptab, alive, near,
        a_far, pot_far, gmap.reshape(-1), r.shape[0], group_ids)
    return a, gpot, ovf_walk | ovf_near
