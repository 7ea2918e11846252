"""Locally-essential-tree (LET) distributed Barnes-Hut gravity over a
ring of z-slab shards.

Counterpart of ``gandalf_tpu/parallel/let.py`` (the reference's pruned
trees and export/return force sums, HydroTree.cpp:1044-1238):

- each shard gathers its own particles into KD buckets (K4, a host
  planned map of local slots) and builds its local tree (K5);
- the raw bucket tables of the ring neighbours up to distance R are
  exchanged (``ppermute``), and each shard builds one tree over the
  2R + 1 slabs (K5) and walks only its own groups (K6 and K7 in their
  group-list mode), so cross-seam softened pairs come out exact;
- every shard publishes its whole local cell table (``all_gather``), and
  the shards beyond the ring are evaluated by a MAC-checked frontier
  walk of their tables (K38, ``let_far_walk``), multipole only; a leaf
  that fails the MAC or a full frontier raises the overflow flag, and
  the controller replans with a larger R and frontier.

When 2R + 1 >= S the ring covers every shard and nothing is far.  The
gravity model is the JAX package's: an isolated box (ewald = 0) on
wrapped coordinates with per-bucket periodic unwrap.  The ring's pad
rows are empty slots of the port's tables (position 0, m 0, h 1, not
alive), where the JAX package puts them at 1e15: no pad is alive, so no
pad reaches a sum.

Two places differ from the JAX package (ROADMAP queue 3): the far walk
adds the moments of the accepted cells only, where the JAX package adds
the quadrupole of every other frontier entry too, opened cells and the
empty entries (read as the level's first cell) at zero mass (F35,
repaired: at 64^3 over 4 shards it puts gpot 6.7% off the direct sum);
and the controller plans R from the live particles' h, where the JAX
package's counts the pads' h = 1 (F36, sim/dist_sim.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .. import _ext
from ..ops.tree import (TreeSpec, _multipole, _stable_compact, _sum_sq,
                        build_tree, gather_to_buckets, layout, level_rows,
                        plan_buckets_kd, tree_near, tree_walk)
from .comm import ShardGroup

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LetPlan:
    """Host-side LET plan (the fields of gandalf_tpu's LetPlan)."""

    n_shards: int
    ring_radius: int          # R: raw-exchange ring distance
    spec_comb: TreeSpec       # walk tree over the (2R+1) raw slabs
    g_loc: int                # buckets per shard (padded, pow2)
    pub_depth: int            # published summary depth (== local depth)
    remote_frontier: int      # Wr: frontier cap for far-shard walks
    gmap: np.ndarray          # (S*G_loc, L) LOCAL-slot ids, -1 = pad


def grow_let_caps(plan: LetPlan, factor: float = 1.6) -> LetPlan:
    """Cap growth after an overflow; also grows R
    (gandalf_tpu/parallel/let.py:71-89)."""
    S = plan.n_shards
    R = plan.ring_radius
    if 2 * (R + 1) + 1 <= S:
        R = R + 1
    return dataclasses.replace(
        plan, ring_radius=R,
        remote_frontier=min(int(plan.remote_frontier * factor) + 8,
                            2 * plan.g_loc),
        spec_comb=dataclasses.replace(
            plan.spec_comb,
            near_cap=min(int(plan.spec_comb.near_cap * factor) + 8,
                         plan.spec_comb.n_leaves),
            frontier=min(int(plan.spec_comb.frontier * factor) + 16,
                         2 * plan.spec_comb.n_leaves),
            support_cap=min(int(plan.spec_comb.support_cap * factor) + 8,
                            plan.spec_comb.n_leaves)))


def plan_let(r_sharded: np.ndarray, perm: np.ndarray, n_shards: int,
             cap: int, z_lo: float, z_extent: float,
             leaf_size: int = 32, theta_sqd: float = 0.1,
             quadrupole: bool = True, h_support: float = 0.0,
             near_cap: int = None,
             prev: Optional[LetPlan] = None,
             w_slab_min: float = None) -> Optional[LetPlan]:
    """Plan the ring LET (gandalf_tpu/parallel/let.py:92-196); None for
    S < 2.  r_sharded (S*cap, ndim) in the padded shard-major layout,
    perm its slot -> original id map (-1 pad); h_support the kernel
    support the raw ring must cover; w_slab_min the narrowest slab of a
    balanced plan."""
    S = n_shards
    if S < 2:
        return None
    theta = float(np.sqrt(theta_sqd))
    w_slab = w_slab_min if w_slab_min is not None else z_extent / S

    gmaps = []
    for s in range(S):
        sl = slice(s * cap, (s + 1) * cap)
        real = np.nonzero(perm[sl] >= 0)[0]
        if len(real) == 0:
            gm = np.full((1, leaf_size), -1, np.int32)
        else:
            g_r = plan_buckets_kd(
                np.asarray(r_sharded[sl], np.float64)[real], leaf_size)
            gm = np.where(g_r >= 0, real[np.maximum(g_r, 0)],
                          -1).astype(np.int32)
        gmaps.append(gm)
    G_loc = max(gm.shape[0] for gm in gmaps)
    G_loc = 1 << int(np.ceil(np.log2(max(G_loc, 2))))
    gmap = np.full((S, G_loc, leaf_size), -1, np.int32)
    for s, gm in enumerate(gmaps):
        gmap[s, :gm.shape[0]] = gm

    big = 1e30
    rmax_leaf = 0.0
    for s in range(S):
        ok = gmap[s] >= 0
        if not ok.any():
            continue
        pts = r_sharded[s * cap + np.maximum(gmap[s], 0)]
        lo = np.where(ok[..., None], pts, big).min(axis=1)
        hi = np.where(ok[..., None], pts, -big).max(axis=1)
        occ = ok.any(axis=1)
        half = np.where(occ[..., None], 0.5 * (hi - lo), 0.0)
        rmax_leaf = max(rmax_leaf, float(np.sqrt((half ** 2).sum(-1))
                                         .max()))

    slack = 1.2
    need = max(slack * rmax_leaf / theta, slack * h_support)
    R = max(1, int(np.ceil(need / max(w_slab, 1e-30))))
    R = min(R, (S - 1) // 2 + ((S - 1) % 2))
    while 2 * R + 1 > S and R > 1 and 2 * (R - 1) + 1 >= S:
        R -= 1
    R = min(R, S // 2)
    R = max(R, 1)

    depth = int(np.log2(G_loc))
    n_blocks = 2 * R + 1 if 2 * R + 1 < S else S
    G_comb = 1 << int(np.ceil(np.log2(n_blocks * G_loc)))
    if near_cap is None:
        near_cap = int(13.0 * leaf_size
                       * (0.1 / max(theta_sqd, 1e-3)) ** 1.5) + 48
        near_cap = min(near_cap, G_comb)
    spec_comb = TreeSpec(
        n_pad=G_comb * leaf_size, leaf_size=leaf_size,
        depth=int(np.log2(G_comb)),
        frontier=min(max(2 * near_cap, 64), 2 * G_comb),
        theta_sqd=theta_sqd, quadrupole=quadrupole, fast=False,
        near_cap=near_cap,
        group_chunk=int(np.clip(
            2 ** 25 // max(leaf_size * leaf_size * near_cap, 1), 8, 128)),
        support_cap=min(64, G_comb))
    plan = LetPlan(
        n_shards=S, ring_radius=R, spec_comb=spec_comb, g_loc=G_loc,
        pub_depth=depth,
        remote_frontier=min(max(32, G_loc // 8), G_loc),
        gmap=gmap.reshape(S * G_loc, leaf_size))
    if prev is not None and prev.g_loc == G_loc:
        plan = dataclasses.replace(
            plan,
            ring_radius=max(R, min(prev.ring_radius, S // 2)),
            remote_frontier=max(plan.remote_frontier,
                                min(prev.remote_frontier, 2 * G_loc)),
            spec_comb=dataclasses.replace(
                plan.spec_comb,
                near_cap=max(plan.spec_comb.near_cap,
                             min(prev.spec_comb.near_cap, G_comb)),
                frontier=max(plan.spec_comb.frontier,
                             min(prev.spec_comb.frontier, 2 * G_comb))))
    return plan


def ring_offsets(S: int, R: int):
    """(offsets of the raw ring blocks in the combined table's order,
    positive offsets of the far shards): shard s's block at offset o is
    shard (s + o) mod S's (gandalf_tpu/parallel/let.py:287-306, :323-329)."""
    n_blocks = 2 * R + 1 if 2 * R + 1 < S else S
    offs = {0}
    for hop in range(1, (n_blocks - 1) // 2 + 1):
        offs |= {-hop, hop}
    if n_blocks % 2 == 0:
        offs.add(-(n_blocks // 2))
    offs = sorted(offs)
    if n_blocks >= S:
        return offs, []
    far_offs = [o for o in range(-(S - 1) // 2, S - (S - 1) // 2)
                if o not in offs]
    return offs, sorted({o % S for o in far_offs} - {0})


# ---------------------------------------------------------------------------
# K38: the far walk of the published cell tables
# ---------------------------------------------------------------------------

def let_far_walk(tabs: Tensor, leaf_cen: Tensor, leaf_half: Tensor,
                 rt: Tensor, alive: Tensor, leaf_size: int, wr: int,
                 theta_sqd: float, quadrupole: bool):
    """The far field of the far shards' published cell tables at every
    target slot of the local groups: for each group and table, a
    frontier walk from the root, level by level, that accepts a cell
    when gap^2 theta^2 > rmax^2 (gap: the cell's COM from the group's
    box), opens the others, keeps the first `wr` of their children
    (flagging more) and, at the leaves, accepts every occupied cell,
    flagging one that fails the MAC.  tabs (n_far, 2^(D+1) - 1, ccols)
    cell tables (ops/tree.py's layout); leaf_cen, leaf_half (G, ndim)
    the local leaves' boxes; rt (G*L, ndim) the targets and alive (G*L,)
    which of them are live.  A group with no live target is not walked
    (the JAX package walks it from its empty leaf's far sentinel, which
    the root accepts), and a dead target gets zero.  Returns a (G*L,
    ndim), pot (G*L,) and the per-group flag (G,).  K38 on CUDA
    tensors."""
    if rt.is_cuda:
        return _ext.let_far_walk(tabs, leaf_cen, leaf_half, rt, alive,
                                 leaf_size, wr, theta_sqd, quadrupole)
    return let_far_walk_plain(tabs, leaf_cen, leaf_half, rt, alive,
                              leaf_size, wr, theta_sqd, quadrupole)


def _far_chunk(tabs, cen, half_g, r_t, al, wr, theta_sqd, quadrupole,
               counts):
    """let_far_walk_plain over a chunk of B groups with live targets al
    (B, L): (a (B, L, ndim), pot (B, L), flag (B,))."""
    B, L, nd = r_t.shape
    lay = layout(nd)
    depth = int(np.log2(tabs.shape[1] + 1)) - 1
    dev, dt = r_t.device, r_t.dtype
    a = torch.zeros((B, L, nd), dtype=dt, device=dev)
    pot = torch.zeros((B, L), dtype=dt, device=dev)
    flag = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_live = al.sum(1)
    for tab in tabs:
        # a group with no live target starts with an empty frontier
        front = torch.where(n_live > 0, 0, -1)[:, None]
        for ell in range(depth + 1):
            valid = front >= 0
            cells = level_rows(None, tab, ell)[torch.clamp_min(front, 0)]
            mm = torch.where(valid, cells[..., 0], 0.0)
            com = cells[..., lay.c_com:lay.c_com + nd]
            half = cells[..., lay.c_half:lay.c_half + nd]
            gap = torch.clamp_min(torch.abs(com - cen[:, None, :])
                                  - half_g[:, None, :], 0.0)
            occ = mm > 0.0
            passed = _sum_sq(gap) * theta_sqd > _sum_sq(half)
            if ell < depth:
                accept = occ & passed
                open_ = occ & ~accept
            else:
                accept = occ
                flag |= (occ & ~passed).any(1)
                open_ = torch.zeros_like(accept)
            # the accepted cells' moments only (F35 repaired: the JAX
            # package adds the quadrupole of every other entry too)
            m_a = torch.where(accept, mm, 0.0)
            q6 = torch.where(accept[..., None],
                             cells[..., lay.c_q:lay.c_q + lay.nq], 0.0)[
                :, None] if quadrupole else None
            a_f, p_f = _multipole(com[:, None] - r_t[:, :, None],
                                  m_a[:, None], q6)
            a = a + torch.where(al[..., None], a_f.sum(2), 0.0)
            pot = pot + torch.where(al, p_f.sum(2), 0.0)
            counts[0] += int(occ.sum())
            counts[1] += int((accept.sum(1) * n_live).sum())
            if ell < depth:
                kids = torch.stack([torch.where(open_, 2 * front, -1),
                                    torch.where(open_, 2 * front + 1, -1)],
                                   -1).reshape(B, -1)
                keep = kids >= 0
                flag |= keep.sum(1) > wr
                front, _ = _stable_compact(keep, kids,
                                           min(wr, kids.shape[1]))
    return a, pot, flag


def let_far_walk_plain(tabs, leaf_cen, leaf_half, rt, alive, leaf_size,
                       wr, theta_sqd, quadrupole, stats: dict = None):
    """Plain version of K38: gandalf_tpu/parallel/let.py:far_group
    (:330-413) over chunks of the groups, the frontier the first `wr`
    children of the opened cells, in order, with F35 repaired, groups
    with no live target not walked.  A `stats` dict receives
    "mac_tests" (occupied cells tested) and "far_terms" (accepted cell
    times live target of its group), as tree_walk counts K6's."""
    G, nd = leaf_cen.shape
    L = leaf_size
    r_t = rt.reshape(G, L, nd)
    al = alive.reshape(G, L)
    budget = 1 << 24 if rt.is_cuda else 1 << 20
    width = min(wr, (tabs.shape[1] + 1) // 2)
    chunk = max(1, budget // (L * width * 16))
    counts = [0, 0]
    parts = [_far_chunk(tabs, leaf_cen[g0:g0 + chunk],
                        leaf_half[g0:g0 + chunk], r_t[g0:g0 + chunk],
                        al[g0:g0 + chunk], wr, theta_sqd, quadrupole,
                        counts)
             for g0 in range(0, G, chunk)]
    if stats is not None:
        stats.update(mac_tests=counts[0], far_terms=counts[1])
    return (torch.cat([p[0] for p in parts]).reshape(G * L, nd),
            torch.cat([p[1] for p in parts]).reshape(G * L),
            torch.cat([p[2] for p in parts]))


def _local_tables(plan: LetPlan, gmaps, rs, ms, hs, zhs, alives,
                  periodic_extent):
    """Each shard's bucket table (K4) and alive flags over its local
    buckets, and the local spec."""
    spec = plan.spec_comb
    loc_spec = dataclasses.replace(spec, n_pad=plan.g_loc * spec.leaf_size,
                                   depth=int(np.log2(plan.g_loc)))
    loc = [gather_to_buckets(loc_spec, gm, r, m, h, zh, periodic_extent, al)
           for gm, r, m, h, zh, al in zip(gmaps, rs, ms, hs, zhs, alives)]
    return loc_spec, [p for p, _ in loc], [al for _, al in loc]


def _far_inputs(group: ShardGroup, plan: LetPlan, loc_spec, ptabs,
                alive_ls):
    """K38's inputs of every shard, or None where the ring covers every
    shard: the far shards' published tables (each shard's local tree,
    K5, all_gathered), its leaves' boxes, its targets and which of them
    are live."""
    S = plan.n_shards
    _, far_ts = ring_offsets(S, plan.ring_radius)
    if not far_ts:
        return None
    nd = ptabs[0].shape[1] - 3
    lay = layout(nd)
    ctabs = [build_tree(loc_spec, p, al) for p, al in zip(ptabs, alive_ls)]
    pub = group.all_gather(ctabs)
    out = []
    for s in range(S):
        lv = level_rows(loc_spec, ctabs[s], loc_spec.depth)
        out.append((torch.stack([pub[s][(s + o) % S] for o in far_ts]),
                    lv[:, lay.c_cen:lay.c_cen + nd].contiguous(),
                    lv[:, lay.c_half:lay.c_half + nd].contiguous(),
                    ptabs[s][:, :nd].contiguous(), alive_ls[s]))
    return out


def far_walk_inputs(group: ShardGroup, plan: LetPlan, gmaps, rs, ms, hs,
                    zhs, alives, periodic_extent=None):
    """let_gravity's K38 inputs of every shard, (tabs, leaf centres, leaf
    halves, targets, live targets) each, or None without far shards."""
    loc_spec, ptabs, alive_ls = _local_tables(plan, gmaps, rs, ms, hs, zhs,
                                              alives, periodic_extent)
    return _far_inputs(group, plan, loc_spec, ptabs, alive_ls)


def let_gravity(group: ShardGroup, plan: LetPlan, gmaps: List[Tensor],
                rs: List[Tensor], ms: List[Tensor], hs: List[Tensor],
                zhs: List[Tensor], alives: List[Tensor], kern,
                periodic_extent=None, stats: dict = None):
    """Ring-LET gravity of every shard's particles
    (gandalf_tpu/parallel/let.py:236-431).  Per shard: gmaps[s] (G_loc,
    L) its bucket map of local slots, rs/ms/hs/zhs/alives its (cap, ...)
    blocks (ms the gravitating masses).  Returns (a list, gpot list,
    overflow) in local slot order.  `stats`, where given, receives the
    shard count of far tables walked ("far_tables")."""
    spec = plan.spec_comb
    S, L, G_loc = plan.n_shards, spec.leaf_size, plan.g_loc
    offs, far_ts = ring_offsets(S, plan.ring_radius)
    lb = offs.index(0)
    loc_spec, ptabs, alive_ls = _local_tables(plan, gmaps, rs, ms, hs, zhs,
                                              alives, periodic_extent)
    # the raw ring: shard s's block at offset o is shard (s + o)'s
    ring_p = {o: group.ppermute(ptabs, -o) for o in offs}
    ring_a = {o: group.ppermute(alive_ls, -o) for o in offs}
    far = _far_inputs(group, plan, loc_spec, ptabs, alive_ls)
    cap = rs[0].shape[0]
    a_out, p_out, flags = [], [], []
    for s in range(S):
        ptab = torch.cat([ring_p[o][s] for o in offs])
        alive_c = torch.cat([ring_a[o][s] for o in offs])
        dev, dt = ptab.device, ptab.dtype
        pad_rows = spec.n_pad - ptab.shape[0]
        if pad_rows:
            padrow = torch.zeros((pad_rows, ptab.shape[1]), dtype=dt,
                                 device=dev)
            padrow[:, layout(ptab.shape[1] - 3).p_h] = 1.0
            ptab = torch.cat([ptab, padrow])
            alive_c = torch.cat([alive_c, torch.zeros(
                (pad_rows,), dtype=torch.bool, device=dev)])
        ctab = build_tree(spec, ptab, alive_c)
        groups = torch.arange(lb * G_loc, (lb + 1) * G_loc,
                              dtype=torch.int32, device=dev)
        a_far, pot_far, near, ovf_w = tree_walk(spec, ctab, ptab, alive_c,
                                                groups)
        out_index = torch.full((spec.n_pad,), -1, dtype=torch.int32,
                               device=dev)
        flat = gmaps[s].reshape(-1).to(device=dev, dtype=torch.int32)
        out_index[lb * G_loc * L:(lb + 1) * G_loc * L] = flat
        a, pot, ovf_n = tree_near(spec, kern, ctab, ptab, alive_c, near,
                                  a_far, pot_far, out_index, cap, groups)
        flag = ovf_w | ovf_n
        if far is not None:
            a_f, p_f, fl = let_far_walk(*far[s], L, plan.remote_frontier,
                                        spec.theta_sqd, spec.quadrupole)
            ok = flat >= 0
            idx = flat[ok].long()
            a = a.index_add(0, idx, a_f[ok])
            pot = pot.index_add(0, idx, p_f[ok])
            flag = flag | fl.any()
        a_out.append(a)
        p_out.append(pot)
        flags.append(flag)
    if stats is not None:
        stats["far_tables"] = len(far_ts)
    return a_out, p_out, group.any(flags)
