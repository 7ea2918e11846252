"""Distributed runtime: z-slab decomposition, the sharded hydro pass,
replicated distributed gravity and device-side migration.

Counterpart of ``gandalf_tpu/parallel/dist.py`` (the reference's MPI
layer: MpiKDTreeDecomposition, Ghosts, the dt Allreduce) for grad-h SPH
without mirror walls:

- **Decomposition** (host, numpy; copies of the JAX package's planners):
  particles are assigned to z-slab shards of the structured grid and
  laid out shard-major in blocks padded to a common capacity; pads are
  dead (FLAG_DEAD, iorig -1).  ``balance="auto"`` re-splits clustered
  distributions on count-weighted contiguous row ranges.
- **Sharded state**: a list of per-shard SphStates of `cap` slots each,
  shard s on the shard group's device s (``parallel/comm.py``).
- **Hydro** (``dist_hydro_pass``): per-shard binning into the local slab
  (K1 with ``zrow_max``; positions unwrapped about the slab centre at a
  periodic seam), halo rows from the ring neighbours, K2 and K3 on the
  ghosted slab (``parallel/halo.py``).
- **Replicated gravity** (``dist_tree_gravity``): every shard gathers all
  particles, builds the same tree (K4, K5) and walks only its own group
  range (K6, K7 in their list mode); the partial results are summed.
  No controller calls it yet: the grad-h controller always has a ring
  LET (``parallel/let.py``) over its Nmpi > 1 shards, and distributed
  MFV, which takes it in the JAX package, is still to port (ROADMAP
  item 13).
- **Migration** (``migrate_particles``): particles that left their slab
  move to their owner shard with one all_to_all of fixed capacity.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..ops import sph_grid27 as g
from ..ops.tree import (build_tree, gather_to_buckets, tree_near,
                        tree_walk)
from ..state import FLAG_DEAD, SphState
from .comm import ShardGroup
from .halo import (make_halo_ghost_fn, make_halo_ghost_fn_balanced,
                   slab_density, slab_forces)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Host-side decomposition plan (rebuilt every ntreebuildstep); the
    fields of gandalf_tpu's DistPlan."""

    n_shards: int
    cap: int                 # per-shard particle capacity (padded)
    perm: np.ndarray         # (n_shards*cap,) slot -> original id, -1 pad
    local_spec: object       # per-shard Grid27Spec (padded row count)
    global_spec: object      # full-domain Grid27Spec
    # shard s owns the contiguous global rows [row_start[s], row_start[s]
    # + row_len[s]); the rows of the padded local tensor beyond row_len
    # are empty and double as the receive window of the next shard's
    # halo block.  balanced=False is the uniform split.
    row_start: np.ndarray = None     # (S,) int
    row_len: np.ndarray = None       # (S,) int
    balanced: bool = False


def _balance_rows(row_w: np.ndarray, n_shards: int, min_len: int):
    """Split rows into n_shards contiguous segments near the weight
    quantiles, every segment >= min_len rows
    (gandalf_tpu/parallel/dist.py:69-101).  Returns (start, length)
    arrays, or (None, None)."""
    nz = len(row_w)
    pref = np.concatenate([[0.0], np.cumsum(row_w)])
    target = pref[-1] / n_shards
    starts, start = [], 0
    for s in range(n_shards):
        rem_shards = n_shards - s - 1
        if s == n_shards - 1:
            end = nz
        else:
            end = int(np.searchsorted(pref, (s + 1) * target,
                                      side="left"))
            end = max(end, start + min_len)
            end = min(end, nz - rem_shards * min_len)
        starts.append(start)
        start = end
    starts = np.asarray(starts, np.int64)
    lens = np.diff(np.concatenate([starts, [nz]]))
    if (lens < min_len).any():
        return None, None
    return starts, lens


def plan_decomposition(spec, r: np.ndarray, n_shards: int,
                       slack: float = 1.25,
                       balance: str = "never") -> DistPlan:
    """Assign particles to z-slab shards and build the padded layout
    (gandalf_tpu/parallel/dist.py:104-179).  balance="auto" re-splits on
    count-weighted contiguous row ranges when the uniform split's count
    imbalance exceeds 1.5x."""
    nz = spec.ncells[0]
    if nz % n_shards != 0:
        raise ValueError(
            f"grid z rows ({nz}) not divisible by n_shards ({n_shards}); "
            "build the spec with plan_grid27(..., z_multiple=n_shards)")
    nz_loc = nz // n_shards
    if any(k == 0 for (k, _side) in spec.mirror) and nz_loc < 2:
        raise ValueError(
            "mirror walls on the slab axis need >= 2 rows per shard")
    cell0 = spec.extents[0] / nz
    iz = np.clip(((r[:, 0] - spec.lo[0]) / cell0).astype(np.int64),
                 0, nz - 1)

    row_start = np.arange(n_shards, dtype=np.int64) * nz_loc
    row_len = np.full(n_shards, nz_loc, np.int64)
    balanced = False
    if balance == "auto" and n_shards >= 2 and not spec.mirror:
        row_counts = np.bincount(iz, minlength=nz).astype(np.float64)
        uni = np.add.reduceat(row_counts, row_start)
        mean = max(row_counts.sum() / n_shards, 1.0)
        min_len = max(spec.qz, 1)
        if uni.max() > 1.5 * mean and nz >= n_shards * min_len:
            st, ln = _balance_rows(row_counts, n_shards, min_len)
            if (st is not None and ln.max() > ln.min()
                    and ln.max() <= 4 * nz_loc):
                row_start, row_len, balanced = st, ln, True

    if balanced:
        bounds = np.concatenate([row_start, [nz]])
        shard = np.searchsorted(bounds, iz, side="right") - 1
        nz_pad = min(-(-int(row_len.max()) // nz_loc) * nz_loc, nz)
    else:
        shard = iz // nz_loc
        nz_pad = nz_loc
    counts = np.bincount(shard, minlength=n_shards)
    cap = int(counts.max() * slack) + 8
    cap = -(-cap // 64) * 64
    order = np.argsort(shard, kind="stable")
    perm = np.full(n_shards * cap, -1, np.int64)
    start = 0
    for s in range(n_shards):
        n_s = counts[s]
        perm[s * cap: s * cap + n_s] = order[start: start + n_s]
        start += n_s
    # the local slab grid keeps the global cell size
    local_spec = dataclasses.replace(
        spec, ncells=(nz_pad,) + tuple(spec.ncells[1:]),
        extents=(nz_pad * cell0,) + tuple(spec.extents[1:]))
    return DistPlan(n_shards=n_shards, cap=cap, perm=perm,
                    local_spec=local_spec, global_spec=spec,
                    row_start=row_start, row_len=row_len,
                    balanced=balanced)


# the per-particle float fields whose pads take 0 (shard_state)
_ZERO_FIELDS = ("m", "rho", "u", "u0", "pressure", "sound", "dudt",
                "dudt0", "gpot", "zeta", "hfactor", "div_v", "alpha",
                "ionfrac", "dt_part", "ueq")
# the fields of SphState that are not per particle
_GLOBAL_FIELDS = ("t", "dt", "nstep", "neib_overflow", "bucket_map",
                  "walk_mp", "walk_near", "walk_plan_r", "walk_anchors",
                  "walk_margin", "sinks")


def _per_particle(name: str, x, n: int) -> bool:
    return (name not in _GLOBAL_FIELDS and isinstance(x, torch.Tensor)
            and x.dim() >= 1 and x.shape[0] == n)


def shard_state(group: ShardGroup, plan: DistPlan,
                s: SphState) -> List[SphState]:
    """The particle state in the padded shard-major order, one block of
    `cap` slots per shard on its device
    (gandalf_tpu/parallel/dist.py:182-223).  Pads are dead (FLAG_DEAD),
    carry iorig -1, sit at the domain's mid z with h = 1 and zeros
    elsewhere; the global scalars are replicated."""
    dev = s.r.device
    idx = torch.as_tensor(np.maximum(plan.perm, 0), device=dev)
    pad = torch.as_tensor(plan.perm < 0, device=dev)
    far = plan.global_spec.lo[0] + 0.5 * plan.global_spec.extents[0]

    def pick(x, fill):
        out = x[idx]
        mask = pad.reshape((-1,) + (1,) * (out.dim() - 1))
        return torch.where(mask, torch.as_tensor(fill, dtype=out.dtype,
                                                 device=dev), out)

    glob = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if not _per_particle(f.name, v, s.N):
            continue
        if f.name == "flags":
            glob[f.name] = torch.where(pad, v[idx] | FLAG_DEAD, v[idx])
        elif f.name == "iorig":
            glob[f.name] = torch.where(pad, -1, v[idx]).to(v.dtype)
        elif f.name == "r":
            glob[f.name] = pick(v, far)
        elif f.name == "h":
            glob[f.name] = pick(v, 1.0)
        elif f.name in _ZERO_FIELDS:
            glob[f.name] = pick(v, 0.0)
        else:
            glob[f.name] = pick(v, 0)
    cap = plan.cap
    out = []
    for k in range(plan.n_shards):
        kw = {n: group.to(x[k * cap:(k + 1) * cap], k)
              for n, x in glob.items()}
        for n in _GLOBAL_FIELDS:
            v = getattr(s, n)
            kw[n] = group.to(v, k) if isinstance(v, torch.Tensor) else v
        out.append(s.replace(**kw))
    return out


def _inverse(plan: DistPlan, n_orig: int) -> np.ndarray:
    inv = np.full(n_orig, 0, np.int64)
    src = plan.perm >= 0
    inv[plan.perm[src]] = np.nonzero(src)[0]
    return inv


def unshard_array(plan: DistPlan, x, n_orig: int) -> np.ndarray:
    """Padded shard-major order -> original particle order (host)."""
    return np.asarray(x)[_inverse(plan, n_orig)]


def shard_array(plan: DistPlan, x, fill) -> np.ndarray:
    """Original particle order -> padded shard-major order (host)."""
    x = np.asarray(x)
    out = np.full((len(plan.perm),) + x.shape[1:], fill, x.dtype)
    src = plan.perm >= 0
    out[src] = x[plan.perm[src]]
    return out


def unshard_state(plan: DistPlan, states: List[SphState], n_orig: int,
                  device=None) -> SphState:
    """Back to one state in the original particle order, on `device`
    (shard 0's by default), for snapshots, restarts and replans
    (gandalf_tpu/parallel/dist.py:245-259); the global scalars are
    shard 0's."""
    device = states[0].r.device if device is None else torch.device(device)
    idx = torch.as_tensor(_inverse(plan, n_orig), device=device)
    s0 = states[0]
    kw = {}
    for f in dataclasses.fields(s0):
        v = getattr(s0, f.name)
        if _per_particle(f.name, v, s0.N):
            whole = torch.cat([getattr(st, f.name).to(device)
                               for st in states])
            kw[f.name] = whole[idx]
        elif isinstance(v, torch.Tensor) and f.name != "bucket_map":
            kw[f.name] = v.to(device)
    kw["bucket_map"] = None
    return s0.replace(**kw)


def concat_shards(states: List[SphState], device=None) -> SphState:
    """The shards as one state in the padded shard-major order, on
    `device` (shard 0's by default): the JAX package's sharded state as
    one array; the global scalars are shard 0's."""
    device = states[0].r.device if device is None else torch.device(device)
    s0 = states[0]
    kw = {}
    for f in dataclasses.fields(s0):
        v = getattr(s0, f.name)
        if _per_particle(f.name, v, s0.N):
            kw[f.name] = torch.cat([getattr(st, f.name).to(device)
                                    for st in states])
        elif isinstance(v, torch.Tensor) and f.name != "bucket_map":
            kw[f.name] = v.to(device)
    kw["bucket_map"] = None
    return s0.replace(**kw)


def plan_ghost_fn(group: ShardGroup, plan: DistPlan):
    """The halo ghost function of the plan's decomposition
    (gandalf_tpu/parallel/dist.py:281-288)."""
    if plan.balanced:
        return make_halo_ghost_fn_balanced(group, plan.global_spec,
                                           plan.local_spec, plan.row_len)
    return make_halo_ghost_fn(group, plan.global_spec, plan.local_spec)


def shard_local_binning(plan: DistPlan, box, s: SphState, alive: Tensor,
                        idx: int):
    """Shard idx's slab spec, its positions with z unwrapped about the
    slab centre (a particle that crossed the periodic seam since the
    plan lands on the right edge row), and their binning (K1: pads go to
    the virtual cell, strays clamp into the shard's real rows)
    (gandalf_tpu/parallel/dist.py:291-330)."""
    spec, local = plan.global_spec, plan.local_spec
    cell0 = spec.extents[0] / spec.ncells[0]
    nz_loc = local.ncells[0]
    if plan.balanced:
        z0 = spec.lo[0] + float(plan.row_start[idx]) * cell0
        nz_real = float(plan.row_len[idx])
    else:
        z0 = spec.lo[0] + (idx * nz_loc) * cell0
        nz_real = float(nz_loc)
    loc = dataclasses.replace(local, lo=(z0,) + tuple(local.lo[1:]))
    r_loc = s.r
    if 0 in box.periodic_dims():
        Lz = spec.extents[0]
        zc = z0 + 0.5 * nz_real * cell0
        dz = r_loc[:, 0] - zc
        dz = dz - Lz * torch.round(dz / Lz)
        r_loc = torch.cat([(zc + dz)[:, None], r_loc[:, 1:]], dim=1)
    b = g.bin_particles(loc, r_loc, discard=~alive,
                        zrow_max=int(plan.row_len[idx]) - 1)
    return loc, r_loc, b


def _from_dense_masked(spec, b, x_d: Tensor, alive: Tensor, dead):
    """x_d (*ncells, K, ...) back to the shard's slots; a pad (binned to
    the virtual cell) takes `dead`."""
    C = spec.total_cells
    safe = g.GridBinning(torch.clamp(b.cell_of, max=C - 1), b.slot_of,
                         b.overflow)
    x = g.from_dense(spec, safe, x_d)
    keep = alive if x.dim() == 1 else alive[:, None]
    return torch.where(keep, x, dead)


def dist_hydro_pass(group: ShardGroup, plan: DistPlan, kern, visc, box,
                    eos, h_fac: float, h_converge: float,
                    hydro_forces: bool, states: List[SphState],
                    alives: List[Tensor]) -> List[SphState]:
    """Sharded density, EOS and hydro forces
    (gandalf_tpu/parallel/dist.py:580-627): per-shard binning into the
    local slab, halo rows, K2 and K3 on the ghosted slabs, results back
    to each shard's slots.  The overflow flag (any shard's binning or
    density) replaces each state's."""
    spec = plan.global_spec
    if spec.mirror:
        raise NotImplementedError(
            "mirror walls over shards are not ported yet (ROADMAP queue 1, "
            "item 13)")
    S = group.size
    hmax = g.hmax_of(spec, kern.kernrange)
    bins = [shard_local_binning(plan, box, st, al, k)
            for k, (st, al) in enumerate(zip(states, alives))]
    locs = [b[0] for b in bins]

    def dense(k, x):
        return g.to_dense(locs[k], bins[k][2], x)

    fills = [g.dense_fill_mask(locs[k], bins[k][2]) & dense(k, alives[k])
             for k in range(S)]
    r_ds = [dense(k, bins[k][1]) for k in range(S)]
    m_ds = [dense(k, st.m) for k, st in enumerate(states)]
    h_ds = [dense(k, st.h) for k, st in enumerate(states)]
    ghost = plan_ghost_fn(group, plan)
    qz = spec.qz
    dens = slab_density(ghost, kern, locs, qz, plan.row_len, h_fac,
                        h_converge, hmax, r_ds, m_ds, h_ds, fills)
    thermo = [eos.thermal_update(torch.clamp_min(dn.rho, 1e-30),
                                 dense(k, states[k].u))
              for k, dn in enumerate(dens)]
    if hydro_forces:
        fields = [{"r": r_ds[k], "v": dense(k, st.v), "m": m_ds[k],
                   "h": dens[k].h, "rho": dens[k].rho, "u": thermo[k][0],
                   "pressure": thermo[k][1], "sound": thermo[k][2],
                   "invomega": dens[k].invomega,
                   "hfactor": dens[k].hfactor,
                   "alpha": dense(k, st.alpha)}
                  for k, st in enumerate(states)]
        forces = slab_forces(ghost, kern, visc, locs, qz, plan.row_len,
                             fields, fills)
    overflow = group.any([dn.overflow | b[2].overflow
                          for dn, b in zip(dens, bins)])
    out = []
    for k, st in enumerate(states):
        live, b = alives[k], bins[k][2]

        def back(x_d, dead):
            return _from_dense_masked(locs[k], b, x_d, live, dead)

        dn, th = dens[k], thermo[k]
        if hydro_forces:
            a_new = back(forces[k][0], 0.0)
            dudt_new, div_v_new = back(forces[k][1], 0.0), back(
                forces[k][2], 0.0)
        else:
            a_new = torch.zeros_like(st.r)
            dudt_new = torch.zeros_like(st.m)
            div_v_new = torch.zeros_like(st.m)
        out.append(st.replace(
            h=back(dn.h, 1.0), rho=back(dn.rho, 1.0),
            invomega=back(dn.invomega, 1.0), zeta=back(dn.zeta, 0.0),
            hfactor=back(dn.hfactor, 0.0), u=back(th[0], 1e-30),
            pressure=back(th[1], 0.0), sound=back(th[2], 0.0), a=a_new,
            dudt=dudt_new, div_v=div_v_new,
            neib_overflow=group.to(overflow, k)))
    return out


def dist_tree_gravity(group: ShardGroup, treespec, bucket_map: Tensor,
                      states: List[SphState], ms: List[Tensor], kern,
                      alives: List[Tensor], periodic_extent=None):
    """Replicated distributed Barnes-Hut gravity
    (gandalf_tpu/parallel/dist.py:696-761): every shard gathers (r, m,
    h, zeta hfactor, alive) of all shards, gathers them into the global
    bucket order (K4) and builds the same tree (K5), walks only its own
    contiguous group range (K6 and K7 over a group list), and the
    partial results are summed over shards.  `bucket_map` (G, L) holds
    global slot ids; `ms` the gravitating masses.  Returns (a list,
    gpot list, overflow)."""
    S = group.size
    G = treespec.n_leaves
    G_loc = G // S
    cap = states[0].N
    r_all = group.all_gather([st.r for st in states], tiled=True)
    m_all = group.all_gather([torch.where(al, m, 0.0)
                              for m, al in zip(ms, alives)], tiled=True)
    h_all = group.all_gather([st.h for st in states], tiled=True)
    zh_all = group.all_gather([st.zeta * st.hfactor for st in states],
                              tiled=True)
    alive_all = group.all_gather(alives, tiled=True)
    a_parts, p_parts, flags = [], [], []
    for k in range(S):
        gm = group.to(bucket_map, k)
        ptab, alive_s = gather_to_buckets(treespec, gm, r_all[k], m_all[k],
                                          h_all[k], zh_all[k],
                                          periodic_extent, alive_all[k])
        ctab = build_tree(treespec, ptab, alive_s)
        groups = torch.arange(k * G_loc, (k + 1) * G_loc, dtype=torch.int32,
                              device=ptab.device)
        a_far, pot_far, near, ovf_w = tree_walk(treespec, ctab, ptab,
                                                alive_s, groups)
        a, gpot, ovf_n = tree_near(treespec, kern, ctab, ptab, alive_s,
                                   near, a_far, pot_far, gm.reshape(-1),
                                   S * cap, groups)
        a_parts.append(a)
        p_parts.append(gpot)
        flags.append(ovf_w | ovf_n)
    a_glob = group.psum(a_parts)
    p_glob = group.psum(p_parts)
    overflow = group.any(flags)
    return ([a_glob[k][k * cap:(k + 1) * cap] for k in range(S)],
            [p_glob[k][k * cap:(k + 1) * cap] for k in range(S)], overflow)


def migrate_particles(group: ShardGroup, plan: DistPlan,
                      states: List[SphState], extra=(),
                      mig_cap: Optional[int] = None):
    """Move the particles that left their owner z-slab to the owning
    shard with one all_to_all (gandalf_tpu/parallel/dist.py:955-1058):
    each shard packs its leavers by destination into (S, M) buckets,
    receives (S, M) arrivals, kills its leavers and places the arrivals
    into its free slots (true pads, iorig < 0, and the vacated slots).
    `extra` holds per-shard lists of further per-particle arrays that
    move with the particles.  Returns (states, extra, overflow): overflow
    when a shard had more than M leavers to one destination or more
    arrivals than free slots (the caller replans on the host).  Plain
    torch: sort and compaction glue, no kernel."""
    gs = plan.global_spec
    nz = gs.ncells[0]
    nz_loc = plan.local_spec.ncells[0]
    cap, S = plan.cap, plan.n_shards
    M = min(mig_cap or max(64, cap // 16), cap)
    cell0 = gs.extents[0] / nz
    bounds = np.concatenate([plan.row_start, [nz]])
    send_idx, send_valid, recv_base = [], [], []
    over_out = []
    for me, st in enumerate(states):
        dev = st.r.device
        iz = torch.clamp(torch.floor((st.r[:, 0] - gs.lo[0]) / cell0), 0,
                         nz - 1).to(torch.int64)
        if plan.balanced:
            b_t = torch.as_tensor(bounds, device=dev)
            dest = torch.clamp(torch.searchsorted(b_t, iz, right=True) - 1,
                               0, S - 1)
        else:
            dest = torch.clamp(iz // nz_loc, 0, S - 1)
        leave = st.alive & (dest != me)
        sort_key = torch.where(leave, dest, S)
        order = torch.argsort(sort_key, stable=True)
        cnt = torch.bincount(dest[leave], minlength=S)
        off = torch.cumsum(cnt, 0) - cnt
        mth = torch.arange(M, device=dev)
        gpos = off[:, None] + mth[None, :]
        valid = mth[None, :] < cnt[:, None]
        idx = torch.where(valid, order[torch.clamp(gpos, 0, cap - 1)], 0)
        send_idx.append(idx)
        send_valid.append(valid)
        over_out.append(cnt.max() > M)
        recv_base.append(leave)
    valid_recv = group.all_to_all(send_valid)
    targets, arr_orders, overflows = [], [], []
    for me, st in enumerate(states):
        dev = st.r.device
        leave = recv_base[me]
        arr_valid = valid_recv[me].reshape(-1)
        free = leave | (st.iorig < 0)
        free_ids = torch.argsort((~free).to(torch.uint8), stable=True)
        n_free = free.sum()
        arr_order = torch.argsort((~arr_valid).to(torch.uint8), stable=True)
        n_arr = arr_valid.sum()
        k = torch.arange(S * M, device=dev)
        place_ok = (k < n_arr) & (k < n_free)
        target = torch.where(place_ok, free_ids[torch.clamp(k, 0, cap - 1)],
                             cap)
        targets.append(target)
        arr_orders.append(arr_order)
        overflows.append(over_out[me] | (n_arr > n_free))

    def move(xs, bases=None):
        bufs = group.all_to_all([x[i] for x, i in zip(xs, send_idx)])
        out = []
        for me, x in enumerate(xs):
            arr = bufs[me].reshape((S * M,) + tuple(x.shape[1:]))
            arr = arr[arr_orders[me]]
            base = (x if bases is None else bases[me]).clone()
            ok = targets[me] < cap
            base[targets[me][ok]] = arr[ok]
            out.append(base)
        return out

    new = [dict() for _ in states]
    for f in dataclasses.fields(states[0]):
        v0 = getattr(states[0], f.name)
        if not _per_particle(f.name, v0, cap):
            continue
        xs = [getattr(st, f.name) for st in states]
        if f.name == "flags":
            bases = [torch.where(lv, x | FLAG_DEAD, x)
                     for x, lv in zip(xs, recv_base)]
            moved = move(xs, bases)
        elif f.name == "iorig":
            bases = [torch.where(lv, -1, x).to(x.dtype)
                     for x, lv in zip(xs, recv_base)]
            moved = move(xs, bases)
        else:
            moved = move(xs)
        for me in range(S):
            new[me][f.name] = moved[me]
    out_extra = tuple(move(list(xs)) for xs in extra)
    overflow = group.any(overflows)
    return ([st.replace(**kw) for st, kw in zip(states, new)], out_extra,
            overflow)


def perm_from_iorig(plan: DistPlan, iorigs: List[Tensor]) -> DistPlan:
    """The host slot -> original-id permutation rebuilt from the shards'
    iorig after device-side migrations (lazy: only where the host needs
    the original order)."""
    perm = np.concatenate([x.detach().cpu().numpy() for x in iorigs]
                          ).astype(np.int64)
    return dataclasses.replace(plan, perm=np.where(perm >= 0, perm, -1))
