"""Halo exchange for the structured-grid SPH pass over z-slab shards.

Counterpart of ``gandalf_tpu/parallel/halo.py``: the dense (nz, ny, nx,
K, ...) cell tensors are split along dim 0 into one slab per shard, and
each shard takes qz boundary rows from its ring neighbours (the
``ppermute`` of ``parallel/comm.py``); a shard thinner than qz rows takes
them from several hops.  At a periodic seam a position block is shifted
by -Lz or +Lz; across an open dim-0 edge the halo is zeros (fill False).
The other dims are not ghosted: K2 and K3 wrap them in the kernel.

K2 and K3 then run on each shard's ghosted slab (``slab_density``,
``slab_forces``): dim 0 open, the stencil qz rows deep, and only the
shard's own rows targets, a run-time row window.  The density results
need a second halo before the force pass, as in the JAX package's
``forces_grid27(..., ghost_fn)``.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..ops import sph_grid27 as g
from ..state import SphState
from .comm import ShardGroup

Tensor = torch.Tensor


def _shifted(block: Tensor, L: float) -> Tensor:
    """A position block with its dim-0 coordinate moved by L."""
    out = block.clone()
    out[..., 0] = block[..., 0] + L
    return out


def make_halo_ghost_fn(group: ShardGroup, global_spec, local_spec):
    """ghost(xs, shift_vec=False): each shard's slab with qz halo rows
    from its ring neighbours on each side of dim 0, (nz_loc + 2 qz, ...)
    (gandalf_tpu/parallel/halo.py:34-92, multi-hop where a slab is
    thinner than qz rows; a single hop sends the qz edge rows, where the
    JAX package sends the whole slab).  `shift_vec` marks a position
    tensor, shifted by -Lz / +Lz where a block crossed the periodic
    seam."""
    qz = global_spec.qz
    nz_loc = local_spec.ncells[0]
    n_hops = -(-qz // nz_loc)
    L = global_spec.extents[0]
    periodic = global_spec.periodic[0]
    S = group.size

    def fix(block, src_idx, shift_vec):
        wrapped_lo, wrapped_hi = src_idx < 0, src_idx > S - 1
        if periodic:
            if shift_vec and (wrapped_lo or wrapped_hi):
                return _shifted(block, -L if wrapped_lo else L)
            return block
        return torch.zeros_like(block) if wrapped_lo or wrapped_hi \
            else block

    def ghost(xs: List[Tensor], shift_vec: bool = False) -> List[Tensor]:
        lo_blocks = [[] for _ in range(S)]
        hi_blocks = [[] for _ in range(S)]
        # one hop needs only the qz edge rows; several pass whole slabs on
        if n_hops == 1:
            cur_lo, cur_hi = [x[nz_loc - qz:] for x in xs], \
                [x[:qz] for x in xs]
        else:
            cur_lo = cur_hi = xs
        for k in range(1, n_hops + 1):
            cur_lo = group.ppermute(cur_lo, 1, "halo")
            cur_hi = group.ppermute(cur_hi, -1, "halo")
            for s in range(S):
                lo_blocks[s].insert(0, fix(cur_lo[s], s - k, shift_vec))
                hi_blocks[s].append(fix(cur_hi[s], s + k, shift_vec))
        out = []
        for s in range(S):
            lo = torch.cat(lo_blocks[s])
            hi = torch.cat(hi_blocks[s])
            out.append(torch.cat([lo[lo.shape[0] - qz:], xs[s], hi[:qz]]))
        return out

    return ghost


def make_halo_ghost_fn_balanced(group: ShardGroup, global_spec, local_spec,
                                row_len):
    """ghost for the work-balanced decomposition
    (gandalf_tpu/parallel/halo.py:95-168): shard s owns the first
    row_len[s] of its nz_pad rows.  The low halo is the previous shard's
    last qz real rows; the next shard's first B = nz_pad - min(row_len) +
    qz rows land at row row_len[s] (the pad rows double as the receive
    window), and the slab is cut to nz_pad + qz rows: (nz_pad + 2 qz,
    ...) in all."""
    qz = global_spec.qz
    nz_pad = local_spec.ncells[0]
    lens = [int(x) for x in np.asarray(row_len)]
    B = int(nz_pad - min(lens) + qz)
    if min(lens) < qz:
        raise ValueError("balanced halo needs min(row_len) >= qz")
    L = global_spec.extents[0]
    periodic = global_spec.periodic[0]
    S = group.size

    def fix(block, wrapped, shift_vec):
        if periodic:
            if shift_vec and wrapped:
                return _shifted(block, -L if wrapped == 1 else L)
            return block
        return torch.zeros_like(block) if wrapped else block

    def ghost(xs: List[Tensor], shift_vec: bool = False) -> List[Tensor]:
        tails = [xs[s][lens[s] - qz:lens[s]] for s in range(S)]
        lo = group.ppermute(tails, 1, "halo")
        nxt = group.ppermute([x[:B] for x in xs], -1, "halo")
        out = []
        for s in range(S):
            x = xs[s]
            lo_s = fix(lo[s], 1 if s == 0 else 0, shift_vec)
            nxt_s = fix(nxt[s], -1 if s == S - 1 else 0, shift_vec)
            canvas = torch.cat([x, torch.zeros((B,) + tuple(x.shape[1:]),
                                               dtype=x.dtype,
                                               device=x.device)])
            canvas[lens[s]:lens[s] + B] = nxt_s
            out.append(torch.cat([lo_s, canvas[:nz_pad + qz]]))
        return out

    return ghost


class Slab(NamedTuple):
    """One shard's ghosted slab: its spec (slab_spec), the row window of
    its own rows, and the slice of those rows in the ghosted tensors."""

    spec: object
    win: Tuple[int, int]
    own: slice


def slabs(locs, qz: int, rows) -> List[Slab]:
    """The ghosted slab of each shard's local grid `locs[s]`, rows[s] of
    whose rows are real."""
    return [Slab(g.slab_spec(loc, qz), (qz, qz + int(n)),
                 slice(qz, qz + loc.ncells[0])) for loc, n in zip(locs, rows)]


def density_inputs(ghost, qz: int, r_ds, m_ds, h_ds, fills):
    """K2's ghosted inputs of every shard: positions (shifted across a
    periodic seam), masses and fill from the halo, and h with ones in the
    halo rows (never read: they are neighbours only)."""
    rg, mg, fg = ghost(r_ds, True), ghost(m_ds), ghost(fills)
    hg = []
    for h in h_ds:
        pad = torch.ones((qz,) + tuple(h.shape[1:]), dtype=h.dtype,
                         device=h.device)
        hg.append(torch.cat([pad, h, pad]))
    return rg, mg, hg, fg


def force_inputs(ghost, dense, fills):
    """K3's ghosted inputs of every shard: positions, velocities, the
    packed density results (FORCE_SCALARS) and fill from the halo."""
    packed = [torch.stack([d[k] for k in g.FORCE_SCALARS], dim=-1)
              for d in dense]
    return (ghost([d["r"] for d in dense], True),
            ghost([d["v"] for d in dense]), ghost(packed), ghost(fills))


def slab_density(ghost, kern, locs, qz: int, rows, h_fac: float,
                 h_converge: float, hmax: float, r_ds, m_ds, h_ds, fills):
    """K2 on each shard's ghosted slab, rows [qz, qz + rows[s]) targets,
    then the per-slot finish on the shard's own rows: a Grid27Density
    per shard."""
    ins = density_inputs(ghost, qz, r_ds, m_ds, h_ds, fills)
    out = []
    for s, (sl, loc) in enumerate(zip(slabs(locs, qz, rows), locs)):
        sums = g.density_sums(kern, sl.spec, h_fac, h_converge, hmax,
                              *(x[s] for x in ins), rows_win=sl.win)
        out.append(g.density_finish(loc, h_fac, hmax, m_ds[s], fills[s],
                                    *(x[sl.own] for x in sums)))
    return out


def slab_forces(ghost, kern, visc, locs, qz: int, rows, dense, fills):
    """K3 on each shard's ghosted slab, then the epilogue on the shard's
    own rows: (a, dudt, div_v, dalphadt) per shard."""
    ins = force_inputs(ghost, dense, fills)
    out = []
    for s, sl in enumerate(slabs(locs, qz, rows)):
        sums = g.force_sums(kern, visc, sl.spec, *(x[s] for x in ins),
                            rows_win=sl.win)
        out.append(g.forces_finish(visc, dense[s],
                                   *(x[sl.own] for x in sums)))
    return out


def hydro_pass_grid27_sharded(group: ShardGroup, kern, visc, box, spec,
                              eos, h_fac: float, h_converge: float,
                              hydro_forces: bool, s: SphState) -> SphState:
    """The grid hydro pass with the dense cell tensors split along z over
    the shard group and halo rows exchanged
    (gandalf_tpu/parallel/halo.py:170-244): binning and the scatter to
    dense storage stay on the state's device (replicated in the JAX
    package), the density iteration and force pass run per shard.
    Returns the updated state on the state's device.  No controller
    calls it: the grad-h controller runs dist_hydro_pass, whose state
    stays sharded (ROADMAP item 13)."""
    nd = s.ndim
    S = group.size
    if spec.ncells[0] % S != 0:
        raise ValueError(f"ncells[0]={spec.ncells[0]} not divisible by "
                         f"the {S}-shard group")
    nz_loc = spec.ncells[0] // S
    local_spec = dataclasses.replace(
        spec, ncells=(nz_loc,) + tuple(spec.ncells[1:]))
    b = g.bin_particles(spec, s.r)
    hmax = g.hmax_of(spec, kern.kernrange)

    def split(x_d):
        return [group.to(x_d[k * nz_loc:(k + 1) * nz_loc], k)
                for k in range(S)]

    def d(x):
        return split(g.to_dense(spec, b, x))

    fills = split(g.dense_fill_mask(spec, b))
    r_ds, v_ds, m_ds, h_ds = d(s.r), d(s.v), d(s.m), d(s.h)
    u_ds, alpha_ds = d(s.u), d(s.alpha)
    ghost = make_halo_ghost_fn(group, spec, local_spec)
    locs = [local_spec] * S
    rows = [nz_loc] * S
    dens = slab_density(ghost, kern, locs, spec.qz, rows, h_fac,
                        h_converge, hmax, r_ds, m_ds, h_ds, fills)
    thermo = [eos.thermal_update(torch.clamp_min(dn.rho, 1e-30), u)
              for dn, u in zip(dens, u_ds)]
    if hydro_forces:
        dense = [{"r": r_ds[k], "v": v_ds[k], "m": m_ds[k], "h": dn.h,
                  "rho": dn.rho, "u": th[0], "pressure": th[1],
                  "sound": th[2], "invomega": dn.invomega,
                  "hfactor": dn.hfactor, "alpha": alpha_ds[k]}
                 for k, (dn, th) in enumerate(zip(dens, thermo))]
        forces = slab_forces(ghost, kern, visc, locs, spec.qz, rows, dense,
                             fills)
    else:
        forces = [(torch.zeros_like(r), torch.zeros_like(m),
                   torch.zeros_like(m), None) for r, m in zip(r_ds, m_ds)]
    dev = s.r.device
    overflow = group.any([dn.overflow for dn in dens]).to(dev)

    def p(xs):
        return g.from_dense(spec, b, torch.cat([x.to(dev) for x in xs]))

    return s.replace(
        h=p([dn.h for dn in dens]), rho=p([dn.rho for dn in dens]),
        invomega=p([dn.invomega for dn in dens]),
        zeta=p([dn.zeta for dn in dens]),
        hfactor=p([dn.hfactor for dn in dens]),
        u=p([th[0] for th in thermo]), pressure=p([th[1] for th in thermo]),
        sound=p([th[2] for th in thermo]),
        a=p([f[0] for f in forces]).reshape(s.N, nd),
        dudt=p([f[1] for f in forces]), div_v=p([f[2] for f in forces]),
        neib_overflow=s.neib_overflow | overflow)
