"""Sink particles: creation and accretion in pre-allocated slots.

Counterpart of ``gandalf_tpu/ops/sinks.py`` (the reference's Sinks,
src/Nbody/Sinks.cpp:118-520) for plain accretion (``smooth_accretion =
0``).  Sinks and stars live in a fixed number of slots with an
``active`` mask; a step creates at most one sink, from the densest alive
gas particle above ``rho_sink``, in the first free slot, and each active
sink then eats the gas within ``sink_radius`` times its h that lies
nearer to it than to any other active sink, conserving mass, momentum
and the centre of mass.  Eaten gas dies (the caller zeroes its mass and
motion).

``sink_candidate`` (K17) and ``accretion_sums`` (K18) launch the kernels
of ``csrc/sinks.cu`` on CUDA tensors and run their plain PyTorch versions
``*_plain`` on CPU tensors; ``apply_sink_creation`` and
``apply_accretion`` are elementwise torch on both, so a step reads
nothing back to the host.  The plain versions chunk the (N, Ns) pair
arrays of the JAX form over gas rows.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import _ext

Tensor = torch.Tensor

# pairs per chunk of gas rows in the plain version of K18
_CHUNK_PAIRS = 1 << 22


@dataclasses.dataclass(frozen=True)
class SinkConfig:
    rho_sink: float
    sink_radius: float      # in units of h (sink_radius_mode = hmult)
    create: bool
    accrete: bool


@dataclasses.dataclass
class SinkState:
    """Pre-allocated sink and star slots (leapfrog-KDK integrated)."""

    r: Tensor        # (Ns, ndim)
    v: Tensor
    a: Tensor
    r0: Tensor
    v0: Tensor
    a0: Tensor
    m: Tensor        # (Ns,)
    h: Tensor        # softening and accretion smoothing scale
    active: Tensor   # (Ns,) bool
    angmom: Tensor   # (Ns, 3) accreted spin (smooth accretion only)
    mdot: Tensor     # (Ns,) accretion rate of the last step

    @property
    def N(self) -> int:
        return self.m.shape[0]

    def replace(self, **kw) -> "SinkState":
        return dataclasses.replace(self, **kw)


def empty_sinks(n_max: int, ndim: int, device="cpu",
                dtype=torch.float64) -> SinkState:
    kw = dict(device=device, dtype=dtype)
    z = torch.zeros((n_max, ndim), **kw)
    return SinkState(r=z, v=z, a=z, r0=z, v0=z, a0=z,
                     m=torch.zeros((n_max,), **kw),
                     h=torch.ones((n_max,), **kw),
                     active=torch.zeros((n_max,), dtype=torch.bool,
                                        device=device),
                     angmom=torch.zeros((n_max, 3), **kw),
                     mdot=torch.zeros((n_max,), **kw))


def make_sinks(r, v, m, h, n_extra: int = 0, device="cpu",
               dtype=torch.float64) -> SinkState:
    """SinkState from star IC arrays plus n_extra empty creation slots."""
    r = np.asarray(r, dtype=np.float64)
    n, ndim = r.shape
    kw = dict(device=device, dtype=dtype)

    def slots(x, fill):
        x = np.asarray(x, dtype=np.float64)
        out = np.full((n + n_extra,) + x.shape[1:], fill, np.float64)
        out[:n] = x
        return torch.as_tensor(out, **kw)

    base = empty_sinks(n + n_extra, ndim, device, dtype)
    return base.replace(r=slots(r, 0.0), r0=slots(r, 0.0),
                        v=slots(v, 0.0), v0=slots(v, 0.0),
                        m=slots(m, 0.0), h=slots(h, 1.0),
                        active=torch.arange(n + n_extra, device=device) < n)


# ---------------------------------------------------------------------------
# K17: the creation candidate
# ---------------------------------------------------------------------------

def sink_candidate(cfg: SinkConfig, r: Tensor, v: Tensor, m: Tensor,
                   h: Tensor, rho: Tensor, alive: Tensor):
    """The densest alive gas particle with rho > rho_sink as a packed
    row [r, v, m, h, score] (2 ndim + 3,) and its index gi, a 0-d int64
    tensor: score is its rho, or -inf (and gi 0) when no particle is
    eligible; ties go to the lower index.  K17 on CUDA tensors."""
    if r.is_cuda:
        return _ext.sink_candidate(rho.contiguous(), alive.contiguous(),
                                   cfg.rho_sink, r.contiguous(),
                                   v.contiguous(), m.contiguous(),
                                   h.contiguous())
    return sink_candidate_plain(cfg, r, v, m, h, rho, alive)


def sink_candidate_plain(cfg: SinkConfig, r, v, m, h, rho, alive):
    """Plain version of K17: the JAX formula (torch.argmax keeps the
    first of equal maxima, as jnp.argmax)."""
    eligible = alive & (rho > cfg.rho_sink)
    score = torch.where(eligible, rho, -math.inf)
    gi = torch.argmax(score)
    cand = torch.cat([r[gi], v[gi], torch.stack([m[gi], h[gi], score[gi]])])
    return cand, gi


def apply_sink_creation(sinks: SinkState, cand: Tensor, ndim: int):
    """Activate the first free slot from a packed candidate row, unless
    its score is -inf or no slot is free.  Returns (sinks, created), a
    0-d bool tensor."""
    score = cand[2 * ndim + 2]
    free = ~sinks.active
    do_create = (score > -math.inf) & free.any()
    slot = torch.argmax(free.to(torch.uint8))
    sel = (torch.arange(sinks.N, device=cand.device) == slot) & do_create
    col = sel[:, None]
    r_c, v_c = cand[:ndim], cand[ndim:2 * ndim]
    m_c, h_c = cand[2 * ndim], cand[2 * ndim + 1]
    zed = torch.zeros_like(sinks.a)
    new = sinks.replace(
        r=torch.where(col, r_c, sinks.r), r0=torch.where(col, r_c, sinks.r0),
        v=torch.where(col, v_c, sinks.v), v0=torch.where(col, v_c, sinks.v0),
        a=torch.where(col, zed, sinks.a), a0=torch.where(col, zed, sinks.a0),
        m=torch.where(sel, m_c, sinks.m), h=torch.where(sel, h_c, sinks.h),
        active=sinks.active | sel)
    return new, do_create


def create_sinks(cfg: SinkConfig, sinks: SinkState, r, v, m, h, rho,
                 alive):
    """Convert the densest eligible gas particle into a sink (at most one
    a call, as the reference's per-step search).  Returns the sinks and
    the gas alive mask with that particle dead."""
    cand, gi = sink_candidate(cfg, r, v, m, h, rho, alive)
    new, created = apply_sink_creation(sinks, cand, r.shape[1])
    taken = (torch.arange(r.shape[0], device=r.device) == gi) & created
    return new, alive & ~taken


# ---------------------------------------------------------------------------
# K18: accretion
# ---------------------------------------------------------------------------

def accretion_sums(cfg: SinkConfig, sinks: SinkState, r: Tensor, v: Tensor,
                   m: Tensor, alive: Tensor):
    """Per-slot accretion sums (dm (Ns,), dmom and dmr (Ns, ndim)) and
    the eaten mask (N,): each alive gas particle within sink_radius h_s
    of an active sink goes to the nearest such sink (the first slot of
    equal distances).  K18 on CUDA tensors."""
    if r.is_cuda:
        return _ext.accretion_sums(r.contiguous(), v.contiguous(),
                                   m.contiguous(), alive.contiguous(),
                                   sinks.r.contiguous(),
                                   sinks.h.contiguous(),
                                   sinks.active.contiguous(),
                                   cfg.sink_radius)
    return accretion_sums_plain(cfg, sinks, r, v, m, alive)


def accretion_sums_plain(cfg: SinkConfig, sinks: SinkState, r, v, m,
                         alive):
    """Plain version of K18: the JAX formula over chunks of gas rows,
    with dist = sqrt((dx^2 + dy^2) + dz^2) written out, so that the
    masks do not depend on a reduction's order."""
    N, ndim = r.shape
    Ns = sinks.N
    racc = cfg.sink_radius * sinks.h
    step = max(1, _CHUNK_PAIRS // max(Ns, 1))
    nearest, eaten = [], []
    for c0 in range(0, N, step):
        rc = r[c0:c0 + step]
        d2 = None
        for k in range(ndim):
            dk = rc[:, None, k] - sinks.r[None, :, k]
            d2 = dk * dk if d2 is None else d2 + dk * dk
        dist = torch.sqrt(d2)
        inside = (dist < racc[None, :]) & sinks.active[None, :]
        nearest.append(torch.argmin(torch.where(inside, dist, math.inf),
                                    dim=1))
        eaten.append(alive[c0:c0 + step] & inside.any(dim=1))
    nearest = torch.cat(nearest)
    eaten = torch.cat(eaten)
    w = torch.where(eaten, m, 0.0)
    dm = torch.zeros((Ns,), dtype=m.dtype, device=m.device) \
        .index_add_(0, nearest, w)
    dmom = torch.zeros_like(sinks.v).index_add_(0, nearest, w[:, None] * v)
    dmr = torch.zeros_like(sinks.r).index_add_(0, nearest, w[:, None] * r)
    return dm, dmom, dmr, eaten


def apply_accretion(sinks: SinkState, dm: Tensor, dmom: Tensor,
                    dmr: Tensor) -> SinkState:
    """Mass, momentum and centre-of-mass conserving sink update from the
    accretion sums."""
    m_new = sinks.m + dm
    msafe = torch.clamp_min(m_new, 1e-300)
    v_new = (sinks.m[:, None] * sinks.v + dmom) / msafe[:, None]
    r_new = (sinks.m[:, None] * sinks.r + dmr) / msafe[:, None]
    upd = sinks.active & (dm > 0)
    col = upd[:, None]
    return sinks.replace(
        r=torch.where(col, r_new, sinks.r),
        v=torch.where(col, v_new, sinks.v),
        r0=torch.where(col, r_new, sinks.r0),
        v0=torch.where(col, v_new, sinks.v0),
        m=torch.where(upd, m_new, sinks.m))


def accrete_to_sinks(cfg: SinkConfig, sinks: SinkState, r, v, m, alive):
    """Accrete the gas within each sink's accretion radius (sink_radius
    h_s).  Returns the sinks and the gas alive mask without the eaten."""
    dm, dmom, dmr, eaten = accretion_sums(cfg, sinks, r, v, m, alive)
    return apply_accretion(sinks, dm, dmom, dmr), alive & ~eaten
