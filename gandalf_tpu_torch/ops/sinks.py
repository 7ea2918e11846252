"""Sink particles: creation and accretion in pre-allocated slots.

Counterpart of ``gandalf_tpu/ops/sinks.py`` (the reference's Sinks,
src/Nbody/Sinks.cpp:118-720).  Sinks and stars live in a fixed number of
slots with an ``active`` mask; a step creates at most one sink, from the
densest alive gas particle above ``rho_sink``, in the first free slot.
Each alive gas particle within ``sink_radius`` times an active sink's h
belongs to the nearest such sink (the first slot of equal distances).
Plain accretion (``smooth_accretion = 0``) eats those particles whole,
conserving mass, momentum and the centre of mass; eaten gas dies (the
caller zeroes its mass and motion).  Smooth accretion
(``smooth_accretion = 1``) takes from each sink's claimed gas the mass
menc (1 - exp(-dt / taccrete)), shared by kernel weight, whole where the
rest would fall below a fraction of the mean mass or the orbit is fast,
and keeps the spin of what it took about the new centre of mass; a
particle dies only when nothing of it is left.

``sink_candidate`` (K17), ``accretion_sums`` (K18) and
``smooth_accretion_sums`` and ``apply_smooth_accretion`` (K20, two
launches) launch the kernels of ``csrc/sinks.cu`` on CUDA tensors and
run their plain PyTorch versions ``*_plain`` on CPU tensors, in 1-3
dims: positions and velocities (N, ndim) and (Ns, ndim), the spin
ledger (Ns, 3) at every ndim, as the JAX package's SinkState holds it;
``apply_sink_creation`` and ``apply_accretion`` are elementwise torch on
both, so a step reads nothing back to the host.  The plain versions
chunk the (N, Ns) pair arrays of the JAX form over gas rows; a gas
particle's claim is kept as its slot (-1 for none) rather than the JAX
package's (N, Ns) mask.
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
    the eaten mask (N,) of gas r, v (N, ndim): each alive gas particle
    within sink_radius h_s of an active sink goes to the nearest such
    sink (the first slot of equal distances).  No smoothing kernel enters.
    K18 on CUDA tensors."""
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
    with dist = sqrt((dx^2 + dy^2) + dz^2) written out (its first ndim
    terms below 3D), so that the masks do not depend on a reduction's
    order."""
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


# ---------------------------------------------------------------------------
# K20: smooth accretion
# ---------------------------------------------------------------------------

def smooth_claims(cfg: SinkConfig, sinks: SinkState, r: Tensor,
                  alive: Tensor):
    """Each alive gas particle's claim under smooth accretion: its nearest
    active slot within sink_radius h_s (the first of equal distances),
    -1 for none, and the distance to it (1 where none), dist =
    sqrt((dx^2 + dy^2) + dz^2) + 1e-30 as the JAX form takes it (its
    first ndim terms below 3D)."""
    N, ndim = r.shape
    racc = cfg.sink_radius * sinks.h
    step = max(1, _CHUNK_PAIRS // max(sinks.N, 1))
    slot, dist_out = [], []
    for c0 in range(0, N, step):
        rc = r[c0:c0 + step]
        d2 = None
        for k in range(ndim):
            dk = rc[:, None, k] - sinks.r[None, :, k]
            d2 = dk * dk if d2 is None else d2 + dk * dk
        dist = torch.sqrt(d2) + 1e-30
        inside = (dist < racc[None, :]) & sinks.active[None, :] \
            & alive[c0:c0 + step, None]
        best = torch.where(inside, dist, math.inf).min(dim=1)
        hit = inside.any(dim=1)
        slot.append(torch.where(hit, best.indices, -1))
        dist_out.append(torch.where(hit, best.values, 1.0))
    if not slot:
        empty = torch.zeros((0,), dtype=r.dtype, device=r.device)
        return empty.to(torch.int32), empty
    return torch.cat(slot).to(torch.int32), torch.cat(dist_out)


def smooth_accretion_sums(cfg: SinkConfig, sinks: SinkState, r: Tensor,
                          v: Tensor, m: Tensor, rho: Tensor, sound: Tensor,
                          alive: Tensor, dt: Tensor, kern, mmean: float,
                          alpha_ss: float = 0.01,
                          smooth_accrete_frac: float = 0.01,
                          smooth_accrete_dt: float = 0.01):
    """The mass each gas particle gives up this step (dm (N,)) and the
    per-slot sums: a dict with "claim" (N,) int32, the slot each
    particle belongs to (-1 for none), "menc", "macc" and "taccrete" (Ns,)
    and "dmdt" = macc / dt.  `dt` is a 0-d tensor on the gas's device (a
    block tick's dt_base).  W and the potential term's wpot are `kern`'s
    (normalised in its ndim).  K20's first launch on CUDA tensors, which
    take M4 and the quintic, direct or tabulated (the gaussian is refused:
    fault F23)."""
    if r.is_cuda:
        dm, claim, menc, macc, tacc = _ext.smooth_accretion_sums(
            r.contiguous(), v.contiguous(), m.contiguous(),
            rho.contiguous(), sound.contiguous(), alive.contiguous(),
            sinks.r.contiguous(), sinks.v.contiguous(),
            sinks.m.contiguous(), sinks.h.contiguous(),
            sinks.active.contiguous(), cfg.sink_radius, dt.contiguous(),
            mmean, alpha_ss, smooth_accrete_frac, smooth_accrete_dt,
            kern=kern)
        return dm, {"claim": claim, "menc": menc, "macc": macc,
                    "taccrete": tacc,
                    "dmdt": macc / torch.clamp_min(dt, 1e-30)}
    return smooth_accretion_sums_plain(
        cfg, sinks, r, v, m, rho, sound, alive, dt, kern, mmean, alpha_ss,
        smooth_accrete_frac, smooth_accrete_dt)


def smooth_accretion_sums_plain(cfg: SinkConfig, sinks: SinkState, r, v, m,
                                rho, sound, alive, dt, kern, mmean: float,
                                alpha_ss: float = 0.01,
                                smooth_accrete_frac: float = 0.01,
                                smooth_accrete_dt: float = 0.01):
    """Plain version of K20's first launch: the JAX formula
    (gandalf_tpu/ops/sinks.py:182-268) on each particle's one claim.  The
    enclosed mass menc, kernel norm wnorm, the rotational and
    gravitational energies (gpetot with sinks.m + menc / 2), the mean
    log viscous time and the radial-drift sum give taccrete, which
    interpolates the radial-drift and Shakura-Sunyaev times by the
    rotational energy fraction; macc = menc (1 - exp(-dt / taccrete)) is
    shared over the claimed gas by m W / rho, and a particle goes whole
    where the rest would fall below smooth_accrete_frac mmean or dt <
    smooth_accrete_dt times its sink's orbital time."""
    Ns, ndim = sinks.N, r.shape[1]
    claim, dist = smooth_claims(cfg, sinks, r, alive)
    hit = claim >= 0
    j = torch.clamp_min(claim, 0).long()
    racc = cfg.sink_radius * sinks.h
    invh = 1.0 / torch.clamp_min(sinks.h, 1e-30)
    zero = torch.zeros_like(m)

    def per_slot(x):
        return torch.zeros((Ns,), dtype=x.dtype, device=x.device) \
            .index_add_(0, j, torch.where(hit, x, zero))

    m_in = torch.where(hit, m, zero)
    menc = per_slot(m_in)
    ih = invh[j]
    w0 = kern.w0_s2((dist * ih) ** 2) * ih ** ndim
    w_rho = w0 / torch.clamp_min(rho, 1e-30)
    wnorm = per_slot(m_in * w_rho)
    drv = r - sinks.r[j]
    unit = drv / dist[:, None]
    dv = v - sinks.v[j]
    dvdr = torch.sum(dv * unit, dim=-1)
    dvtang2 = torch.sum(dv * dv, dim=-1) - dvdr * dvdr
    gpetot = per_slot(0.5 * m * (sinks.m + 0.5 * menc)[j] * ih
                      * kern.wpot(dist * ih))
    # the JAX form's kinetic-energy sum enters no timescale: not taken
    norm = 0.5 * menc / torch.clamp_min(wnorm, 1e-30)
    rotketot = norm * per_slot(m_in * dvtang2 * w_rho)
    log_tv = per_slot(m * torch.log(torch.clamp_min(
        torch.sqrt(dist) / torch.clamp_min(sound, 1e-30) ** 2, 1e-30)))
    tvisc = torch.sqrt(sinks.m + menc) \
        * torch.exp(log_tv / torch.clamp_min(menc, 1e-30)) / alpha_ss
    trad_sum = per_slot(torch.abs(4.0 * math.pi * dist * dist * m * dvdr
                                  * w0))
    trad = menc / torch.clamp_min(trad_sum, 1e-30)
    trot = 2.0 * math.pi * torch.sqrt(
        racc ** 3 / torch.clamp_min(menc + sinks.m, 1e-30))
    efrac = torch.clamp(2.0 * rotketot / torch.clamp_min(gpetot, 1e-30),
                        0.0, 1.0)
    taccrete = torch.clamp_min(trad, 1e-30) ** (1.0 - efrac) \
        * torch.clamp_min(tvisc, 1e-30) ** efrac
    macc = menc * torch.clamp_min(
        1.0 - torch.exp(-dt / torch.clamp_min(taccrete, 1e-30)), 0.0)
    wsum = torch.clamp_min(wnorm, 1e-30)
    dm = torch.minimum(torch.where(hit, (m_in * w_rho) / wsum[j] * macc[j],
                                   zero), m)
    full = ((m - dm < smooth_accrete_frac * mmean)
            | (dt < smooth_accrete_dt * trot[j])) & hit
    dm = torch.where(full, m, dm)
    return dm, {"claim": claim, "menc": menc, "macc": macc,
                "taccrete": taccrete,
                "dmdt": macc / torch.clamp_min(dt, 1e-30)}


def apply_smooth_accretion(sinks: SinkState, r: Tensor, v: Tensor,
                           m: Tensor, dm: Tensor, claim: Tensor,
                           alive: Tensor):
    """The sink update of smooth accretion: each slot gains the mass and
    momentum taken from its claimed gas (claim (N,) int32, -1 for none)
    and moves to the new centre of mass; its spin ledger adds the old
    centre of mass's and each taken parcel's angular momentum about the
    new one.  Returns (sinks, m - dm, alive & (m - dm > 0)).  No
    smoothing kernel enters.  K20's second launch on CUDA tensors."""
    if r.is_cuda:
        out = _ext.smooth_accretion_apply(
            r.contiguous(), v.contiguous(), m.contiguous(), dm.contiguous(),
            claim.contiguous(), alive.contiguous(), sinks.r.contiguous(),
            sinks.v.contiguous(), sinks.r0.contiguous(),
            sinks.v0.contiguous(), sinks.m.contiguous(),
            sinks.angmom.contiguous(), sinks.active.contiguous())
        rs, vs, r0, v0, ms, angmom, m_gas, alive_new = out
        return (sinks.replace(r=rs, v=vs, r0=r0, v0=v0, m=ms,
                              angmom=angmom), m_gas, alive_new)
    return apply_smooth_accretion_plain(sinks, r, v, m, dm, claim, alive)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """The spin a x b (..., 3) of separations and velocities (..., ndim)
    as the JAX package's apply_smooth_accretion takes it
    (gandalf_tpu/ops/sinks.py:288-292): the cross product in 3D, (0, 0,
    a0 b1 - a1 b0) in 2D; in 1D its a[..., 1] is out of bounds and JAX
    clamps a static index to the last one, so z = a0 b0 - a0 b0, exactly
    0: the ledger stays zero."""
    nd = a.shape[-1]
    if nd == 3:
        return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                           -1)
    z = torch.zeros_like(a[..., 0])
    if nd == 2:
        return torch.stack([z, z, a[..., 0] * b[..., 1]
                            - a[..., 1] * b[..., 0]], -1)
    return torch.stack([z, z, z], -1)


def apply_smooth_accretion_plain(sinks: SinkState, r, v, m, dm, claim,
                                 alive):
    """Plain version of K20's second launch: the JAX formula
    (gandalf_tpu/ops/sinks.py:271-310) in 1-3 dims on each particle's one
    claim, with r - r_new and v - v_new taken directly; the spin by
    _cross."""
    hit = claim >= 0
    j = torch.clamp_min(claim, 0).long()
    w = torch.where(hit, dm, torch.zeros_like(dm))

    def per_slot(x):
        out = torch.zeros((sinks.N,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, j, x)

    dmtot = per_slot(w)
    m_new = sinks.m + dmtot
    msafe = torch.clamp_min(m_new, 1e-300)[:, None]
    r_new = (sinks.m[:, None] * sinks.r + per_slot(w[:, None] * r)) / msafe
    v_new = (sinks.m[:, None] * sinks.v + per_slot(w[:, None] * v)) / msafe
    dl_old = sinks.m[:, None] * _cross(sinks.r - r_new, sinks.v - v_new)
    dl_gas = per_slot(w[:, None] * _cross(r - r_new[j], v - v_new[j]))
    upd = sinks.active & (dmtot > 0)
    col = upd[:, None]
    new = sinks.replace(
        r=torch.where(col, r_new, sinks.r),
        v=torch.where(col, v_new, sinks.v),
        r0=torch.where(col, r_new, sinks.r0),
        v0=torch.where(col, v_new, sinks.v0),
        m=torch.where(upd, m_new, sinks.m),
        angmom=sinks.angmom + torch.where(col, dl_old + dl_gas, 0.0))
    m_gas = m - dm
    return new, m_gas, alive & (m_gas > 0.0)
