"""Direct-summation gravity of the N-body path, and the external
analytic potentials.

Counterpart of ``gandalf_tpu/ops/gravity.py``.  Three functions sum over
all pairs of stars (G = 1, the reference's Nbody::CalculateDirectGravForces,
src/Nbody/Nbody.cpp:233-280):

- ``direct_nbody`` (K13): unsoftened acceleration, jerk and potential;
- ``direct_softened`` (K14): the mean-h kernel-softened acceleration
  and potential (M4 or the quintic, direct or tabulated; not the
  gaussian, fault F23), with the jerk optional and Newtonian (ROADMAP
  fault F9);
- ``direct_snap`` (K15): the snap from the current accelerations, the
  second force pass of Hermite6TS.

Each dispatches on its tensors' device: a CUDA tensor launches the
kernel of ``csrc/nbody_direct.cu`` (or the call raises), a CPU tensor
runs the plain PyTorch version ``*_plain`` beside it.  The plain versions
do the JAX package's arithmetic with the same masks (self pairs by
identity, coincident pairs by d^2 = 0, no distance floor: collapsed
sub-system members share one position), over chunks of target rows so
that the (rows, N, ndim) temporaries stay near 2^22 pairs: the JAX form
builds (N, N, ndim) arrays.  d^2 is summed in axis order with one
rounding a term (``ops.mfv._dist2``), as K14 sums it for every kernel
but the direct M4: on the card torch.sum pairs the terms otherwise, which
would move a float32 pair across a table point.

``external_potential`` is elementwise torch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _ext
from .mfv import _dist2

Tensor = torch.Tensor

# pairs per chunk of target rows in the plain versions
_CHUNK_PAIRS = 1 << 22


class GravityResult(NamedTuple):
    a: Tensor        # (N, ndim) gravitational acceleration
    adot: Tensor     # (N, ndim) jerk (zero when not requested)
    gpot: Tensor     # (N,) potential magnitude (positive, as the reference)


def _chunks(N: int):
    step = max(1, _CHUNK_PAIRS // max(N, 1))
    for c0 in range(0, N, step):
        yield c0, min(N, c0 + step)


def _pair_geometry(r: Tensor, c0: int, c1: int):
    """dr[i, j] = r_j - r_i for the target rows c0:c1, |dr|^2 and the
    mask of self and coincident pairs."""
    dr = r[None, :, :] - r[c0:c1, None, :]
    drsqd = _dist2(dr)
    rows = torch.arange(c0, c1, device=r.device)
    cols = torch.arange(r.shape[0], device=r.device)
    eye = (rows[:, None] == cols[None, :]) | (drsqd == 0.0)
    return dr, drsqd, eye


def _newton_jerk(dr, dv, inv_dr, inv_dr3, m):
    """sum_j m_j [dv/|dr|^3 - 3 (dr.dv) dr / |dr|^5] over axis 1."""
    drdv = torch.sum(dr * dv, dim=-1)
    return torch.sum(
        (m[None, :] * inv_dr3)[..., None]
        * (dv - (3.0 * drdv * inv_dr * inv_dr)[..., None] * dr), dim=1)


def direct_nbody_plain(r: Tensor, v: Tensor, m: Tensor,
                       compute_jerk: bool = True) -> GravityResult:
    """Unsoftened direct-sum gravity and jerk over all pairs:

    a_i    = sum_j m_j dr / |dr|^3
    adot_i = sum_j m_j [dv/|dr|^3 - 3 (dr.dv) dr / |dr|^5]
    gpot_i = sum_j m_j / |dr|
    """
    a, adot, gpot = [], [], []
    for c0, c1 in _chunks(r.shape[0]):
        dr, drsqd, eye = _pair_geometry(r, c0, c1)
        inv_dr = torch.where(
            eye, 0.0, 1.0 / torch.sqrt(torch.where(eye, 1.0, drsqd)))
        inv_dr3 = inv_dr * inv_dr * inv_dr
        a.append(torch.sum((m[None, :] * inv_dr3)[..., None] * dr, dim=1))
        gpot.append(torch.sum(m[None, :] * inv_dr, dim=1))
        if compute_jerk:
            dv = v[None, :, :] - v[c0:c1, None, :]
            adot.append(_newton_jerk(dr, dv, inv_dr, inv_dr3, m))
    a = torch.cat(a) if a else torch.zeros_like(r)
    gpot = torch.cat(gpot) if gpot else torch.zeros_like(m)
    adot = torch.cat(adot) if adot else torch.zeros_like(a)
    return GravityResult(a=a, adot=adot, gpot=gpot)


def direct_snap_plain(r: Tensor, v: Tensor, a: Tensor,
                      m: Tensor) -> Tensor:
    """Direct-sum snap from the current accelerations (Nitadori & Makino
    2008; NbodyHermite6TS's second force pass): with alpha = (dr.dv)/r^2,
    beta = (|dv|^2 + dr.da)/r^2 + alpha^2 and jterm = dv/r^3 - 3 alpha
    dr/r^3, snap_i = sum_j m_j [da/r^3 - 6 alpha jterm - 3 beta dr/r^3]."""
    out = []
    for c0, c1 in _chunks(r.shape[0]):
        dr, drsqd, eye = _pair_geometry(r, c0, c1)
        dv = v[None, :, :] - v[c0:c1, None, :]
        da = a[None, :, :] - a[c0:c1, None, :]
        inv_r2 = torch.where(eye, 0.0, 1.0 / torch.where(eye, 1.0, drsqd))
        inv_r = torch.sqrt(inv_r2)
        inv_r3 = inv_r2 * inv_r
        alpha = torch.sum(dr * dv, dim=-1) * inv_r2
        beta = (torch.sum(dv * dv, dim=-1) + torch.sum(dr * da, dim=-1)) \
            * inv_r2 + alpha * alpha
        jterm = dv * inv_r3[..., None] \
            - (3.0 * alpha * inv_r3)[..., None] * dr
        snap = da * inv_r3[..., None] - (6.0 * alpha)[..., None] * jterm \
            - (3.0 * beta * inv_r3)[..., None] * dr
        out.append(torch.sum(m[None, :, None] * snap, dim=1))
    return torch.cat(out) if out else torch.zeros_like(r)


def direct_softened_plain(r: Tensor, v: Tensor, m: Tensor, h: Tensor,
                          kern, compute_jerk: bool = False
                          ) -> GravityResult:
    """Kernel-softened direct gravity with mean-h softening (the
    reference's grav_kernel = "mean_h"):

    a_i = sum_j m_j wgrav(s)/hbar^2 dr_hat,  s = |dr|/hbar,
    hbar = (h_i + h_j)/2; the potential sums m_j wpot(s)/hbar.  The jerk,
    when asked for, is the Newtonian one, also inside the kernel (F9)."""
    a, adot, gpot = [], [], []
    for c0, c1 in _chunks(r.shape[0]):
        dr, drsqd, eye = _pair_geometry(r, c0, c1)
        drmag = torch.sqrt(torch.where(eye, 1.0, drsqd))
        inv_drmag = torch.where(eye, 0.0, 1.0 / drmag)
        hbar = 0.5 * (h[c0:c1, None] + h[None, :])
        invh = 1.0 / hbar
        s = drmag * invh
        wg = kern.wgrav(s) * invh * invh
        unit = dr * inv_drmag[..., None]
        a.append(torch.sum((m[None, :] * wg * torch.where(eye, 0.0, 1.0))
                           [..., None] * unit, dim=1))
        gpot.append(torch.sum(torch.where(
            eye, 0.0, m[None, :] * kern.wpot(s) * invh), dim=1))
        if compute_jerk:
            dv = v[None, :, :] - v[c0:c1, None, :]
            adot.append(_newton_jerk(dr, dv, inv_drmag, inv_drmag ** 3, m))
    a = torch.cat(a) if a else torch.zeros_like(r)
    gpot = torch.cat(gpot) if gpot else torch.zeros_like(m)
    adot = torch.cat(adot) if adot else torch.zeros_like(a)
    return GravityResult(a=a, adot=adot, gpot=gpot)


def direct_nbody(r: Tensor, v: Tensor, m: Tensor,
                 compute_jerk: bool = True) -> GravityResult:
    """K13 on CUDA tensors, the plain version on CPU tensors."""
    if r.is_cuda:
        return GravityResult(*_ext.direct_nbody(
            r.contiguous(), v.contiguous(), m.contiguous(), compute_jerk))
    return direct_nbody_plain(r, v, m, compute_jerk)


def direct_softened(r: Tensor, v: Tensor, m: Tensor, h: Tensor, kern,
                    compute_jerk: bool = False) -> GravityResult:
    """K14 on CUDA tensors (the softening kernel `kern`, M4 or the
    quintic, direct or tabulated), the plain version on CPU tensors."""
    if r.is_cuda:
        return GravityResult(*_ext.direct_softened(
            r.contiguous(), v.contiguous(), m.contiguous(), h.contiguous(),
            compute_jerk, kern=kern))
    return direct_softened_plain(r, v, m, h, kern, compute_jerk)


def direct_snap(r: Tensor, v: Tensor, a: Tensor, m: Tensor) -> Tensor:
    """K15 on CUDA tensors, the plain version on CPU tensors."""
    if r.is_cuda:
        return _ext.direct_snap(r.contiguous(), v.contiguous(),
                                a.contiguous(), m.contiguous())
    return direct_snap_plain(r, v, a, m)


EXTERNAL_POTENTIALS = ("none", "silcc", "plummer", "vertical")


def external_potential(name: str, cfg: dict, r: Tensor, v: Tensor):
    """External analytic potentials: (accel, jerk, potential) as the
    reference's AddExternalPotential adds them (ExternalPotential.h:45-173,
    wired at Simulation.cpp:1163-1181 with mplummer, rplummer, avert).
    `cfg` holds the scalars mplummer, rplummer, kgrav, avert, rzero."""
    z = torch.zeros_like(r)
    zp = torch.zeros(r.shape[:-1], dtype=r.dtype, device=r.device)
    if name in ("none", "silcc"):
        # the reference's SilccPotential::AddExternalPotential is empty
        return z, z, zp
    if name == "plummer":
        mpl, rpl = cfg["mplummer"], cfg["rplummer"]
        rsqd = torch.sum(r * r, dim=-1, keepdim=True)
        dvdr = torch.sum(r * v, dim=-1, keepdim=True)
        denom = rsqd + rpl * rpl
        a = -mpl * r * denom ** -1.5
        adot = 3.0 * mpl * denom ** -2.5 * dvdr * r \
            - mpl * denom ** -1.5 * v
        pot = 2.0 * mpl * denom[..., 0] ** -0.5
        return a, adot, pot
    if name == "vertical":
        k, avert, rzero = cfg["kgrav"], cfg["avert"], cfg["rzero"]
        a = z.clone()
        a[..., k] = avert
        pot = (r[..., k] - rzero) * avert
        return a, z, pot
    raise ValueError(f"Unrecognised external_potential: {name!r}")
