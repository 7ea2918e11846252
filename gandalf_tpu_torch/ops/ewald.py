"""Ewald summation for periodic and mixed-periodic self-gravity.

Counterpart of ``gandalf_tpu/ops/ewald.py`` (the reference's Ewald
class, src/Common/Ewald.cpp).  The host builds a table of the
periodic-minus-Newtonian correction field once, in float64 with numpy
and scipy, on a grid over the positive octant (``build_ewald_table``: a
copy of the JAX package's builder for fully periodic boxes, slabs with
one open axis and cylinders with two).  The tree walk adds a trilinearly
interpolated correction to every accepted cell and near pair
(``ewald_correction``; in K6 and K7 the same lookup is
``csrc/ewald.cuh``), and beyond the table along an open axis the
analytic sheet or line far field.

The table convention is the tree walk's pair convention: for dr = r_j -
r_i the pair adds a_i += m_j (dr/|dr|^3 + acorr) and gpot_i += m_j
(1/|dr| + potcorr).  On the device the table is one tensor of shape
(nx, ny, nz, 4), (pot, ax, ay, az) per node, so that each corner of a
lookup is one 16-byte load in float32.  ``ewald_pair_gravity`` is the
dense pair sum of the corrections, an oracle for the tests only.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
from scipy.special import erfc, erfcx, exp1

Tensor = torch.Tensor

_EULER_GAMMA = 0.5772156649015328606
# the period of an open axis in the walk's min-image (gandalf_tpu's
# _ext_safe): large enough that rounding dr / period never leaves 0
OPEN_PERIOD = 1e30
# number of float64 values of EwaldTable.meta()
META_LEN = 22


@dataclasses.dataclass(frozen=True, eq=False)
class EwaldTable:
    """The correction table (float64 numpy) and its static metadata, the
    fields of gandalf_tpu's EwaldTable."""

    pot: np.ndarray         # (nx, ny, nz) correction potential
    acc: np.ndarray         # (nx, ny, nz, 3) correction acceleration
    inv_dgrid: np.ndarray   # (3,) inverse grid spacing
    nmax: np.ndarray        # (3,) int32, last valid cell index (n - 2)
    far_kind: int = 7       # 7 fully periodic, 2 slab, 1 cylinder
    open_axes: tuple = ()
    per_axes: tuple = (0, 1, 2)
    L_per: float = 0.0      # cylinder: the periodic length
    area: float = 0.0       # slab: the periodic cell area
    pot_const: float = 0.0  # cylinder: the far potential's constant
    far_thresh: tuple = None  # per axis |dr| beyond which the far field

    def tensor(self, device, dtype) -> Tensor:
        """The interleaved (nx, ny, nz, 4) table on `device` in `dtype`
        (cached per device and dtype)."""
        cache = self.__dict__.setdefault("_tensors", {})
        key = (str(torch.device(device)), dtype)
        if key not in cache:
            tab = np.concatenate([self.pot[..., None], self.acc], -1)
            cache[key] = torch.tensor(tab, dtype=dtype,
                                      device=device).contiguous()
        return cache[key]

    def meta(self, extent) -> np.ndarray:
        """The float64 values K6 and K7 take: inv_dgrid (3), nmax (3),
        the min-image period per axis (3; `extent` per dim, 0 = open,
        which becomes OPEN_PERIOD), far_thresh (3; 1e300 where none),
        far_kind, the open axes (2, -1 padded), the first periodic axis,
        L_per, area, pot_const and the table's shape (3)."""
        thresh = [1e300 if t is None or not math.isfinite(t) else float(t)
                  for t in (self.far_thresh or (None,) * 3)]
        opn = list(self.open_axes) + [-1] * (2 - len(self.open_axes))
        return np.array(
            [*self.inv_dgrid, *self.nmax, *period_of(extent), *thresh,
             self.far_kind, *opn, self.per_axes[0], self.L_per, self.area,
             self.pot_const, *self.pot.shape], dtype=np.float64)


def period_of(extent) -> Tuple[float, float, float]:
    """The walk's min-image period per axis: the box length along a
    periodic axis, OPEN_PERIOD along an open one (gandalf_tpu's
    _ext_safe)."""
    return tuple(float(e) if float(e) > 0 else OPEN_PERIOD for e in extent)


def min_image(dr: Tensor, period) -> Tensor:
    """dr - period * round(dr / period) per component of (..., 3), with
    round-half-to-even as jnp.round."""
    cols = [dr[..., k] - period[k] * torch.round(dr[..., k] / period[k])
            for k in range(3)]
    return torch.stack(cols, -1)


# ---------------------------------------------------------------------------
# Host table builder (a copy of gandalf_tpu/ops/ewald.py:79-328)
# ---------------------------------------------------------------------------

def _octant_grid(L: np.ndarray, per, ngrid: int):
    """Per-axis octant sample points: periodic axes span [0, L/2] with
    ngrid points; open axes span [0, 2 L_ref] with 4 (ngrid-2) + 1
    points."""
    paxes = [k for k in range(3) if per[k]]
    L_ref = L[paxes[0]]
    pts = []
    for k in range(3):
        if per[k]:
            pts.append(np.linspace(0.0, 0.5 * L[k], ngrid))
        else:
            pts.append(np.linspace(0.0, 2.0 * L_ref, 4 * (ngrid - 2) + 1))
    return pts, L_ref


def _image_lattice(L: np.ndarray, per, L_ref: float, nseries: int):
    """Integer image offsets over the periodic dims inside the elliptic
    cut (Ewald.cpp:310)."""
    rngs = []
    for k in range(3):
        if per[k]:
            nk = int(np.ceil(nseries * L_ref / L[k])) + 1
            rngs.append(np.arange(-nk, nk + 1))
        else:
            rngs.append(np.array([0]))
    NX, NY, NZ = np.meshgrid(*rngs, indexing="ij")
    nvec = np.stack([NX, NY, NZ], axis=-1).reshape(-1, 3)
    w = (nvec * (L / L_ref)[None, :]) ** 2
    return nvec[np.sum(w, axis=1) <= nseries * nseries + 1e-12]


def _realspace_sum(r: np.ndarray, nvec: np.ndarray, L: np.ndarray,
                   alpha: float):
    """erfc-damped short-range image sum (Ewald.cpp:306-326)."""
    pot = np.zeros(len(r))
    acc = np.zeros((len(r), 3))
    for n in nvec:
        rn = r + n * L
        d2 = np.sum(rn * rn, axis=1)
        d2s = np.where(d2 > 0, d2, 1.0)
        d = np.sqrt(d2s)
        e = erfc(alpha * d)
        g = e / d
        s = (e + (2.0 * alpha / np.sqrt(np.pi)) * d
             * np.exp(-alpha * alpha * d2)) / (d * d2s)
        pot += np.where(d2 > 0, g, 0.0)
        acc += np.where(d2[:, None] > 0, rn * s[:, None], 0.0)
    return pot, acc


def _subtract_direct(r: np.ndarray, pot: np.ndarray, acc: np.ndarray):
    d2 = np.sum(r * r, axis=1)
    d2s = np.where(d2 > 0, d2, 1.0)
    d = np.sqrt(d2s)
    pot -= np.where(d2 > 0, 1.0 / d, 0.0)
    acc -= np.where(d2[:, None] > 0, r / (d * d2s)[:, None], 0.0)
    pot[0] = 0.0
    acc[0] = 0.0
    return pot, acc


def build_ewald_table(lbox, ngrid: int = 17, nseries: int = 5,
                      ewald_mult: float = 1.0,
                      periodic=(True, True, True)) -> EwaldTable:
    """Precompute the periodic correction field on an octant grid (host
    numpy, float64).  `periodic` selects the mixed-periodicity case (at
    least one axis periodic)."""
    per = tuple(bool(p) for p in periodic)
    L = np.array([float(lbox[k]) for k in range(3)])
    npd = sum(per)
    if npd == 0:
        raise ValueError("Ewald table needs >= 1 periodic axis")
    if npd == 3:
        return _build_table_3p(L, ngrid, nseries, ewald_mult)

    paxes = tuple(k for k in range(3) if per[k])
    oaxes = tuple(k for k in range(3) if not per[k])
    pts, L_ref = _octant_grid(L, per, ngrid)
    alpha = 2.0 * ewald_mult / L_ref
    X, Y, Z = np.meshgrid(*pts, indexing="ij")
    r = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)

    nvec = _image_lattice(L, per, L_ref, nseries)
    pot, acc = _realspace_sum(r, nvec, L, alpha)

    if npd == 2:
        _recip_2p(r, L, alpha, nseries, paxes, oaxes[0], pot, acc)
    else:
        _recip_1p(r, L, alpha, nseries, paxes[0], oaxes, pot, acc)
    pot_const = 0.0      # both far fields are in canonical conventions

    pot, acc = _subtract_direct(r, pot, acc)

    shape = tuple(len(p) for p in pts)
    extents = np.array([p[-1] for p in pts])
    inv_dgrid = (np.array(shape) - 1) / extents
    # the analytic far field from the last valid cell of each open axis;
    # periodic axes are min-imaged into range
    far_thresh = tuple(
        (shape[k] - 2) / inv_dgrid[k] if k in oaxes else np.inf
        for k in range(3))
    return EwaldTable(
        pot=pot.reshape(shape), acc=acc.reshape(shape + (3,)),
        inv_dgrid=inv_dgrid,
        nmax=np.array([n - 2 for n in shape], np.int32),
        far_kind=npd, open_axes=oaxes, per_axes=paxes,
        L_per=float(L[paxes[0]]), area=float(np.prod(L[list(paxes)])),
        pot_const=float(pot_const), far_thresh=far_thresh)


def _build_table_3p(L, ngrid, nseries, ewald_mult) -> EwaldTable:
    """Fully periodic table (ewald_periodicity == 7)."""
    lx, ly, lz = L
    V = lx * ly * lz
    alpha = 2.0 * ewald_mult / lx

    pts = [np.linspace(0.0, 0.5 * L[k], ngrid) for k in range(3)]
    X, Y, Z = np.meshgrid(*pts, indexing="ij")
    r = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)

    rng = np.arange(-nseries, nseries + 1)
    NX, NY, NZ = np.meshgrid(rng, rng, rng, indexing="ij")
    nvec = np.stack([NX, NY, NZ], axis=-1).reshape(-1, 3)
    nvec = nvec[np.sum(nvec * nvec, axis=1) <= nseries * nseries]

    pot, acc = _realspace_sum(r, nvec, L, alpha)

    # reciprocal-space sum
    hvec = nvec[np.any(nvec != 0, axis=1)]
    kt = hvec / L[None, :]                               # (H, 3) k/2pi
    kt2 = np.sum(kt * kt, axis=1)
    damp = np.exp(-np.pi * np.pi * kt2 / (alpha * alpha)) / kt2
    phase = 2.0 * np.pi * (r @ kt.T)                     # (G, H)
    pot += (np.cos(phase) @ damp) / (np.pi * V)
    acc += (np.sin(phase) @ (damp[:, None] * kt)) * (2.0 / V)

    # k = 0 neutralising background
    pot -= np.pi / (alpha * alpha * V)
    pot, acc = _subtract_direct(r, pot, acc)

    shape = (ngrid, ngrid, ngrid)
    inv_dgrid = (ngrid - 1) / (0.5 * L)
    return EwaldTable(pot=pot.reshape(shape), acc=acc.reshape(shape + (3,)),
                      inv_dgrid=inv_dgrid,
                      nmax=np.array([ngrid - 2] * 3, np.int32))


def _recip_2p(r, L, alpha, nseries, paxes, oax, pot, acc):
    """2D-periodic reciprocal sum, closed erfc form (Ewald.cpp:786-900)."""
    p1, p2 = paxes
    A = L[p1] * L[p2]
    z = r[:, oax]
    x1, x2 = r[:, p1], r[:, p2]

    # h = 0 slab term
    pot += -(2.0 * np.pi / A) * (z * erf_np(alpha * z)
                                 + np.exp(-alpha * alpha * z * z)
                                 / (alpha * np.sqrt(np.pi)))
    acc[:, oax] += (2.0 * np.pi / A) * erf_np(alpha * z)

    n1 = int(np.ceil(nseries * L[p1] / L[p1]))  # = nseries
    n2 = int(np.ceil(nseries * L[p1] / L[p2]))
    for h1 in range(-n1, n1 + 1):
        for h2 in range(-n2, n2 + 1):
            if h1 == 0 and h2 == 0:
                continue
            kt2 = (h1 / L[p1]) ** 2 + (h2 / L[p2]) ** 2
            if kt2 * L[p1] ** 2 > nseries * nseries:
                continue
            k = 2.0 * np.pi * np.sqrt(kt2)
            s = alpha * z + k / (2.0 * alpha)
            # e^{kz} erfc(az + k/2a) = erfcx(s) e^{-a^2 z^2 - k^2/4a^2}
            t1 = erfcx(s) * np.exp(-alpha * alpha * z * z
                                   - k * k / (4.0 * alpha * alpha))
            t2 = np.exp(-k * z) * erfc(k / (2.0 * alpha) - alpha * z)
            phase = 2.0 * np.pi * (h1 * x1 / L[p1] + h2 * x2 / L[p2])
            B = t1 + t2
            pot += (np.pi / A) * np.cos(phase) / k * B
            acc[:, oax] += -(np.pi / A) * np.cos(phase) * (t1 - t2)
            for (pk, hk) in ((p1, h1), (p2, h2)):
                acc[:, pk] += (np.pi / A) * np.sin(phase) \
                    * (2.0 * np.pi * hk / L[pk]) / k * B


def _recip_1p(r, L, alpha, nseries, pax, oaxes, pot, acc):
    """1D-periodic reciprocal sum: renormalised h = 0 log term + Simpson
    quadrature of the h != 0 Bessel-type integrals (Ewald.cpp:690-760)."""
    Lp = L[pax]
    x = r[:, pax]
    q1, q2 = r[:, oaxes[0]], r[:, oaxes[1]]
    rho2 = q1 * q1 + q2 * q2
    arho2 = alpha * alpha * rho2

    # h = 0 term in the canonical line-potential convention
    pos = arho2 > 1e-300
    psi0 = np.full_like(rho2, (_EULER_GAMMA + 2.0 * np.log(alpha)) / Lp)
    psi0[pos] = -(np.log(rho2[pos]) + exp1(arho2[pos])) / Lp
    pot += psi0
    fac0 = np.zeros_like(rho2)
    fac0[pos] = 2.0 * (1.0 - np.exp(-arho2[pos])) / (Lp * rho2[pos])
    acc[:, oaxes[0]] += fac0 * q1
    acc[:, oaxes[1]] += fac0 * q2

    # h != 0: Simpson quadrature over t in (0, alpha]
    n_quad = 1001
    u = np.linspace(0.0, 1.0, n_quad)[1:]                # drop u = 0
    w = np.full(n_quad - 1, 2.0)
    w[::2] = 4.0                                          # Simpson weights
    w[-1] = 1.0
    du = u[1] - u[0]
    t = alpha * u                                         # (T,)
    for h in range(1, max(nseries, 2) + 3):
        bh = (np.pi * h / (Lp * t)) ** 2                  # (T,)
        damp = np.exp(-bh)
        if damp.max() < 1e-14:
            break
        Ih = np.zeros(len(r))
        Jh = np.zeros(len(r))
        chunk = 65536
        for i0 in range(0, len(r), chunk):
            sl = slice(i0, i0 + chunk)
            e = np.exp(-rho2[sl, None] * (t * t)[None, :]) * damp[None, :]
            Ih[sl] = (e / t[None, :] * w[None, :]).sum(1) * du * alpha / 3.0
            Jh[sl] = (e * t[None, :] * w[None, :]).sum(1) * du * alpha / 3.0
        ph = 2.0 * np.pi * h * x / Lp
        pot += (4.0 / Lp) * np.cos(ph) * Ih
        acc[:, pax] += (4.0 / Lp) * np.sin(ph) \
            * (2.0 * np.pi * h / Lp) * Ih
        acc[:, oaxes[0]] += (8.0 / Lp) * np.cos(ph) * Jh * q1
        acc[:, oaxes[1]] += (8.0 / Lp) * np.cos(ph) * Jh * q2


def erf_np(x):
    return 1.0 - erfc(x)


# ---------------------------------------------------------------------------
# The lookup (plain version of csrc/ewald.cuh)
# ---------------------------------------------------------------------------

def _trilinear(table: EwaldTable, dr: Tensor):
    """Octant trilinear lookup with per-coordinate odd/even symmetry
    (gandalf_tpu's _trilinear, operation for operation)."""
    tab = table.tensor(dr.device, dr.dtype)
    nx, ny, nz = tab.shape[:3]
    flat = tab.reshape(-1, 4)
    sign = torch.sign(dr)
    inv = torch.tensor(table.inv_dgrid, dtype=dr.dtype, device=dr.device)
    nmax = torch.tensor(table.nmax.astype(np.int64), device=dr.device)
    b = torch.abs(dr) * inv
    # clip in floating point first: the cast of a huge b is undefined
    i0 = torch.minimum(torch.clamp(b, max=2.0 ** 30).to(torch.int64), nmax)
    w = b - i0.to(b.dtype)
    pot = torch.zeros(dr.shape[:-1], dtype=dr.dtype, device=dr.device)
    acc = torch.zeros_like(dr)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                wt = ((w[..., 0] if cx else 1.0 - w[..., 0])
                      * (w[..., 1] if cy else 1.0 - w[..., 1])
                      * (w[..., 2] if cz else 1.0 - w[..., 2]))
                node = flat[((i0[..., 0] + cx) * ny + i0[..., 1] + cy) * nz
                            + i0[..., 2] + cz]
                pot = pot + wt * node[..., 0]
                acc = acc + wt[..., None] * node[..., 1:]
    return acc * sign, pot


def ewald_correction(table: EwaldTable, dr: Tensor):
    """(acc_corr (..., 3), pot_corr (...)) at minimum-image pair vectors
    dr (..., 3) (CalculatePeriodicCorrection, Ewald.cpp:496-620): the
    table's lookup, and in a slab or cylinder the analytic sheet or line
    far field beyond the table along an open axis."""
    acc_t, pot_t = _trilinear(table, dr)
    if table.far_kind == 7:
        return acc_t, pot_t
    d2 = (dr * dr).sum(-1)
    dinv = 1.0 / torch.sqrt(torch.clamp_min(d2, 1e-300))
    dinv3 = dinv * dinv * dinv
    acc_f = -dr * dinv3[..., None]
    if table.far_kind == 2:
        # uniform-sheet far field
        o = table.open_axes[0]
        ap = 2.0 * np.pi / table.area
        zo = dr[..., o]
        pot_f = -(torch.abs(zo) * ap + dinv)
        acc_f[..., o] = acc_f[..., o] + ap * torch.sign(zo)
        out = torch.abs(zo) > table.far_thresh[o]
    else:
        # line-mass far field
        q1, q2 = table.open_axes
        c = dr[..., q1] ** 2 + dr[..., q2] ** 2
        cs = torch.clamp_min(c, 1e-300)
        Lp = table.L_per
        pot_f = -(torch.log(cs) / Lp + table.pot_const + dinv)
        d_fac = 2.0 / (Lp * cs)
        acc_f[..., q1] = acc_f[..., q1] + dr[..., q1] * d_fac
        acc_f[..., q2] = acc_f[..., q2] + dr[..., q2] * d_fac
        out = ((torch.abs(dr[..., q1]) > table.far_thresh[q1])
               | (torch.abs(dr[..., q2]) > table.far_thresh[q2]))
    return (torch.where(out[..., None], acc_f, acc_t),
            torch.where(out, pot_f, pot_t))


def ewald_pair_gravity(table: EwaldTable, box, r: Tensor, m: Tensor):
    """Dense pair sum of the periodic corrections: a_i += sum_j m_j
    acorr(dr_ij), gpot_i += sum_j m_j potcorr(dr_ij), over min-image
    pairs (gandalf_tpu's ewald_pair_gravity; an O(N^2) oracle)."""
    dr = box.min_image(r[None, :, :] - r[:, None, :])
    acorr, potcorr = ewald_correction(table, dr)
    eye = torch.eye(r.shape[0], dtype=torch.bool, device=r.device)
    mj = torch.where(eye, 0.0, m[None, :])
    a = (mj[..., None] * acorr).sum(1)
    gpot = (mj * potcorr).sum(1)
    return a, gpot


def table_from_params(params, box) -> EwaldTable:
    """The controllers' table (gandalf_tpu/sim/simulation.py:914-921):
    ngrid = max(nEwaldGrid, 9), the default nseries, the box's
    periodicity.  Tables are immutable, so simulations of one box share
    one (built once per process)."""
    pdims = box.periodic_dims()
    return _cached_table(tuple(float(x) for x in box.size),
                         max(params.intparams["nEwaldGrid"], 9),
                         float(params.floatparams["ewald_mult"]),
                         tuple(k in pdims for k in range(3)))


@functools.lru_cache(maxsize=8)
def _cached_table(size, ngrid, ewald_mult, periodic) -> EwaldTable:
    return build_ewald_table(size, ngrid=ngrid, ewald_mult=ewald_mult,
                             periodic=periodic)


def table_fields(table: EwaldTable) -> Dict[str, object]:
    """The table's fields by name (for comparisons with gandalf_tpu's)."""
    return {f.name: getattr(table, f.name)
            for f in dataclasses.fields(EwaldTable)}
