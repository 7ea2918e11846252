"""Particle state as a dataclass of torch tensors, and the simulation box.

Counterpart of ``gandalf_tpu/state.py``: ``SphState`` carries the same
fields (one tensor per field, structure of arrays), ``make_sph_state``
builds the initial state, ``MfvState`` and ``make_mfv_state`` do the same
for the meshless finite-volume path, ``NbodyState`` and
``make_nbody_state`` for the N-body stars, and ``DomainBox`` holds the boundary
description with the same ``periodic_dims``, ``mirror_walls``,
``min_image``, ``wrap`` and ``reflect``.  Every tensor lives on the
``device`` and in the float ``dtype`` the caller names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# particle types (the reference's Particle.h:43; same codes as gandalf_tpu)
GAS_TYPE = 0
ICM_TYPE = 1
CDM_TYPE = 2
DUST_TYPE = 3
BOUNDARY_TYPE = 4

# status flag bits (same layout as gandalf_tpu.state)
FLAG_DEAD = 1 << 0

Tensor = torch.Tensor


@dataclasses.dataclass
class SphState:
    """Structure-of-arrays grad-h SPH particle state plus global scalars."""

    # kinematics: shape (N, ndim)
    r: Tensor
    v: Tensor
    a: Tensor
    r0: Tensor
    v0: Tensor
    a0: Tensor
    # scalars per particle: shape (N,)
    m: Tensor
    h: Tensor
    rho: Tensor
    u: Tensor
    u0: Tensor
    dudt: Tensor
    dudt0: Tensor
    pressure: Tensor
    sound: Tensor
    invomega: Tensor
    zeta: Tensor
    hfactor: Tensor
    div_v: Tensor
    alpha: Tensor
    gpot: Tensor
    dt_part: Tensor
    ueq: Tensor
    dt_therm: Tensor
    ionfrac: Tensor
    # integer bookkeeping: shape (N,)
    ptype: Tensor
    flags: Tensor
    level: Tensor
    levelneib: Tensor
    nlast: Tensor
    tlast: Tensor
    iorig: Tensor
    # global scalars (0-d tensors on the state's device)
    t: Tensor
    dt: Tensor
    nstep: Tensor
    neib_overflow: Tensor
    # tree-gravity plan fields: unused until tree gravity is ported
    bucket_map: Optional[Tensor] = None
    walk_mp: Optional[Tensor] = None
    walk_near: Optional[Tensor] = None
    walk_plan_r: Optional[Tensor] = None
    walk_anchors: Optional[Tensor] = None
    walk_margin: Optional[Tensor] = None
    # star and sink slots (an ops.sinks.SinkState), None without stars:
    # they ride in the state so that bursts and rewinds carry them
    sinks: Optional[object] = None

    @property
    def N(self) -> int:
        return self.r.shape[0]

    @property
    def ndim(self) -> int:
        return self.r.shape[1]

    @property
    def alive(self) -> Tensor:
        return (self.flags & FLAG_DEAD) == 0

    def replace(self, **kw) -> "SphState":
        return dataclasses.replace(self, **kw)


def make_sph_state(r, v, m, h, u, device="cpu",
                   dtype=torch.float64) -> SphState:
    """Initial SphState from IC arrays (numpy or tensors); derived fields
    are zero until the first density and force pass."""
    r = np.asarray(r)
    N, ndim = r.shape
    kw = dict(device=device, dtype=dtype)
    f = lambda x: torch.as_tensor(np.asarray(x), **kw).clone()
    fz = lambda: torch.zeros((N,), **kw)
    iz = lambda: torch.zeros((N,), dtype=torch.int32, device=device)
    return SphState(
        r=f(r), v=f(v), a=torch.zeros((N, ndim), **kw),
        r0=f(r), v0=f(v), a0=torch.zeros((N, ndim), **kw),
        m=f(m), h=f(h), rho=fz(),
        u=f(u), u0=f(u), dudt=fz(), dudt0=fz(),
        pressure=fz(), sound=fz(), invomega=torch.ones((N,), **kw),
        zeta=fz(), hfactor=fz(), div_v=fz(),
        alpha=torch.ones((N,), **kw), gpot=fz(), dt_part=fz(),
        ueq=f(u), dt_therm=torch.full((N,), 1e30, **kw), ionfrac=fz(),
        ptype=iz() + GAS_TYPE, flags=iz(), level=iz(), levelneib=iz(),
        nlast=iz(), tlast=fz(),
        iorig=torch.arange(N, dtype=torch.int32, device=device),
        t=torch.zeros((), **kw), dt=torch.zeros((), **kw),
        nstep=torch.zeros((), dtype=torch.int64, device=device),
        neib_overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


@dataclasses.dataclass
class MfvState:
    """Structure-of-arrays meshless finite-volume particle state: the
    fields of gandalf_tpu's MfvState that the global-timestep MUSCL path
    uses.  The block-timestep fields stay None.  ``bad_grad`` is a float
    0/1 flag in the state's dtype, as the JAX package stores it after the
    first gradient pass."""

    r: Tensor            # (N, ndim)
    v: Tensor
    a: Tensor            # gravitational acceleration
    r0: Tensor
    v0: Tensor
    a0: Tensor
    m: Tensor            # (N,)
    h: Tensor
    ndens: Tensor
    rho: Tensor
    u: Tensor
    pressure: Tensor
    sound: Tensor
    invomega: Tensor
    zeta: Tensor
    hfactor: Tensor
    vsig_max: Tensor
    gpot: Tensor
    Qcons0: Tensor       # (N, nvar)
    B: Tensor            # (N, ndim, ndim)
    grad: Tensor         # (N, nvar, ndim)
    alpha_slope: Tensor  # (N, nvar)
    bad_grad: Tensor     # (N,)
    ptype: Tensor
    flags: Tensor
    iorig: Tensor
    t: Tensor
    dt: Tensor
    nstep: Tensor
    neib_overflow: Tensor
    bucket_map: Optional[Tensor] = None
    # block-timestep fields of the JAX package: not ported
    dQ: Optional[Tensor] = None
    rdmdt: Optional[Tensor] = None
    dQdt: Optional[Tensor] = None
    rdmdt0: Optional[Tensor] = None
    level: Optional[Tensor] = None
    levelneib: Optional[Tensor] = None
    nlast: Optional[Tensor] = None
    tlast: Optional[Tensor] = None

    @property
    def N(self) -> int:
        return self.r.shape[0]

    @property
    def ndim(self) -> int:
        return self.r.shape[1]

    @property
    def nvar(self) -> int:
        return self.ndim + 2

    @property
    def alive(self) -> Tensor:
        return (self.flags & FLAG_DEAD) == 0

    @property
    def Wprim(self) -> Tensor:
        """(N, nvar) primitive vector (v..., rho, pressure)."""
        return torch.cat([self.v, self.rho[:, None],
                          self.pressure[:, None]], dim=-1)

    def replace(self, **kw) -> "MfvState":
        return dataclasses.replace(self, **kw)


def make_mfv_state(r, v, m, h, u, device="cpu",
                   dtype=torch.float64) -> MfvState:
    """Initial MfvState from IC arrays; derived fields are zero (alpha
    one) until the first density and gradient pass."""
    r = np.asarray(r)
    N, ndim = r.shape
    nvar = ndim + 2
    kw = dict(device=device, dtype=dtype)
    f = lambda x: torch.as_tensor(np.asarray(x), **kw).clone()
    fz = lambda: torch.zeros((N,), **kw)
    iz = lambda: torch.zeros((N,), dtype=torch.int32, device=device)
    return MfvState(
        r=f(r), v=f(v), a=torch.zeros((N, ndim), **kw),
        r0=f(r), v0=f(v), a0=torch.zeros((N, ndim), **kw),
        m=f(m), h=f(h), ndens=fz(), rho=fz(), u=f(u), pressure=fz(),
        sound=fz(), invomega=torch.ones((N,), **kw), zeta=fz(),
        hfactor=fz(), vsig_max=fz(), gpot=fz(),
        Qcons0=torch.zeros((N, nvar), **kw),
        B=torch.zeros((N, ndim, ndim), **kw),
        grad=torch.zeros((N, nvar, ndim), **kw),
        alpha_slope=torch.ones((N, nvar), **kw), bad_grad=fz(),
        ptype=iz() + GAS_TYPE, flags=iz(),
        iorig=torch.arange(N, dtype=torch.int32, device=device),
        t=torch.zeros((), **kw), dt=torch.zeros((), **kw),
        nstep=torch.zeros((), dtype=torch.int64, device=device),
        neib_overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


@dataclasses.dataclass
class NbodyState:
    """Structure-of-arrays star state of the direct-summation N-body path
    (gandalf_tpu's NbodyState, the reference NbodyParticle,
    NbodyParticle.h:42): the Hermite derivatives a, adot, a2dot, a3dot
    and the step-start copies."""

    r: Tensor            # (N, ndim)
    v: Tensor
    a: Tensor
    adot: Tensor
    a2dot: Tensor
    a3dot: Tensor
    r0: Tensor
    v0: Tensor
    a0: Tensor
    adot0: Tensor
    a2dot0: Tensor       # step-start snap (Hermite6TS)
    m: Tensor            # (N,)
    h: Tensor            # softening length
    gpot: Tensor
    dt_part: Tensor
    level: Tensor
    nlast: Tensor
    tlast: Tensor
    active: Tensor
    t: Tensor            # 0-d
    dt: Tensor
    nstep: Tensor

    @property
    def N(self) -> int:
        return self.r.shape[0]

    @property
    def ndim(self) -> int:
        return self.r.shape[1]

    def replace(self, **kw) -> "NbodyState":
        return dataclasses.replace(self, **kw)


def make_nbody_state(r, v, m, h, device="cpu",
                     dtype=torch.float64) -> NbodyState:
    """Initial NbodyState from IC arrays; the derivatives are zero until
    the bootstrap force pass.  float64 by default, as the reference and
    the JAX package keep stars."""
    r = np.asarray(r)
    N, ndim = r.shape
    kw = dict(device=device, dtype=dtype)
    f = lambda x: torch.as_tensor(np.asarray(x), **kw).clone()
    vz = lambda: torch.zeros((N, ndim), **kw)
    fz = lambda: torch.zeros((N,), **kw)
    iz = lambda: torch.zeros((N,), dtype=torch.int32, device=device)
    return NbodyState(
        r=f(r), v=f(v), a=vz(), adot=vz(), a2dot=vz(), a3dot=vz(),
        r0=f(r), v0=f(v), a0=vz(), adot0=vz(), a2dot0=vz(),
        m=f(m), h=f(h), gpot=fz(), dt_part=fz(),
        level=iz(), nlast=iz(), tlast=fz(),
        active=torch.ones((N,), dtype=torch.bool, device=device),
        t=torch.zeros((), **kw), dt=torch.zeros((), **kw),
        nstep=torch.zeros((), dtype=torch.int64, device=device),
    )


# ---------------------------------------------------------------------------
# Simulation domain and boundaries (same codes as gandalf_tpu.state)
# ---------------------------------------------------------------------------

OPEN = 0
PERIODIC = 1
MIRROR = 2
WALL = 3

_BOUNDARY_CODES = {"open": OPEN, "periodic": PERIODIC, "mirror": MIRROR,
                   "wall": WALL}


@dataclasses.dataclass(frozen=True)
class DomainBox:
    """Static simulation box description."""

    ndim: int
    boxmin: Tuple[float, ...]
    boxmax: Tuple[float, ...]
    lhs: Tuple[int, ...]   # boundary type codes per dim
    rhs: Tuple[int, ...]

    @staticmethod
    def from_params(params) -> "DomainBox":
        ndim = params.intparams["ndim"]
        fp, sp = params.floatparams, params.stringparams
        boxmin = tuple(fp[f"boxmin[{k}]"] for k in range(ndim))
        boxmax = tuple(fp[f"boxmax[{k}]"] for k in range(ndim))
        lhs = tuple(_BOUNDARY_CODES[sp[f"boundary_lhs[{k}]"]]
                    for k in range(ndim))
        rhs = tuple(_BOUNDARY_CODES[sp[f"boundary_rhs[{k}]"]]
                    for k in range(ndim))
        return DomainBox(ndim, boxmin, boxmax, lhs, rhs)

    @property
    def size(self) -> Tuple[float, ...]:
        return tuple(hi - lo for lo, hi in zip(self.boxmin, self.boxmax))

    def periodic_dims(self) -> Tuple[int, ...]:
        return tuple(k for k in range(self.ndim)
                     if self.lhs[k] == PERIODIC and self.rhs[k] == PERIODIC)

    def mirror_walls(self) -> Tuple[Tuple[int, int], ...]:
        """All (dim, side) mirror/wall boundaries; side 0=lhs, 1=rhs."""
        out = []
        for k in range(self.ndim):
            if self.lhs[k] in (MIRROR, WALL):
                out.append((k, 0))
            if self.rhs[k] in (MIRROR, WALL):
                out.append((k, 1))
        return tuple(out)

    # Both maps work column by column with Python-float box constants: a
    # constant tensor built from host data would cost a blocking host to
    # device copy on every step.
    def min_image(self, dr: Tensor) -> Tensor:
        """Minimum-image convention along the periodic dims."""
        pdims = self.periodic_dims()
        if not pdims:
            return dr
        cols = []
        for k in range(self.ndim):
            x, L = dr[..., k], self.size[k]
            cols.append(x - L * torch.round(x / L) if k in pdims else x)
        return torch.stack(cols, dim=-1)

    def wrap(self, r: Tensor) -> Tensor:
        """Wrap positions into the box along the periodic dims."""
        pdims = self.periodic_dims()
        if not pdims:
            return r
        cols = []
        for k in range(self.ndim):
            x, lo = r[..., k], self.boxmin[k]
            cols.append(lo + torch.remainder(x - lo, self.size[k])
                        if k in pdims else x)
        return torch.stack(cols, dim=-1)

    def reflect(self, r: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
        """Reflect escaped particles back across mirror/wall boundaries."""
        walls = self.mirror_walls()
        if not walls:
            return r, v
        r, v = r.clone(), v.clone()
        for (k, side) in walls:
            bound = self.boxmin[k] if side == 0 else self.boxmax[k]
            crossed = (r[:, k] < bound) if side == 0 else (r[:, k] > bound)
            r[:, k] = torch.where(crossed, 2.0 * bound - r[:, k], r[:, k])
            v[:, k] = torch.where(crossed, -v[:, k], v[:, k])
        return r, v
