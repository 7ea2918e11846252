"""SPH smoothing kernels (M4 cubic spline, quintic spline, gaussian) as
torch functions.

Counterpart of ``gandalf_tpu/kernels/smoothing.py``: the same piecewise
polynomials, written term by term in the same form, with integer powers
formed by the same products as JAX's ``integer_pow`` (``_ipow``), so that
float64 results agree to rounding.  Conventions are the same: ``s =
r/h``; ``w0`` is W without 1/h^ndim, ``w1`` is dW/ds without
1/h^(ndim+1), ``womega`` is -(ndim*w0 + s*w1), ``wzeta`` is the
d(phi)/dh kernel, ``wgrav`` and ``wpot`` are the softened gravity force
and potential kernels (1/s^2 and 1/s beyond the support), and ``wdrag``
is the gas-dust drag kernel kernnormdrag s^2 w0(s).  The gaussian's
``womega`` is the JAX package's 2 s^2 form, and its ``wzeta``, ``wgrav``
and ``wpot`` are zero, as there.  ``tabulated`` applies the reference's
table quantisation (``TabulatedKernel``).  The same polynomials are in
``csrc/kernel_family.cuh`` (M4 in ``csrc/m4.cuh``) for the CUDA kernels.
The line-of-sight kernel ``wLOS`` is rendering and not ported (ROADMAP
queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


def _ipow(s: Tensor, n: int) -> Tensor:
    """s**n by the products of JAX's integer_pow (binary exponentiation:
    s**4 = (s*s)*(s*s), s**5 = s*((s*s)*(s*s)), ...)."""
    acc = None
    x = s
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _piecewise(s: Tensor, bounds, fns) -> Tensor:
    """Piece k of `fns` on [bounds[k-1], bounds[k]), zero from the last
    bound on (gandalf_tpu's _piecewise, any number of pieces)."""
    out = torch.zeros_like(s)
    lo = None
    for hi, fn in zip(bounds, fns):
        mask = s < hi if lo is None else (s >= lo) & (s < hi)
        out = torch.where(mask, fn(s), out)
        lo = hi
    return out


@dataclasses.dataclass(frozen=True)
class SmoothingKernel:
    """A bundle of kernel functions for one choice and dimensionality."""

    name: str
    ndim: int
    kernrange: float
    kernnorm: float
    kernnormdrag: float
    w0: Callable[[Tensor], Tensor]
    w1: Callable[[Tensor], Tensor]
    womega: Callable[[Tensor], Tensor]
    wzeta: Callable[[Tensor], Tensor]
    wgrav: Callable[[Tensor], Tensor]
    wpot: Callable[[Tensor], Tensor]

    # the table resolution; 0 for a kernel evaluated directly
    table_res = 0

    @property
    def variant(self) -> str:
        """The family and its table form: "m4", "quintic", "gaussian",
        "m4_tab", "quintic_tab" or "gaussian_tab"."""
        return f"{self.name}_tab" if self.table_res else self.name

    @property
    def kernrangesqd(self) -> float:
        return self.kernrange * self.kernrange

    @property
    def invkernrange(self) -> float:
        return 1.0 / self.kernrange

    def w0_s2(self, ssqd: Tensor) -> Tensor:
        return self.w0(torch.sqrt(ssqd))

    def womega_s2(self, ssqd: Tensor) -> Tensor:
        return self.womega(torch.sqrt(ssqd))

    def wzeta_s2(self, ssqd: Tensor) -> Tensor:
        return self.wzeta(torch.sqrt(ssqd))

    def wdrag(self, s: Tensor) -> Tensor:
        return self.kernnormdrag * s * s * self.w0(s)


# ---------------------------------------------------------------------------
# M4 cubic spline (kernrange = 2)
# ---------------------------------------------------------------------------

def _m4(ndim: int) -> SmoothingKernel:
    norm = {1: 2.0 / 3.0, 2: 10.0 / (7.0 * math.pi), 3: 1.0 / math.pi}[ndim]
    normdrag = {1: 3.0, 2: 49.0 / 31.0, 3: 10.0 / 9.0}[ndim]
    nd = float(ndim)

    def w0(s):
        return _piecewise(s, (1.0, 2.0), (
            lambda s: norm * (1.0 - 1.5 * s * s + 0.75 * s * s * s),
            lambda s: 0.25 * norm * _ipow(2.0 - s, 3)))

    def w1(s):
        return _piecewise(s, (1.0, 2.0), (
            lambda s: norm * (-3.0 * s + 2.25 * s * s),
            lambda s: -0.75 * norm * _ipow(2.0 - s, 2)))

    def womega(s):
        return _piecewise(s, (1.0, 2.0), (
            lambda s: norm * (-nd + 1.5 * (nd + 2.0) * s * s
                              - 0.75 * (nd + 3.0) * _ipow(s, 3)),
            lambda s: norm * (-2.0 * nd + 3.0 * (nd + 1.0) * s
                              - 1.5 * (nd + 2.0) * s * s
                              + 0.25 * (nd + 3.0) * _ipow(s, 3))))

    def wzeta(s):
        return _piecewise(s, (1.0, 2.0), (
            lambda s: (1.4 - 2.0 * s * s + 1.5 * _ipow(s, 4)
                       - 0.6 * _ipow(s, 5)),
            lambda s: (1.6 - 4.0 * s * s + 4.0 * _ipow(s, 3)
                       - 1.5 * _ipow(s, 4) + 0.2 * _ipow(s, 5))))

    def wgrav(s):
        s_safe = torch.clamp_min(s, 1e-30)
        return _piecewise(s, (1.0, 2.0, math.inf), (
            lambda s: ((4.0 / 3.0) * s - 1.2 * _ipow(s, 3)
                       + 0.5 * _ipow(s, 4)),
            lambda s: ((8.0 / 3.0) * s - 3.0 * s * s + 1.2 * _ipow(s, 3)
                       - (1.0 / 6.0) * _ipow(s, 4)
                       - (1.0 / 15.0) / (s_safe * s_safe)),
            lambda s: 1.0 / (s_safe * s_safe)))

    def wpot(s):
        s_safe = torch.clamp_min(s, 1e-30)
        return _piecewise(s, (1.0, 2.0, math.inf), (
            lambda s: (1.4 - (2.0 / 3.0) * s * s + 0.3 * _ipow(s, 4)
                       - 0.1 * _ipow(s, 5)),
            lambda s: (-1.0 / (15.0 * s_safe) + 1.6
                       - (4.0 / 3.0) * s * s + _ipow(s, 3)
                       - 0.3 * _ipow(s, 4) + (1.0 / 30.0) * _ipow(s, 5)),
            lambda s: 1.0 / s_safe))

    return SmoothingKernel("m4", ndim, 2.0, norm, normdrag,
                           w0, w1, womega, wzeta, wgrav, wpot)


# ---------------------------------------------------------------------------
# Quintic spline (kernrange = 3)
# ---------------------------------------------------------------------------

def _quintic(ndim: int) -> SmoothingKernel:
    norm = {1: 1.0 / 120.0, 2: 7.0 / (478.0 * math.pi),
            3: 1.0 / (120.0 * math.pi)}[ndim]
    normdrag = {1: 2.0, 2: 2868.0 / 2771.0, 3: 5.0 / 7.0}[ndim]
    nd = float(ndim)
    p = _ipow

    def w0(s):
        return _piecewise(s, (1.0, 2.0, 3.0), (
            lambda s: norm * (66.0 - 60.0 * s * s + 30.0 * p(s, 4)
                              - 10.0 * p(s, 5)),
            lambda s: norm * (51.0 + 75.0 * s - 210.0 * s * s
                              + 150.0 * p(s, 3) - 45.0 * p(s, 4)
                              + 5.0 * p(s, 5)),
            lambda s: norm * p(3.0 - s, 5)))

    def w1(s):
        return _piecewise(s, (1.0, 2.0, 3.0), (
            lambda s: norm * (-120.0 * s + 120.0 * p(s, 3)
                              - 50.0 * p(s, 4)),
            lambda s: norm * (75.0 - 420.0 * s + 450.0 * s * s
                              - 180.0 * p(s, 3) + 25.0 * p(s, 4)),
            lambda s: norm * (-405.0 + 540.0 * s - 270.0 * s * s
                              + 60.0 * p(s, 3) - 5.0 * p(s, 4))))

    def womega(s):
        return _piecewise(s, (1.0, 2.0, 3.0), (
            lambda s: norm * (-66.0 * nd + 60.0 * (nd + 2.0) * s * s
                              - 30.0 * (nd + 4.0) * p(s, 4)
                              + 10.0 * (nd + 5.0) * p(s, 5)),
            lambda s: norm * (-51.0 * nd - 75.0 * (nd + 1.0) * s
                              + 210.0 * (nd + 2.0) * s * s
                              - 150.0 * (nd + 3.0) * p(s, 3)
                              + 45.0 * (nd + 4.0) * p(s, 4)
                              - 5.0 * (nd + 5.0) * p(s, 5)),
            lambda s: norm * (-243.0 * nd + 405.0 * (nd + 1.0) * s
                              - 270.0 * (nd + 2.0) * s * s
                              + 90.0 * (nd + 3.0) * p(s, 3)
                              - 15.0 * (nd + 4.0) * p(s, 4)
                              + (nd + 5.0) * p(s, 5))))

    def wzeta(s):
        return _piecewise(s, (1.0, 2.0, 3.0), (
            lambda s: (33.0 * s * s - 15.0 * p(s, 4) + 5.0 * p(s, 6)
                       - (10.0 / 7.0) * p(s, 7) - 34.14285714),
            lambda s: (25.5 * s * s + 25.0 * p(s, 3) - 52.5 * p(s, 4)
                       + 30.0 * p(s, 5) - 7.5 * p(s, 6)
                       + (5.0 / 7.0) * p(s, 7) - 33.785714286),
            lambda s: (121.5 * s * s - 135.0 * p(s, 3) + 67.5 * p(s, 4)
                       - 18.0 * p(s, 5) + 2.5 * p(s, 6)
                       - (1.0 / 7.0) * p(s, 7) - 52.07142857)))

    c = 12.0 / 359.0

    def wgrav(s):
        s_safe = torch.clamp_min(s, 1e-30)
        inv_s2 = 1.0 / (s_safe * s_safe)
        return _piecewise(s, (1.0, 2.0, 3.0, math.inf), (
            lambda s: c * (22.0 * s - 12.0 * p(s, 3)
                           + (30.0 / 7.0) * p(s, 5) - 1.25 * p(s, 6)),
            lambda s: c * (17.0 * s + 18.75 * s * s - 42.0 * p(s, 3)
                           + 25.0 * p(s, 4) - (45.0 / 7.0) * p(s, 5)
                           + 0.625 * p(s, 6) + (5.0 / 56.0) * inv_s2),
            lambda s: c * (81.0 * s - 101.25 * p(s, 2) + 54.0 * p(s, 3)
                           - 15.0 * p(s, 4) + (15.0 / 7.0) * p(s, 5)
                           - 0.125 * p(s, 6) - (507.0 / 56.0) * inv_s2),
            lambda s: inv_s2))

    def wpot(s):
        s_safe = torch.clamp_min(s, 1e-30)
        inv_s = 1.0 / s_safe
        return _piecewise(s, (1.0, 2.0, 3.0, math.inf), (
            lambda s: c * (-11.0 * s * s + 3.0 * p(s, 4)
                           - (5.0 / 7.0) * p(s, 6) + (5.0 / 28.0) * p(s, 7)
                           + 478.0 / 14.0),
            lambda s: c * (-8.5 * s * s - 6.25 * p(s, 3) + 10.5 * p(s, 4)
                           - 5.0 * p(s, 5) + (15.0 / 14.0) * p(s, 6)
                           - (5.0 / 56.0) * p(s, 7) + 473.0 / 14.0
                           + (5.0 / 56.0) * inv_s),
            lambda s: c * (-40.5 * s * s + 33.75 * p(s, 3) - 13.5 * p(s, 4)
                           + 3.0 * p(s, 5) - (5.0 / 14.0) * p(s, 6)
                           + (1.0 / 56.0) * p(s, 7) + 729.0 / 14.0
                           - (507.0 / 56.0) * inv_s),
            lambda s: inv_s))

    return SmoothingKernel("quintic", ndim, 3.0, norm, normdrag,
                           w0, w1, womega, wzeta, wgrav, wpot)


# ---------------------------------------------------------------------------
# Gaussian (truncated at s = 3); no gravity kernels, as in the JAX package
# ---------------------------------------------------------------------------

def _gaussian(ndim: int) -> SmoothingKernel:
    norm = {1: 1.0 / math.sqrt(math.pi), 2: 1.0 / math.pi,
            3: 1.0 / math.pi ** 1.5}[ndim]
    normdrag = {1: 2.0, 2: 1.0, 3: 2.0 / 3.0}[ndim]
    nd = float(ndim)

    def w0(s):
        return torch.where(s < 3.0, norm * torch.exp(-s * s), 0.0)

    def w1(s):
        return torch.where(s < 3.0, -2.0 * norm * s * torch.exp(-s * s),
                           0.0)

    def womega(s):
        # h^(ndim+1) dW/dh = norm (2 s^2 - ndim) e^{-s^2}, the JAX
        # package's form (not the reference's 2 s)
        return torch.where(s < 3.0,
                           norm * (2.0 * s * s - nd) * torch.exp(-s * s),
                           0.0)

    def zero(s):
        return torch.zeros_like(s)

    return SmoothingKernel("gaussian", ndim, 3.0, norm, normdrag,
                           w0, w1, womega, zero, zero, zero)


# ---------------------------------------------------------------------------
# The reference's table quantisation
# ---------------------------------------------------------------------------

def _quantise(x: Tensor, step: float) -> Tensor:
    """floor(x / step) * step.  The division is by a tensor: torch turns
    a division by a Python number on the card into a product with its
    reciprocal, and the CUDA kernels divide (IEEE) as the JAX package
    writes it."""
    return torch.floor(x / torch.full_like(x, step)) * step


@functools.lru_cache(maxsize=32)
def _grid_roots(step2: float, res: int, dtype, device) -> Tensor:
    """sqrt(k * step2) for k = 0..res, each product and root rounded
    once in `dtype` (numpy's are IEEE), on `device`."""
    nd = np.float32 if dtype == torch.float32 else np.float64
    k = np.arange(res + 1).astype(nd)
    return torch.as_tensor(np.sqrt(k * nd(step2)), device=device)


@dataclasses.dataclass(frozen=True)
class TabulatedKernel(SmoothingKernel):
    """The reference's TabulatedKernel semantics without the memory table
    (gandalf_tpu's TabulatedKernel): every lookup quantises its argument
    to the table grid (the floor index) and evaluates the base kernel's
    polynomial there.  The gravity lookups return the exact far forms
    1/max(s^2, 1e-60) and 1/max(s, 1e-30) from kernrange on; the
    squared-argument functions quantise on the s^2 grid."""

    base: SmoothingKernel = None
    res: int = 1000

    @property
    def table_res(self) -> int:
        return self.res

    def _q2(self, ssqd: Tensor) -> Tensor:
        """sqrt(floor(ssqd / step2) * step2), step2 = kernrange^2/res.
        The root of grid point k is looked up: torch's CPU square root
        can miss the rounded root by an ulp, which the quintic's terms
        (~1e3 where wzeta is ~0) would carry into the 1e-12 digits."""
        step2 = self.kernrangesqd / self.res
        k = torch.floor(ssqd / torch.full_like(ssqd, step2))
        k = torch.clamp(torch.nan_to_num(k, nan=self.res), 0, self.res)
        return _grid_roots(step2, self.res, ssqd.dtype, ssqd.device)[
            k.long()]

    def w0_s2(self, ssqd: Tensor) -> Tensor:
        return torch.where(ssqd < self.kernrangesqd,
                           self.base.w0(self._q2(ssqd)), 0.0)

    def womega_s2(self, ssqd: Tensor) -> Tensor:
        return torch.where(ssqd < self.kernrangesqd,
                           self.base.womega(self._q2(ssqd)), 0.0)

    def wzeta_s2(self, ssqd: Tensor) -> Tensor:
        return torch.where(ssqd < self.kernrangesqd,
                           self.base.wzeta(self._q2(ssqd)), 0.0)

    def wdrag(self, s: Tensor) -> Tensor:
        sq = _quantise(s, self.kernrange / self.res)
        return torch.where(s < self.kernrange, self.base.wdrag(sq), 0.0)


def tabulated(base: SmoothingKernel, res: int = 1000) -> TabulatedKernel:
    """Wrap a kernel with the reference's table quantisation (res = the
    reference's TabulatedKernel default)."""
    rng = base.kernrange
    step = rng / res

    def wrap(fn):
        return lambda s: torch.where(s < rng, fn(_quantise(s, step)), 0.0)

    def wrap_grav(fn, far):
        return lambda s: torch.where(s < rng, fn(_quantise(s, step)),
                                     far(s))

    def inv2(s):
        return 1.0 / torch.clamp_min(s * s, 1e-60)

    def inv1(s):
        return 1.0 / torch.clamp_min(s, 1e-30)

    return TabulatedKernel(
        name=base.name, ndim=base.ndim, kernrange=base.kernrange,
        kernnorm=base.kernnorm, kernnormdrag=base.kernnormdrag,
        w0=wrap(base.w0), w1=wrap(base.w1), womega=wrap(base.womega),
        wzeta=wrap(base.wzeta), wgrav=wrap_grav(base.wgrav, inv2),
        wpot=wrap_grav(base.wpot, inv1), base=base, res=res)


_FACTORIES = {"m4": _m4, "quintic": _quintic, "gaussian": _gaussian}

# the variants beside the direct M4: (kernel, tabulated_kernel) of each
VARIANTS = {"quintic": ("quintic", 0), "gaussian": ("gaussian", 0),
            "m4_tab": ("m4", 1), "quintic_tab": ("quintic", 1),
            "gaussian_tab": ("gaussian", 1)}


def kernel_factory(name: str, ndim: int,
                   tabulated_kernel: int = 0) -> SmoothingKernel:
    """Build a kernel by parameter-file name (the reference's kernel
    factory); tabulated_kernel = 1 applies the table quantisation."""
    if ndim not in (1, 2, 3):
        raise ValueError(f"ndim must be 1, 2 or 3, got {ndim}")
    key = name.lower()
    if key not in _FACTORIES:
        raise ValueError(f"Unrecognised kernel: {name!r}")
    kern = _FACTORIES[key](ndim)
    return tabulated(kern) if tabulated_kernel else kern
