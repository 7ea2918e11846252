"""M4 cubic-spline smoothing kernel as torch functions.

Counterpart of ``gandalf_tpu/kernels/smoothing.py`` for the M4 kernel
(``_m4`` and the squared-argument variants).  Conventions are the same:
``s = r/h``; ``w0`` is W without 1/h^ndim, ``w1`` is dW/ds without
1/h^(ndim+1), ``womega`` is -(ndim*w0 + s*w1), ``wzeta`` is the
d(phi)/dh kernel, ``wgrav`` and ``wpot`` are the softened gravity force
and potential kernels (1/s^2 and 1/s beyond the support), and ``wdrag``
is the gas-dust drag kernel kernnormdrag s^2 w0(s).  The same
polynomials are in ``csrc/m4.cuh`` for the CUDA kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Tensor = torch.Tensor


def _piecewise(s: Tensor, inner: Callable, outer: Callable,
               beyond: Callable = torch.zeros_like) -> Tensor:
    """`inner` on [0, 1), `outer` on [1, 2), `beyond` (zero) from 2."""
    return torch.where(s < 1.0, inner(s),
                       torch.where(s < 2.0, outer(s), beyond(s)))


@dataclasses.dataclass(frozen=True)
class SmoothingKernel:
    """The M4 kernel functions for one dimensionality."""

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

    def w0_s2(self, ssqd: Tensor) -> Tensor:
        return self.w0(torch.sqrt(ssqd))

    def womega_s2(self, ssqd: Tensor) -> Tensor:
        return self.womega(torch.sqrt(ssqd))

    def wzeta_s2(self, ssqd: Tensor) -> Tensor:
        return self.wzeta(torch.sqrt(ssqd))

    def wdrag(self, s: Tensor) -> Tensor:
        return self.kernnormdrag * s * s * self.w0(s)


def _m4(ndim: int) -> SmoothingKernel:
    norm = {1: 2.0 / 3.0, 2: 10.0 / (7.0 * math.pi), 3: 1.0 / math.pi}[ndim]
    normdrag = {1: 3.0, 2: 49.0 / 31.0, 3: 10.0 / 9.0}[ndim]
    nd = float(ndim)

    def w0(s):
        return _piecewise(
            s,
            lambda s: norm * (1.0 - 1.5 * s * s + 0.75 * s * s * s),
            lambda s: 0.25 * norm * (2.0 - s) ** 3)

    def w1(s):
        return _piecewise(
            s,
            lambda s: norm * (-3.0 * s + 2.25 * s * s),
            lambda s: -0.75 * norm * (2.0 - s) ** 2)

    def womega(s):
        return _piecewise(
            s,
            lambda s: norm * (-nd + 1.5 * (nd + 2.0) * s * s
                              - 0.75 * (nd + 3.0) * s ** 3),
            lambda s: norm * (-2.0 * nd + 3.0 * (nd + 1.0) * s
                              - 1.5 * (nd + 2.0) * s * s
                              + 0.25 * (nd + 3.0) * s ** 3))

    def wzeta(s):
        return _piecewise(
            s,
            lambda s: 1.4 - 2.0 * s * s + 1.5 * s ** 4 - 0.6 * s ** 5,
            lambda s: (1.6 - 4.0 * s * s + 4.0 * s ** 3 - 1.5 * s ** 4
                       + 0.2 * s ** 5))

    def wgrav(s):
        s_safe = torch.clamp_min(s, 1e-30)
        return _piecewise(
            s,
            lambda s: (4.0 / 3.0) * s - 1.2 * s ** 3 + 0.5 * s ** 4,
            lambda s: ((8.0 / 3.0) * s - 3.0 * s * s + 1.2 * s ** 3
                       - (1.0 / 6.0) * s ** 4
                       - (1.0 / 15.0) / (s_safe * s_safe)),
            lambda s: 1.0 / (s_safe * s_safe))

    def wpot(s):
        s_safe = torch.clamp_min(s, 1e-30)
        return _piecewise(
            s,
            lambda s: 1.4 - (2.0 / 3.0) * s * s + 0.3 * s ** 4 - 0.1 * s ** 5,
            lambda s: (-1.0 / (15.0 * s_safe) + 1.6 - (4.0 / 3.0) * s * s
                       + s ** 3 - 0.3 * s ** 4 + (1.0 / 30.0) * s ** 5),
            lambda s: 1.0 / s_safe)

    return SmoothingKernel("m4", ndim, 2.0, norm, normdrag,
                           w0, w1, womega, wzeta, wgrav, wpot)


def kernel_factory(name: str, ndim: int,
                   tabulated_kernel: int = 0) -> SmoothingKernel:
    """Build a kernel by parameter-file name.  Only the untabulated M4
    kernel is ported; the others are ROADMAP queue 1, item 9."""
    if ndim not in (1, 2, 3):
        raise ValueError(f"ndim must be 1, 2 or 3, got {ndim}")
    if name.lower() != "m4":
        raise NotImplementedError(
            f"kernel {name!r} is not ported yet (ROADMAP queue 1, item 9); "
            "only 'm4' is")
    if tabulated_kernel:
        raise NotImplementedError(
            "tabulated_kernel = 1 is not ported yet (ROADMAP queue 1, "
            "item 9)")
    return _m4(ndim)
