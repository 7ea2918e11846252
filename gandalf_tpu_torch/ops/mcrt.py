"""Monte-Carlo radiation transport on the structured grid.

Counterpart of ``gandalf_tpu/ops/mcrt.py`` (the reference's
TreeMonteCarlo and MonochromaticIonisationMonteCarlo,
src/Thermal/TreeMonteCarlo.cpp, src/Tree/KDRadiationTree.cpp,
src/Thermal/MonochromaticIonisationMonteCarlo.cpp, re-designed there as
packets marching in lockstep with a fixed step through the per-cell
fields of the grid):

- a packet carries a continuous weight, attenuated by exp(-kappa rho ds)
  each step;
- the Lucy (1999) estimator sums w ds per visited cell (the exact
  integral of w(l) dl over the step), u_rad = (L / Np) sum(w ds) /
  (c V_cell);
- the absorbed weight per cell gives the photoionisation rate of the
  monochromatic ionisation balance, iterated as the reference iterates
  its radiation <-> ionisation loop.

``propagate_packets`` launches K36 (``csrc/radiation.cu``) on CUDA
tensors and runs its plain version ``propagate_packets_plain`` (the JAX
scan, one step at a time) on CPU tensors.  The random draws (each
packet's source and direction) are an input: ``mc_draws`` makes one set
per iteration from a ``torch.Generator``, and a caller may hand in any
other draws (the JAX package's, for a comparison).  The ionisation
balance between iterations and ``flat_cell_index`` are elementwise
torch.
"""

from __future__ import annotations

import math

import torch

from .. import _ext
from .treeray import cell_indexer, cell_volume

Tensor = torch.Tensor


def isotropic_directions(gen: torch.Generator, n: int, ndim: int = 3,
                         device="cpu", dtype=torch.float64) -> Tensor:
    """n uniformly random unit vectors (n, ndim) from `gen`: mu uniform
    in [-1, 1) and phi in [0, 2 pi) in 3D, phi in 2D, a random sign in
    1D (the JAX function's construction)."""
    kw = dict(generator=gen, device=device, dtype=dtype)
    if ndim == 3:
        mu = torch.rand((n,), **kw) * 2.0 - 1.0
        phi = torch.rand((n,), **kw) * (2.0 * math.pi)
        s = torch.sqrt(torch.clamp_min(1.0 - mu * mu, 0.0))
        return torch.stack([s * torch.cos(phi), s * torch.sin(phi), mu], -1)
    if ndim == 2:
        phi = torch.rand((n,), **kw) * (2.0 * math.pi)
        return torch.stack([torch.cos(phi), torch.sin(phi)], -1)
    sgn = torch.rand((n,), **kw) < 0.5
    return torch.where(sgn, 1.0, -1.0).to(dtype)[:, None]


def mc_draws(gen: torch.Generator, L_src: Tensor, n_packets: int,
             ndim: int, n_iter: int):
    """`n_iter` draws of (source index (Np,) int64, direction (Np, ndim)),
    made lazily one iteration at a time on L_src's device: the source
    sampled in proportion to its luminosity (inverse CDF of a uniform),
    the direction isotropic."""
    dev, dt = L_src.device, L_src.dtype
    cdf = torch.cumsum(L_src, 0)
    for _ in range(n_iter):
        u = torch.rand((n_packets,), generator=gen, device=dev, dtype=dt)
        src = torch.clamp_max(torch.searchsorted(cdf, u * cdf[-1],
                                                 right=True),
                              L_src.shape[0] - 1)
        yield src, isotropic_directions(gen, n_packets, ndim, dev, dt)


def propagate_packets(spec, opacity_cell: Tensor, r0: Tensor, dirs: Tensor,
                      n_steps: int, step_frac: float = 0.5):
    """March the packets in lockstep through the grid.

    opacity_cell: per-cell absorption coefficient kappa rho (1/length),
    shape *ncells; r0 (Np, nd) starts, dirs (Np, nd) unit directions;
    the step is step_frac times the smallest cell edge.  Returns
    (pathlen_cell, absorbed_cell, escaped_weight): sum of w ds per cell
    (the Lucy estimator's numerator) and the absorbed weight per cell,
    both shape *ncells, and the weight that left the domain (a 0-d
    tensor).  K36 on CUDA tensors."""
    ds = step_frac * min(spec.extents[k] / spec.ncells[k]
                         for k in range(spec.ndim))
    if r0.is_cuda:
        path, absorbed, esc = _ext.packet_march(
            spec, opacity_cell.reshape(-1).contiguous(), r0.contiguous(),
            dirs.contiguous(), n_steps, ds)
        shape = tuple(spec.ncells)
        return path.reshape(shape), absorbed.reshape(shape), esc
    return propagate_packets_plain(spec, opacity_cell, r0, dirs, n_steps,
                                   ds)


def propagate_packets_plain(spec, opacity_cell: Tensor, r0: Tensor,
                            dirs: Tensor, n_steps: int, ds: float,
                            acc_dtype=None):
    """Plain version of K36 at step ds: the JAX scan's body step by
    step, each step's scatter-adds into its own row of zeroed per-cell
    sums, the rows summed after.  The sums are in `acc_dtype` (r0's type
    by default; K36 accumulates in float64 whatever its type)."""
    n_cells = opacity_cell.numel()
    op_flat = opacity_cell.reshape(-1)
    index = cell_indexer(spec, r0.dtype, r0.device)
    pos, w = r0, torch.ones((r0.shape[0],), dtype=r0.dtype,
                            device=r0.device)
    # per step: path sums, absorbed sums and the escaped weight
    sums = torch.zeros((n_steps, 2 * n_cells + 1),
                       dtype=acc_dtype or w.dtype, device=w.device)
    half = 0.5 * ds
    for k in range(n_steps):
        flat, inside = index(pos + half * dirs)
        op = op_flat[flat]
        tau = torch.where(inside, op * ds, 0.0)
        absorb = w * (1.0 - torch.exp(-tau))
        wpath = torch.where(tau > 1e-12,
                            absorb / torch.clamp_min(op, 1e-300), w * ds)
        row = sums[k]
        row.index_add_(0, flat, torch.where(inside, wpath, 0.0).to(row.dtype))
        row.index_add_(0, flat + n_cells,
                       torch.where(inside, absorb, 0.0).to(row.dtype))
        row[-1] = torch.sum(torch.where(inside, 0.0, w).to(row.dtype))
        w = torch.where(inside, w - absorb, 0.0)
        pos = pos + ds * dirs
    total = torch.sum(sums, 0)
    shape = tuple(spec.ncells)
    return (total[:n_cells].reshape(shape),
            total[n_cells:2 * n_cells].reshape(shape),
            total[-1] + torch.sum(w.to(total.dtype)))


def mc_radiation_field(spec, opacity_cell: Tensor, r_src: Tensor,
                       L_src: Tensor, draw, n_steps: int = 256,
                       c_light: float = 1.0, step_frac: float = 0.5):
    """Lucy (1999) radiation energy density from point sources
    (TreeMonteCarlo::UpdateRadiationField) for one draw (source index,
    direction) of the packets:

        u_rad = (L_tot / Npacket) sum(w ds) / (c V_cell).

    Returns (u_rad, absorbed_rate, escaped fraction); absorbed_rate is
    the energy absorbed per unit time and volume in each cell."""
    src, dirs = draw
    n_packets = src.shape[0]
    L_tot = torch.sum(L_src)
    pathlen, absorbed, escaped = propagate_packets(
        spec, opacity_cell, r_src[src], dirs, n_steps, step_frac)
    e_pack = L_tot / n_packets
    v_cell = cell_volume(spec)
    u_rad = e_pack * pathlen / (c_light * v_cell)
    absorbed_rate = e_pack * absorbed / v_cell
    return u_rad, absorbed_rate, escaped / n_packets


def monochromatic_ionisation_mc(spec, nH_cell: Tensor, r_src: Tensor,
                                ndot_src: Tensor, draws, sigma: float,
                                alphaB: float, n_steps: int = 256,
                                step_frac: float = 0.5) -> Tensor:
    """Monochromatic Monte-Carlo ionisation balance
    (MonochromaticIonisationMonteCarlo), one iteration per draw:

      opacity = n_H xHI sigma  ->  propagate packets  ->
      photoionisations per cell = Ndot_tot / Np absorbed  ->
      xHI from local equilibrium x Gamma = alphaB (1 - x)^2 n_H,

    under-relaxed by a half.  Returns the per-cell neutral fraction xHI
    (*ncells)."""
    nH = torch.clamp_min(nH_cell, 1e-300)
    xHI = torch.full_like(nH, 1e-3)
    for draw in draws:
        op = nH * xHI * sigma
        _, absorbed, _ = mc_radiation_field(
            spec, op, r_src, ndot_src, draw, n_steps, c_light=1.0,
            step_frac=step_frac)
        # the rate per neutral atom is x-independent in the optically
        # thin limit, which keeps the fixed point stable
        gamma = absorbed / (nH * torch.clamp_min(xHI, 1e-8))
        # the stable root of A (1-x)^2 = x, A = alphaB n_H / Gamma, in its
        # conjugate form
        A = alphaB * nH / torch.clamp_min(gamma, 1e-300)
        x_new = 2.0 * A / (2.0 * A + 1.0 + torch.sqrt(4.0 * A + 1.0))
        x_new = torch.where(gamma <= 0.0, 1.0, x_new)
        xHI = 0.5 * xHI + 0.5 * x_new
    return xHI
