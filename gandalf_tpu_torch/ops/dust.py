"""Gas-dust drag: the semi-implicit two-fluid drag and the test-particle
mode on the structured grid (K23, K24).

Counterpart of ``gandalf_tpu/ops/dust.py`` (Loren-Aguilar & Bate 2014;
GANDALF's src/Common/Dust.cpp:812-1145 and the stopping-time laws of
src/Headers/DragLaws.h): ``DragLaw``, ``DragResult`` and
``drag_pass_grid``, the grid pass of ``drag_pass_grid`` there
(:269-346).  Each gas-dust pair integrates the linear drag exactly over
the step,

  Xi     = (1 - e^-tau) / (dt rho),   tau = dt / t_s,  rho = rho_g + rho_d
  Lambda = (dt + t_s) Xi - 1/rho
  S      = (dv.r + dt da.r) Xi - (da.r) Lambda
  a_i   -= ndim rho_j S r_hat wdrag(q) m_j / (rho_j h_gas^ndim)

with the series form of Xi and Lambda where tau <= 1e-3.  Gas turns the
kinetic energy it loses into heat; dust deposits its share onto its gas
neighbours.

The pass takes the candidates of the 3^ndim cells around each particle,
as the JAX package's ``gather_active_candidates`` does, from a binning
of the alive particles (K1), with the mirror images of mirror and wall
sides (K19; the images also flip the wall-normal component of a and a0).
Only the particles themselves are targets.  K23 (``drag_sums``) gives
each target its drag acceleration, the normalisation sum of the drag
kernel, the dust's sound speed (largest over its gas partners) and
|dv| / h.  The JAX package scatters the dust's energy deposit onto the
candidates' ids; K24 (``drag_deposit``) is the gather form of
``drag_pass_dense`` (:485-497): each dust particle's payload m dEk /
norm, and each gas target sums wraw P / rho over its dust candidates,
images included (the drag kernel takes the gas side's h, so a pair's
weight is the same seen from either side).  Every output is written
once.

Each kernel has a plain PyTorch version here (the JAX package's
per-row view, over chunks of target rows, with d^2 summed in the CUDA
kernels' order) and a CUDA C++ kernel in ``csrc/dust_drag.cuh`` (one
source per smoothing-kernel family, ``csrc/dust_drag_<family>.cu``),
launched through ``_ext``.  Both take any kernel of the family (M4, the
quintic, the gaussian, direct or tabulated).  A CPU tensor takes the
plain version; a CUDA tensor takes the kernel, or the wrapper raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import _ext
from ..state import DUST_TYPE, GAS_TYPE
from . import sph_grid27 as g27
from .active_grid import dense_ids
from .mfv import _dist2

Tensor = torch.Tensor

EPSTEIN_NORM = 0.4699928014933126      # 3 sqrt(pi/8)/4 (DragLaws.h:73)

# the law codes of csrc/dust_drag.cu
LAW_CODES = {"fixed": 0, "density": 1, "epstein": 2, "lp12": 3, "LP12": 3}

# columns of the packed per-particle scalars handed to K23 and K24
DRAG_SCALARS = ("m", "h", "rho", "sound")


@dataclasses.dataclass(frozen=True)
class DragLaw:
    """Stopping-time prescription (DragLaws.h; gandalf_tpu's DragLaw)."""

    law: str = "fixed"                 # fixed | density | epstein | lp12
    coeff: float = 1.0
    use_energy_term: bool = True

    def __post_init__(self):
        if self.law not in LAW_CODES:
            raise ValueError(f"unknown drag_law {self.law!r}")

    @staticmethod
    def from_params(params) -> "DragLaw":
        return DragLaw(law=params.stringparams["drag_law"],
                       coeff=params.floatparams["drag_coeff"],
                       use_energy_term=params.stringparams["gas_eos"]
                       != "isothermal")

    @property
    def code(self) -> int:
        return LAW_CODES[self.law]

    def t_stop(self, grho: Tensor, drho: Tensor, gsound: Tensor) -> Tensor:
        K = self.coeff
        if self.law == "fixed":
            return torch.full_like(grho, 1.0 / K)
        if self.law == "density":
            return 1.0 / ((grho + drho) * K)
        if self.law == "epstein":
            return EPSTEIN_NORM / ((grho + drho) * gsound * K)
        return drho * grho / ((grho + drho) * K)     # lp12


class DragResult(NamedTuple):
    a_drag: Tensor     # (N, ndim)
    dudt: Tensor       # (N,) drag heating of the gas
    sound: Tensor      # (N,) dust timestep sound speed (max gas partner)
    div_v: Tensor      # (N,) dust |dv|/h for the timestep criterion


# ---------------------------------------------------------------------------
# Candidates of listed target rows, in any ndim
# ---------------------------------------------------------------------------

def _targets(spec: g27.Grid27Spec, ids_d: Tensor, n_targets: int):
    """The slotted targets (ids below n_targets) and their cells, in slot
    order."""
    flat = ids_d.reshape(-1).long()
    slot = torch.nonzero((flat >= 0) & (flat < n_targets)).flatten()
    return flat[slot], slot // spec.k_cell


def _candidate_pairs(spec: g27.Grid27Spec, table, ids_d: Tensor,
                     r: Tensor, p: Tensor, cell: Tensor):
    """The filled candidates among the 3^ndim K slots around targets p
    (in cells `cell`), as flat pairs ordered by target, then stencil
    position: the target's position in p (int64), the candidate's id
    and r_cand - r_p (P, ndim) with the periodic shifts applied (the
    target itself among them)."""
    nb, off, ok = table
    K = spec.k_cell
    cand = ids_d.reshape(-1, K)[nb[cell]]                   # (n, S, K)
    valid = (cand >= 0) & ok[cell][..., None]
    row, sidx, kk = torch.nonzero(valid, as_tuple=True)
    q = cand[row, sidx, kk].long()
    dr = (r[q] + off[cell[row], sidx].to(r.dtype)) - r[p[row]]
    return row, q, dr


def _chunks(spec: g27.Grid27Spec, n: int, device):
    """Row chunks of the plain versions: at most 2^25 candidate slots a
    chunk on a GPU, 2^21 on a CPU."""
    budget = 1 << 25 if device.type == "cuda" else 1 << 21
    step = max(1, budget // max(3 ** spec.ndim * spec.k_cell, 1))
    return range(0, n, step), step


def _invh(h_gas: Tensor) -> Tensor:
    return 1.0 / torch.clamp_min(h_gas, 1e-30)


def _wraw(kern, nd: int, h_gas: Tensor, drmag: Tensor) -> Tensor:
    """invh^ndim wdrag(|dr| invh) with the gas side's h (any kernel of
    the family; a table quantises s = |dr| invh on its s grid)."""
    invh = _invh(h_gas)
    return (invh ** nd) * kern.wdrag(drmag * invh)


def _in_support(kern, h_gas: Tensor, drmag: Tensor) -> Tensor:
    """Whether wdrag can be non-zero at the pair: s = |dr| invh, formed
    as _wraw forms it, below kernrange."""
    return drmag * _invh(h_gas) < kern.kernrange


# ---------------------------------------------------------------------------
# K23: the drag sums
# ---------------------------------------------------------------------------

def drag_sums(kern, law: DragLaw, spec: g27.Grid27Spec, ids_d: Tensor,
              n_targets: int, r: Tensor, vec: Tensor, sc: Tensor,
              ptype: Tensor, dt: Tensor, test_particle: bool):
    """The drag sums of every slotted target (ids below n_targets) of
    K1's slot map ids_d over the (M,) particles and images r (M, ndim):
    a_drag (n_targets, ndim), the normalisation sum of m_j/rho_j wdrag,
    the largest gas partner's sound speed and the largest |dv| over h,
    each (n_targets,), zero for a target without a slot.  `vec` (M,
    3 ndim) holds v, a, a0, `sc` (M, 4) DRAG_SCALARS, ptype (M,) int32,
    dt (n_targets,) each target's step.  K23 on CUDA tensors."""
    if r.is_cuda:
        return _ext.dust_drag_sums(spec, kern, law, test_particle, ids_d,
                                   n_targets, r, vec, sc, ptype, dt)
    return drag_sums_plain(kern, law, spec, ids_d, n_targets, r, vec, sc,
                           ptype, dt, test_particle)


def drag_sums_plain(kern, law: DragLaw, spec: g27.Grid27Spec, ids_d,
                    n_targets, r, vec, sc, ptype, dt, test_particle):
    """Plain version of K23: gandalf_tpu's drag_twofluid_view over chunks
    of target rows, each over all its 3^ndim K candidates (the dust's
    sound speed and |dv| take every cross-type candidate, within the
    kernel's support or not)."""
    nd = spec.ndim
    dev, dtp = r.device, r.dtype
    a_out = torch.zeros((n_targets, nd), dtype=dtp, device=dev)
    norm_out = torch.zeros((n_targets,), dtype=dtp, device=dev)
    snd_out = torch.zeros_like(norm_out)
    divv_out = torch.zeros_like(norm_out)
    p_all, cell_all = _targets(spec, ids_d, n_targets)
    table = g27._neighbour_table(spec, dev)
    starts, step = _chunks(spec, p_all.numel(), dev)
    v, a, a0 = vec[:, :nd], vec[:, nd:2 * nd], vec[:, 2 * nd:]
    m, h, rho, sound = (sc[:, k] for k in range(4))
    for c0 in starts:
        p, cell = p_all[c0:c0 + step], cell_all[c0:c0 + step]
        row, cid, dr = _candidate_pairs(spec, table, ids_d, r, p, cell)
        pi = p[row]
        gas_i = ptype[pi] == GAS_TYPE
        dust_i = ptype[pi] == DUST_TYPE
        drij = -dr                                      # r_i - r_j
        drsqd = _dist2(drij)
        pair = ((gas_i & (ptype[cid] == DUST_TYPE))
                | (dust_i & (ptype[cid] == GAS_TYPE))) & (drsqd > 0.0)
        row, pi, cid, drij, drsqd = (x[pair] for x in
                                     (row, pi, cid, drij, drsqd))
        gas_i = gas_i[pair]
        dt_i = dt[pi]
        drmag = torch.sqrt(drsqd)
        h_gas = torch.where(gas_i, h[pi], h[cid])
        gsound = torch.where(gas_i, sound[pi], sound[cid])
        da0 = a0[pi] - a0[cid]
        dv = v[pi] - v[cid] - 0.5 * dt_i[:, None] * da0
        dvmag = torch.sqrt(torch.clamp_min(torch.sum(dv * dv, -1), 0.0))
        n = p.numel()

        def pmax(x):
            out = torch.zeros((n,), dtype=x.dtype, device=dev)
            return out.scatter_reduce_(0, row, x, "amax")

        snd_out[p] = pmax(gsound)
        divv_out[p] = pmax(dvmag) / torch.clamp_min(h[p], 1e-30)
        # beyond the drag kernel's support a pair adds exactly zero: the
        # rest runs on the pairs inside it
        inside = _in_support(kern, h_gas, drmag)
        row, pi, cid, drij, drmag, h_gas, gsound, dv, gas_i, dt_i = (
            x[inside] for x in (row, pi, cid, drij, drmag, h_gas, gsound,
                                dv, gas_i, dt_i))
        unit = drij / drmag[:, None]
        wraw = _wraw(kern, nd, h_gas, drmag)
        wkern = wraw * m[cid] / torch.clamp_min(rho[cid], 1e-30)
        da = a[pi] - a[cid]
        dvdr = torch.sum(dv * unit, dim=-1)
        dadr = torch.sum(da * unit, dim=-1)
        grho = torch.where(gas_i, rho[pi], rho[cid])
        drho = torch.where(gas_i, rho[cid], rho[pi])
        if test_particle:
            drho = torch.zeros_like(drho)
        t_s = torch.clamp_min(law.t_stop(grho, drho, gsound), 1e-30)
        rho_t = grho + drho
        tau = dt_i / t_s
        dt_safe = torch.clamp_min(dt_i, 1e-30)
        xi_big = (1.0 - torch.exp(-tau)) / (dt_safe * rho_t)
        lam_big = (dt_i + t_s) * xi_big - 1.0 / rho_t
        xi_small0 = (1.0 - 0.5 * tau * (1.0 - tau / 3.0)) / rho_t
        lam_small = (1.0 + tau) * xi_small0 - 1.0 / rho_t
        xi_small = xi_small0 / t_s
        big = tau > 1e-3
        Xi = torch.where(big, xi_big, xi_small)
        Lam = torch.where(big, lam_big, lam_small)
        S = (dvdr + dt_i * dadr) * Xi - dadr * Lam
        contrib = nd * rho[cid] * S * wkern
        a_drag = -torch.zeros((n, nd), dtype=r.dtype, device=dev).index_add_(
            0, row, contrib[:, None] * unit)
        if test_particle:
            a_drag = torch.where((ptype[p] == DUST_TYPE)[:, None], a_drag,
                                 0.0)
        a_out[p] = a_drag
        norm_out[p] = torch.zeros((n,), dtype=r.dtype,
                                  device=dev).index_add_(0, row, wkern)
    return a_out, norm_out, snd_out, divv_out


# ---------------------------------------------------------------------------
# K24: the dust-to-gas energy deposit
# ---------------------------------------------------------------------------

def drag_deposit(kern, spec: g27.Grid27Spec, ids_d: Tensor, n_targets: int,
                 r: Tensor, sc: Tensor, ptype: Tensor, payload: Tensor,
                 dek: Tensor):
    """du/dt of the drag heating of every slotted gas target (ids below
    n_targets): -dEk_i - sum_j wraw(|r_ij|, h_i) P_j / rho_i over its dust
    candidates j, P the payload (M,) of the particles and images; zero
    for dust and for a target without a slot.  K24 on CUDA tensors."""
    if r.is_cuda:
        return _ext.dust_drag_deposit(spec, kern, ids_d, n_targets, r, sc,
                                      ptype, payload, dek)
    return drag_deposit_plain(kern, spec, ids_d, n_targets, r, sc, ptype,
                              payload, dek)


def drag_deposit_plain(kern, spec: g27.Grid27Spec, ids_d, n_targets, r,
                       sc, ptype, payload, dek):
    """Plain version of K24: gandalf_tpu's drag_pass_dense deposit
    (:485-497) over each gas target's candidates, in chunks of rows."""
    nd = spec.ndim
    dev = r.device
    out = torch.zeros((n_targets,), dtype=r.dtype, device=dev)
    p_all, cell_all = _targets(spec, ids_d, n_targets)
    gas = ptype[p_all] == GAS_TYPE
    p_all, cell_all = p_all[gas], cell_all[gas]
    table = g27._neighbour_table(spec, dev)
    starts, step = _chunks(spec, p_all.numel(), dev)
    h, rho = sc[:, 1], sc[:, 2]
    for c0 in starts:
        p, cell = p_all[c0:c0 + step], cell_all[c0:c0 + step]
        row, cid, dr = _candidate_pairs(spec, table, ids_d, r, p, cell)
        drsqd = _dist2(dr)
        drmag = torch.sqrt(torch.where(drsqd > 0, drsqd, 1.0))
        h_i = h[p[row]]
        # beyond the drag kernel's support a pair adds exactly zero
        keep = ((ptype[cid] == DUST_TYPE) & (drsqd > 0.0)
                & _in_support(kern, h_i, drmag))
        row, cid, drmag, h_i = (x[keep] for x in (row, cid, drmag, h_i))
        dep = torch.zeros((p.numel(),), dtype=r.dtype, device=dev
                          ).index_add_(0, row, _wraw(kern, nd, h_i, drmag)
                                       * payload[cid])
        out[p] = -dek[p] - dep / torch.clamp_min(rho[p], 1e-30)
    return out


# ---------------------------------------------------------------------------
# The grid pass
# ---------------------------------------------------------------------------

def _flip_tile(walls, x: Tensor) -> Tensor:
    """x (N, ndim) followed by one copy per wall with the wall-normal
    component negated: the images' a and a0."""
    parts = [x]
    for (k, _, _) in walls:
        y = x.clone()
        y[:, k] = -x[:, k]
        parts.append(y)
    return torch.cat(parts)


class DragInputs(NamedTuple):
    """What K23 and K24 take for one state: the slot map of the alive
    particles and their images, the (M,) rows of r, vec (v, a, a0),
    DRAG_SCALARS and ptype (the particles first, then one copy per
    wall), each target's dt (N,), the copies per particle and the
    binning's overflow."""

    ids_d: Tensor
    r: Tensor
    vec: Tensor
    sc: Tensor
    ptype: Tensor
    dt: Tensor
    n_rep: int
    overflow: Tensor


def drag_inputs(spec: g27.Grid27Spec, box, dt, s, alive: Tensor
                ) -> DragInputs:
    """K23's and K24's inputs for state s (the glue of drag_pass_grid):
    with mirror layers in the plan the particles' images (K19; a and a0
    flipped here) join them within a layer of their wall, and K1 bins
    the alive ones."""
    N = s.N
    dt_r = torch.broadcast_to(torch.as_tensor(dt, dtype=s.r.dtype,
                                              device=s.r.device), (N,))
    sc = torch.stack([getattr(s, k) for k in DRAG_SCALARS], dim=-1)
    if spec.mirror:
        walls = g27.mirror_planes(box, spec)
        r_e, v_e, keep = g27.grid_mirror_extend(box, spec, s.r, s.v, alive)
        a_e, a0_e = _flip_tile(walls, s.a), _flip_tile(walls, s.a0)
        n_rep = 1 + len(walls)
    else:
        r_e, v_e, a_e, a0_e, keep = s.r, s.v, s.a, s.a0, alive
        n_rep = 1
    b = g27.bin_particles(spec, r_e, discard=~keep)
    return DragInputs(
        ids_d=dense_ids(spec, b), r=r_e,
        vec=torch.cat([v_e, a_e, a0_e], dim=-1), sc=sc.repeat(n_rep, 1),
        ptype=s.ptype.repeat(n_rep), dt=dt_r.contiguous(), n_rep=n_rep,
        overflow=b.overflow)


def drag_energy(s, dt: Tensor, a_drag: Tensor, norm: Tensor):
    """The elementwise epilogue of K23: each particle's kinetic-energy
    change dEk (N,) over its step dt (N,), from the kick-start velocity
    v - dt/2 a0 plus a dt, and the dust's payload m dEk / norm (zero for
    gas)."""
    dtc = dt[:, None]
    v_end = s.v - 0.5 * dtc * s.a0 + s.a * dtc
    dek = torch.sum(a_drag * (v_end + 0.5 * a_drag * dtc), dim=-1)
    payload = torch.where(s.ptype == DUST_TYPE,
                          s.m * dek / torch.clamp_min(norm, 1e-30), 0.0)
    return dek, payload


def drag_pass_grid(kern, law: DragLaw, spec: g27.Grid27Spec, box, dt,
                   s, alive: Tensor, test_particle: bool):
    """Gas-dust drag of state s over the grid's candidates (gandalf_tpu's
    drag_pass_grid): (DragResult, overflow of the pass's binning).  dt
    is a scalar or each particle's step (N,), used on both sides of a
    pair (the target's).  Only the particles are targets; with mirror
    layers a gas target gathers the payloads of dust images as of any
    dust neighbour, which is the JAX package's redirect of a deposit on
    a gas image to its parent."""
    N = s.N
    di = drag_inputs(spec, box, dt, s, alive)
    a_drag, norm, sound, div_v = drag_sums(kern, law, spec, di.ids_d, N,
                                           di.r, di.vec, di.sc, di.ptype,
                                           di.dt, test_particle)
    dudt = torch.zeros_like(s.m)
    if law.use_energy_term and not test_particle:
        dek, payload = drag_energy(s, di.dt, a_drag, norm)
        dudt = drag_deposit(kern, spec, di.ids_d, N, di.r, di.sc, di.ptype,
                            payload.repeat(di.n_rep), dek)
    return DragResult(a_drag=a_drag, dudt=dudt, sound=sound,
                      div_v=div_v), di.overflow
