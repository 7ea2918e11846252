"""Saitoh & Makino (2012) density-independent SPH on the structured grid:
the h-rho iteration with the smoothed energy density q (K25) and the
pressure-energy forces (K26).

Counterpart of ``gandalf_tpu/ops/sm2012.py`` (GANDALF's SM2012Sph,
src/SM2013/SM2012Sph.cpp).  The pressure force is built from the
smoothed internal-energy density q_i = h_i^-ndim sum_j m_j u_j
W(r_ij, h_i) instead of rho, which removes the spurious surface tension
at contact discontinuities:

  paux    = (gamma-1)/2 u_i u_j (1/q_i + 1/q_j) (w1_i hfac_i + w1_j hfac_j)
  a_i    += m_j paux r_hat
  dudt_i += (gamma-1)/2 u_i/q_i sum_j m_j u_j dvdr (w1_i hfac_i + w1_j hfac_j)

plus mon97 viscosity (fixed or per-particle alpha) on approaching pairs.
The h iteration is the plain h-rho fixed point of ``ops/density.py``
(no grad-h Omega or zeta: invomega = 1, zeta = 0), from each particle's
own h with the bracket [0, hmax], and q is summed at the h that the
iteration's last rho gives, h_fac (m/rho)^(1/ndim).  Pressure and sound
speed are always the adiabatic (gamma-1) rho u and sqrt(gamma (gamma-1)
u), whatever the EOS, as in the JAX package.

``sm2012_hydro_pass_grid`` is the controller's pass.  It bins the alive
particles (K1, the dead binned out) into K1's dense slot map and runs
K25 and K26 over the 3^ndim cells around each slot, as K21-K23 do; the
JAX package gathers an (N, 3^ndim K) candidate block instead
(``gather_active_candidates``).  Each kernel has a plain PyTorch version
here (the JAX package's candidate gather and view formulas, over chunks
of rows, with d^2 summed in the CUDA kernels' order) and a CUDA C++
kernel in ``csrc/sm2012.cu``, launched through ``_ext``; both take any
smoothing kernel of the family (M4, the quintic, the gaussian, direct
or tabulated: W in its s^2 form for the h-rho iteration and q, W' in
its s form for the forces).  A CPU tensor takes the plain version; a
CUDA tensor takes the kernel, or the wrapper raises.

``sm2012_density_pairs`` and ``sm2012_forces_pairs`` are the JAX
package's all-pairs forms, kept as torch oracles for the tests only
(ROADMAP's "Not to port" rule for brute-force paths).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import _ext
from ..state import SphState
from . import sph_grid27 as g27
from .active_grid import _compact_columns, _row_chunk, dense_ids
from .active_grid import gather_active_candidates
from .density import compute_h, iterate_h
from .forces import AVISC_MON97MM97, AVISC_NONE
from .mfv import _dist2

Tensor = torch.Tensor

# columns of the packed per-particle scalars handed to K26
SM_SCALARS = ("m", "u", "h", "rho", "q", "hfactor", "sound", "alpha")


class Sm2012Density(NamedTuple):
    h: Tensor
    rho: Tensor
    q: Tensor          # smoothed internal-energy density
    hfactor: Tensor    # 1/h^(ndim+1)


class Sm2012Forces(NamedTuple):
    a: Tensor
    dudt: Tensor
    div_v: Tensor


# ---------------------------------------------------------------------------
# The all-pairs oracles
# ---------------------------------------------------------------------------

def sm2012_density_pairs(kern, box, h_fac: float, h_converge: float,
                         r: Tensor, m: Tensor, u: Tensor, h_init: Tensor,
                         r_ext: Tensor, m_ext: Tensor, u_ext: Tensor,
                         active: Optional[Tensor] = None) -> Sm2012Density:
    """The h-rho iteration over every pair, then the q sum at the final h
    (gandalf_tpu's sm2012_density)."""
    nd = box.ndim
    dr = box.min_image(r_ext[None, :, :] - r[:, None, :])
    drsqd = torch.sum(dr * dr, dim=-1)
    dens = compute_h(kern, nd, h_fac, h_converge, m, h_init, drsqd,
                     m_ext[None, :].expand_as(drsqd), active=active)
    invh = 1.0 / dens.h
    w0 = kern.w0_s2(drsqd * (invh * invh)[:, None])
    q = (invh ** nd) * torch.sum((m_ext * u_ext)[None, :] * w0, dim=-1)
    return Sm2012Density(h=dens.h, rho=dens.rho, q=q,
                         hfactor=invh ** (nd + 1))


def sm2012_forces_pairs(kern, visc, gamma: float, box, v, u, h, rho, q,
                        hfactor, sound, alpha, r, r_ext, v_ext, m_ext,
                        u_ext, h_ext, rho_ext, q_ext, hfactor_ext,
                        sound_ext, alpha_ext) -> Sm2012Forces:
    """The SM2012 force over every pair (gandalf_tpu's sm2012_forces): the
    view formulas with each row's neighbours the whole extended set."""
    n, M = r.shape[0], r_ext.shape[0]
    dr = box.min_image(r_ext[None, :, :] - r[:, None, :])

    def row(x):
        return x[None].expand((n,) + tuple(x.shape))

    nb = {"v": row(v_ext), "m": row(m_ext), "u": row(u_ext),
          "h": row(h_ext), "rho": row(rho_ext), "q": row(q_ext),
          "hfactor": row(hfactor_ext), "sound": row(sound_ext),
          "alpha": row(alpha_ext)}
    mask = torch.ones((n, M), dtype=torch.bool, device=r.device)
    return sm2012_forces_view(kern, visc, gamma, v, u, h, rho, q, hfactor,
                              sound, alpha, dr, nb, mask)


# ---------------------------------------------------------------------------
# The force body over a per-row neighbour view
# ---------------------------------------------------------------------------

def sm2012_forces_view(kern, visc, gamma: float, v: Tensor, u: Tensor,
                       h: Tensor, rho: Tensor, q: Tensor, hfactor: Tensor,
                       sound: Tensor, alpha: Tensor, dr: Tensor, nb: dict,
                       mask: Optional[Tensor]) -> Sm2012Forces:
    """SM2012 hydro force over a per-row neighbour view (n, c): dr is
    r_j - r_i (n, c, ndim), nb holds v (n, c, ndim) and m, u, h, rho, q,
    hfactor, sound, alpha (n, c) (gandalf_tpu's sm2012_forces_view).  A
    pair counts where `mask` holds and d^2 > 0, which drops each row's
    own column and coincident particles.  d^2 is summed in the CUDA
    kernels' order (_dist2)."""
    drsqd = _dist2(dr)
    valid = drsqd > 0.0
    if mask is not None:
        valid = valid & mask
    drmag = torch.sqrt(torch.where(valid, drsqd, 1.0))
    unit = torch.where(valid[..., None], dr / drmag[..., None], 0.0)

    invh_i = (1.0 / h)[:, None]
    h_j = torch.where(valid, nb["h"], 1.0)
    wkerni = torch.where(valid, hfactor[:, None] * kern.w1(drmag * invh_i),
                         0.0)
    wkernj = torch.where(valid, nb["hfactor"] * kern.w1(drmag / h_j), 0.0)

    dv = nb["v"] - v[:, None, :]
    dvdr = torch.sum(dv * unit, dim=-1)
    m_j = torch.where(valid, nb["m"], 0.0)
    div_v = (-torch.sum(m_j * dvdr * wkerni, dim=-1)
             / torch.clamp_min(rho, 1e-30))

    invq_i = (1.0 / torch.clamp_min(q, 1e-30))[:, None]
    invq_j = 1.0 / torch.clamp_min(nb["q"], 1e-30)
    u_j = torch.where(valid, nb["u"], 0.0)
    paux = (0.5 * (gamma - 1.0) * u[:, None] * u_j * (invq_i + invq_j)
            * (wkerni + wkernj))
    dudt = (0.5 * (gamma - 1.0) * u * (1.0 / torch.clamp_min(q, 1e-30))
            * torch.sum(m_j * u_j * dvdr * (wkerni + wkernj), dim=-1))

    if visc.avisc != AVISC_NONE:
        invrho_i = (1.0 / torch.clamp_min(rho, 1e-30))[:, None]
        invrho_j = 1.0 / torch.clamp_min(nb["rho"], 1e-30)
        winvrho = 0.25 * (wkerni + wkernj) * (invrho_i + invrho_j)
        if visc.avisc == AVISC_MON97MM97:
            alpha_eff = 0.5 * (alpha[:, None] + nb["alpha"])
        else:
            alpha_eff = visc.alpha_visc
        vsignal = (sound[:, None] + nb["sound"]
                   - visc.beta_visc * alpha_eff * dvdr)
        approach = valid & (dvdr < 0.0)
        paux = paux - torch.where(approach,
                                  alpha_eff * vsignal * dvdr * winvrho, 0.0)
        dudt = dudt - torch.sum(
            torch.where(approach, 0.5 * m_j * alpha_eff * vsignal * dvdr
                        * dvdr * winvrho, 0.0), dim=-1)

    a = torch.sum((m_j * paux)[..., None] * unit, dim=-2)
    return Sm2012Forces(a=a, dudt=dudt, div_v=div_v)


# ---------------------------------------------------------------------------
# Slotted targets of the plain versions
# ---------------------------------------------------------------------------

def _slotted(spec: g27.Grid27Spec, ids_d: Tensor, N: int):
    """The particles with a slot in K1's slot map, in slot order, and a
    cell id per particle (N,) int32 that holds their cells."""
    flat = ids_d.reshape(-1).long()
    slot = torch.nonzero(flat >= 0).flatten()
    p = flat[slot]
    cell_of = torch.zeros((N,), dtype=torch.int32, device=ids_d.device)
    cell_of[p] = (slot // spec.k_cell).to(torch.int32)
    return p, cell_of


# ---------------------------------------------------------------------------
# K25: the h-rho iteration and the q sum
# ---------------------------------------------------------------------------

def sm2012_density(kern, spec: g27.Grid27Spec, h_fac: float,
                   h_converge: float, hmax: float, ids_d: Tensor, r: Tensor,
                   m: Tensor, u: Tensor, h: Tensor):
    """h, rho, q, hfactor and the converged flag (N,) of every particle
    with a slot in K1's slot map ids_d (*ncells, K) int32 (-1 empty),
    over the particles of the map; a particle without a slot keeps its h
    and takes rho = q = hfactor = 0, converged.  K25 on CUDA tensors."""
    if r.is_cuda:
        return _ext.sm2012_density(spec, kern, h_fac, h_converge, hmax,
                                   ids_d, r, m, u, h)
    return sm2012_density_plain(kern, spec, h_fac, h_converge, hmax, ids_d,
                                r, m, u, h)


def sm2012_density_plain(kern, spec, h_fac, h_converge, hmax, ids_d, r, m,
                         u, h):
    """Plain version of K25: gandalf_tpu's candidate gather, compute_h
    (from the rows' own h, bracket [0, hmax]) and the q sum at its final
    h, over chunks of the slotted particles.  The iteration runs on the
    candidates within kernrange times a bound on h (the rows' largest h
    or hmax): every term beyond is exactly zero.  A chunk in which some
    row's h passes the bound (a fixed-point step can) is redone on all
    its candidates."""
    N, nd = r.shape[0], spec.ndim
    p_all, cell_of = _slotted(spec, ids_d, N)
    h_out, rho_out = h.clone(), torch.zeros_like(h)
    q_out, hfac_out = torch.zeros_like(h), torch.zeros_like(h)
    done_out = torch.ones((N,), dtype=torch.bool, device=r.device)
    step = _row_chunk(3 ** nd * spec.k_cell, r.device)
    for c0 in range(0, p_all.numel(), step):
        sel = p_all[c0:c0 + step]
        cand, dr = gather_active_candidates(spec, cell_of, ids_d, r, sel)
        mask = cand >= 0
        cid = torch.clamp_min(cand, 0)
        m_j = torch.where(mask, m[cid], 0.0)
        u_j = torch.where(mask, u[cid], 0.0)
        d2 = _dist2(dr)
        h_bound = max(float(h[sel].max()), hmax)
        near = mask & (d2 <= (kern.kernrange * h_bound) ** 2
                       * (1.0 + 1e-6))
        args = _compact_columns(near, d2, m_j)
        sums = iterate_h(kern, nd, h_fac, h_converge, m[sel], h[sel],
                         args[1], args[2], args[0], hmax)
        if float(sums[4]) > h_bound:
            sums = iterate_h(kern, nd, h_fac, h_converge, m[sel], h[sel],
                             d2, m_j, mask, hmax)
        rho, done = sums[0], sums[3]
        h_new = torch.clamp_min(
            h_fac * (m[sel] / torch.clamp_min(rho, 1e-300)) ** (1.0 / nd),
            0.0)
        invh = 1.0 / h_new
        w0 = torch.where(mask, kern.w0_s2(d2 * (invh * invh)[:, None]), 0.0)
        q = (invh ** nd) * torch.sum(m_j * u_j * w0, dim=-1)
        h_out[sel], rho_out[sel], q_out[sel] = h_new, rho, q
        hfac_out[sel] = invh ** (nd + 1)
        done_out[sel] = done
    return h_out, rho_out, q_out, hfac_out, done_out


# ---------------------------------------------------------------------------
# K26: the pressure-energy forces
# ---------------------------------------------------------------------------

def sm2012_forces(kern, visc, gamma: float, spec: g27.Grid27Spec,
                  ids_d: Tensor, r: Tensor, v: Tensor, packed: Tensor):
    """a (N, ndim), du/dt and div v (N,) of every particle with a slot in
    K1's slot map ids_d, over the particles of the map; zero for a
    particle without a slot.  `packed` (N, 8) holds SM_SCALARS per
    particle.  K26 on CUDA tensors."""
    if r.is_cuda:
        return _ext.sm2012_forces(spec, kern, visc, gamma, ids_d, r, v,
                                  packed)
    return sm2012_forces_plain(kern, visc, gamma, spec, ids_d, r, v, packed)


def sm2012_forces_plain(kern, visc, gamma, spec, ids_d, r, v, packed):
    """Plain version of K26: gandalf_tpu's candidate gather and
    sm2012_forces_view over chunks of the slotted particles, on the
    candidates within kernrange max(h_i, h_j) (beyond, both kernel
    gradients of a pair vanish and every term is exactly zero)."""
    N, nd = r.shape[0], spec.ndim
    col = {k: i for i, k in enumerate(SM_SCALARS)}
    p_all, cell_of = _slotted(spec, ids_d, N)
    a = torch.zeros((N, nd), dtype=r.dtype, device=r.device)
    dudt, div_v = torch.zeros_like(packed[:, 0]), torch.zeros_like(
        packed[:, 0])
    step = _row_chunk(3 ** nd * spec.k_cell, r.device)
    for c0 in range(0, p_all.numel(), step):
        sel = p_all[c0:c0 + step]
        cand, dr = gather_active_candidates(spec, cell_of, ids_d, r, sel)
        mask = cand >= 0
        cid = torch.clamp_min(cand, 0)
        h_i = packed[sel, col["h"]]
        h_j = torch.where(mask, packed[cid, col["h"]], 1.0)
        d2 = _dist2(dr)
        rad = kern.kernrange * torch.maximum(h_i[:, None], h_j)
        within = mask & (d2 <= rad * rad * (1.0 + 1e-6))
        mask, cid, dr = _compact_columns(within, cid, dr)
        pj, pi = packed[cid], packed[sel]

        def nbr(key, empty):
            return torch.where(mask, pj[..., col[key]], empty)

        nb = {"v": torch.where(mask[..., None], v[cid], 0.0),
              "m": nbr("m", 0.0), "u": nbr("u", 0.0), "h": nbr("h", 1.0),
              "rho": nbr("rho", 1.0), "q": nbr("q", 1.0),
              "hfactor": nbr("hfactor", 0.0), "sound": nbr("sound", 0.0),
              "alpha": nbr("alpha", 0.0)}
        f = sm2012_forces_view(
            kern, visc, gamma, v[sel], pi[:, col["u"]], pi[:, col["h"]],
            pi[:, col["rho"]], pi[:, col["q"]], pi[:, col["hfactor"]],
            pi[:, col["sound"]], pi[:, col["alpha"]], dr, nb, mask)
        a[sel], dudt[sel], div_v[sel] = f.a, f.dudt, f.div_v
    return a, dudt, div_v


# ---------------------------------------------------------------------------
# The hydro pass
# ---------------------------------------------------------------------------

def sm2012_hydro_pass_grid(kern, visc, gamma: float, spec: g27.Grid27Spec,
                           h_fac: float, h_converge: float, s: SphState,
                           alive: Optional[Tensor], hydro_forces: bool):
    """The structured-grid SM2012 pass (gandalf_tpu's
    sm2012_hydro_pass_grid, :184-251): K1 of the alive particles, K25,
    pressure and sound speed, then K26 over the same slot map.  `alive`
    (N,) bool, or None where every particle is alive; the dead come back
    with h = rho = invomega = 1, zeros and their u.  Returns (state, q).
    The overflow flag (a cell held more than K particles, an alive
    particle did not converge or its h passed 0.99 hmax) ORs into the
    state's."""
    if spec.mirror or spec.qz != 1:
        raise NotImplementedError(
            "the SM2012 pass takes no mirror layers or z-slab plans "
            "(ROADMAP queue 1, items 8 and 13)")
    live = (torch.ones((s.N,), dtype=torch.bool, device=s.r.device)
            if alive is None else alive)
    b = g27.bin_particles(spec, s.r, None if alive is None else ~alive)
    hmax = g27.hmax_of(spec, kern.kernrange)
    ids_d = dense_ids(spec, b)
    h, rho, q, hfactor, done = sm2012_density(
        kern, spec, h_fac, h_converge, hmax, ids_d, s.r, s.m, s.u, s.h)
    overflow = b.overflow | torch.any(live & ~done) | torch.any(
        torch.where(live, h, 0.0) > 0.99 * hmax)

    def sane(x, d):
        return torch.where(live if x.dim() == 1 else live[:, None], x, d)

    pressure = (gamma - 1.0) * torch.clamp_min(rho, 1e-30) * s.u
    sound = torch.sqrt(gamma * (gamma - 1.0) * torch.clamp_min(s.u, 1e-30))
    s = s.replace(h=sane(h, 1.0), rho=sane(rho, 1.0),
                  pressure=sane(pressure, 0.0), sound=sane(sound, 0.0),
                  hfactor=sane(hfactor, 0.0),
                  invomega=torch.ones_like(s.invomega),
                  zeta=torch.zeros_like(s.zeta),
                  neib_overflow=s.neib_overflow | overflow)
    if not hydro_forces:
        return s.replace(a=torch.zeros_like(s.a),
                         dudt=torch.zeros_like(s.dudt),
                         div_v=torch.zeros_like(s.div_v)), q
    packed = torch.stack([s.m, s.u, s.h, s.rho, sane(q, 1.0), s.hfactor,
                          s.sound, s.alpha], dim=-1)
    a, dudt, div_v = sm2012_forces(kern, visc, gamma, spec, ids_d, s.r, s.v,
                                   packed)
    return s.replace(a=sane(a, 0.0), dudt=sane(dudt, 0.0),
                     div_v=sane(div_v, 0.0)), q
