"""Star-gas gravity (K16), and direct-sum grad-h SPH self-gravity, the
oracle of the tree.

``star_gas_forces`` is the counterpart of
``gandalf_tpu/ops/sph_gravity.py:star_gas_forces``: the mean-h softened
pull between every gas particle and every star or sink slot, both ways,
in 1-3 dims.
It launches K16 (``csrc/star_gas.cu``) on CUDA tensors and runs its plain
version ``star_gas_forces_plain`` on CPU tensors.

``direct_sph_gravity`` is the torch twin of
``gandalf_tpu/ops/sph_gravity.py:direct_sph_gravity``:
the symmetric kernel-softened pair force and potential with the
zeta*hfactor terms over all pairs, which beyond kernel support is the
Newtonian sum; in a periodic box, over min-image pairs, each plus its
Ewald correction.  Chunked over targets, so that it takes any N; used
by the tests and by ``check.gravity_accuracy`` and
``check.periodic_gravity_accuracy``, never by the simulation.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _ext
from .ewald import ewald_correction
from .mfv import _dist2

Tensor = torch.Tensor

# pairs per chunk of gas rows in the plain version of K16
_CHUNK_PAIRS = 1 << 22


def star_gas_forces(kern, r_gas: Tensor, m_gas: Tensor, h_gas: Tensor,
                    r_star: Tensor, m_star: Tensor, h_star: Tensor,
                    star_active: Tensor):
    """Symmetric star-gas kernel-softened gravity with mean-h softening
    (the reference's GradhSph::ComputeStarGravForces, GradhSph.cpp:699).
    Returns (a_gas (N, ndim), gpot_gas (N,), a_star (Ns, ndim), gpot_star
    (Ns,)) for r_gas (N, ndim) and r_star (Ns, ndim), ndim 1-3 (the
    softened wgrav and wpot carry no ndim normalisation): an inactive
    slot pulls no gas (and its own rows are meaningless); the star side
    sums every gas particle with its mass.  K16 on CUDA tensors, with
    `kern` M4 or the quintic, direct or tabulated (the gaussian is
    refused: fault F23)."""
    if r_gas.is_cuda:
        return _ext.star_gas_forces(
            r_gas.contiguous(), m_gas.contiguous(), h_gas.contiguous(),
            r_star.contiguous(), m_star.contiguous(), h_star.contiguous(),
            star_active.contiguous(), kern=kern)
    return star_gas_forces_plain(kern, r_gas, m_gas, h_gas, r_star, m_star,
                                 h_star, star_active)


def star_gas_forces_plain(kern, r_gas, m_gas, h_gas, r_star, m_star,
                          h_star, star_active):
    """Plain version of K16: the JAX formula over chunks of gas rows, in
    1-3 dims.  A coincident pair (d^2 = 0) takes |dr| = 1 and unit 0, as
    there; d^2 is summed in K16's order (_dist2)."""
    N = r_gas.shape[0]
    Ns = r_star.shape[0]
    act = torch.where(star_active, 1.0, 0.0).to(r_gas.dtype)
    step = max(1, _CHUNK_PAIRS // max(Ns, 1))
    a_gas, gpot_gas = [], []
    a_star = torch.zeros_like(r_star)
    gpot_star = torch.zeros_like(m_star)
    for c0 in range(0, N, step):
        c1 = min(N, c0 + step)
        dr = r_star[None, :, :] - r_gas[c0:c1, None, :]
        drsqd = _dist2(dr)
        zero = drsqd == 0.0
        drmag = torch.sqrt(torch.where(zero, 1.0, drsqd))
        inv_drmag = torch.where(zero, 0.0, 1.0 / drmag)
        unit = dr * inv_drmag[..., None]
        invh = 1.0 / (0.5 * (h_gas[c0:c1, None] + h_star[None, :]))
        s = drmag * invh
        wg = kern.wgrav(s) * invh * invh
        wp = kern.wpot(s) * invh
        a_gas.append(torch.sum((m_star[None, :] * wg * act[None, :])
                               [..., None] * unit, dim=1))
        gpot_gas.append(torch.sum(m_star[None, :] * wp * act[None, :],
                                  dim=1))
        mg = m_gas[c0:c1, None]
        a_star = a_star + torch.sum((mg * wg)[..., None] * unit, dim=0)
        gpot_star = gpot_star + torch.sum(mg * wp, dim=0)
    a_gas = torch.cat(a_gas) if a_gas else torch.zeros_like(r_gas)
    gpot_gas = torch.cat(gpot_gas) if gpot_gas else torch.zeros_like(m_gas)
    return a_gas, gpot_gas, -a_star, gpot_star


def direct_sph_gravity(kern, r: Tensor, m: Tensor,
                       h: Optional[Tensor] = None,
                       zeta: Optional[Tensor] = None,
                       hfactor: Optional[Tensor] = None,
                       targets: Optional[Tensor] = None,
                       box=None, ewald_table=None):
    """(a (T, ndim), gpot (T,)) at `targets` (particle indices, default
    all) from every particle, r (N, ndim) in 1-3 dims.  Without `h` the
    pairs are Newtonian.  A pair counts when it is not the target itself and d > 0.  With a `box`
    (a state.DomainBox) each separation is min-imaged along its periodic
    dims, and with an `ewald_table` (ops.ewald.EwaldTable) each pair
    adds m_j times the table's correction at it."""
    N, dev = r.shape[0], r.device
    if targets is None:
        targets = torch.arange(N, device=dev)
    targets = targets.to(device=dev, dtype=torch.int64)
    zh = None
    if h is not None:
        zh = zeta * hfactor if zeta is not None else torch.zeros_like(h)
    budget = 1 << 22 if dev.type == "cuda" else 1 << 20
    B = max(1, budget // max(N, 1))
    src = torch.arange(N, device=dev)
    a_out, p_out = [], []
    for t0 in range(0, targets.numel(), B):
        t = targets[t0:t0 + B]
        dr = [r[None, :, k] - r[t, k][:, None] for k in range(r.shape[1])]
        if box is not None:
            dr = list(box.min_image(torch.stack(dr, -1)).unbind(-1))
        d2 = dr[0] * dr[0]
        for x in dr[1:]:
            d2 = d2 + x * x
        use = (src[None, :] != t[:, None]) & (d2 > 0.0)
        m_j = torch.where(use, m[None, :], 0.0)
        d = torch.sqrt(torch.where(use, d2, 1.0))
        if h is None:
            coef = m_j / (d * d * d)
            pot = m_j / d
        else:
            invh_i, invh_j = 1.0 / h[t][:, None], 1.0 / h[None, :]
            s_i, s_j = d * invh_i, d * invh_j
            paux = 0.5 * (invh_i * invh_i * kern.wgrav(s_i)
                          + zh[t][:, None] * kern.w1(s_i)
                          + invh_j * invh_j * kern.wgrav(s_j)
                          + zh[None, :] * kern.w1(s_j))
            gaux = 0.5 * (invh_i * kern.wpot(s_i) + invh_j * kern.wpot(s_j))
            coef = m_j * paux / d
            pot = m_j * gaux
        a_t = torch.stack([(coef * x).sum(1) for x in dr], -1)
        p_t = pot.sum(1)
        if ewald_table is not None:
            e_a, e_p = ewald_correction(ewald_table, torch.stack(dr, -1))
            a_t = a_t + (m_j[..., None] * e_a).sum(1)
            p_t = p_t + (m_j * e_p).sum(1)
        a_out.append(a_t)
        p_out.append(p_t)
    return torch.cat(a_out), torch.cat(p_out)
