"""Direct-sum grad-h SPH self-gravity, the oracle of the tree.

Torch twin of ``gandalf_tpu/ops/sph_gravity.py:direct_sph_gravity``:
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

from .ewald import ewald_correction

Tensor = torch.Tensor


def direct_sph_gravity(kern, r: Tensor, m: Tensor,
                       h: Optional[Tensor] = None,
                       zeta: Optional[Tensor] = None,
                       hfactor: Optional[Tensor] = None,
                       targets: Optional[Tensor] = None,
                       box=None, ewald_table=None):
    """(a (T, 3), gpot (T,)) at `targets` (particle indices, default all)
    from every particle.  Without `h` the pairs are Newtonian.  A pair
    counts when it is not the target itself and d > 0.  With a `box`
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
        dr = [r[None, :, k] - r[t, k][:, None] for k in range(3)]
        if box is not None:
            dr = list(box.min_image(torch.stack(dr, -1)).unbind(-1))
        d2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
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
