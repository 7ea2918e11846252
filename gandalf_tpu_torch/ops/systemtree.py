"""N-body sub-system detection (NbodySystemTree,
src/Nbody/NbodySystemTree.cpp:116-520).

The port's copy of ``gandalf_tpu/ops/systemtree.py``, unchanged: host-side
numpy, as there.  The reference rebuilds its nearest-neighbour
agglomerative tree every `nsystembuildstep` steps on the host too, and
sub-systems hold at most Ncompmax stars, so this is NOT device code.

- `create_system_tree`: repeatedly merge MUTUAL nearest-neighbour pairs of
  free nodes into parents until one root remains (CreateNbodySystemTree).
- `build_subsystems`: bottom-up walk marking the largest nodes with
  Ncomp <= Ncompmax whose gravitational potential energy is dominated by
  the internal pair energy, |gpe - gpe_internal| < gpefrac * gpe
  (BuildSubSystems:256-420) — bound, isolated binaries/triples/quadruples.
- `orbital_elements`: semi-major axis / eccentricity / period of a bound
  pair (the reference's binary diagnostics).

- `integrate_internal_motion`: adaptive few-body Hermite P(EC)^2 over a
  sub-system's COM-frame coordinates with perturber tidal forces — the
  analogue of Nbody::IntegrateInternalMotion (Nbody.cpp:481-720); the COM
  is advanced by the global integrator with members collapsed onto it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class SubSystem:
    members: Tuple[int, ...]       # star indices
    r_com: np.ndarray
    v_com: np.ndarray
    m: float
    gpe_internal: float
    ketot: float
    tcross: float

    @property
    def n(self) -> int:
        return len(self.members)

    @property
    def bound(self) -> bool:
        return self.ketot < self.gpe_internal


def create_system_tree(r: np.ndarray):
    """Agglomerative mutual-nearest-neighbour pairing.  Returns
    (children, members): children[p] = (c1, c2) for each internal node p
    (node ids >= Nstar), members[node] = tuple of star indices."""
    N = len(r)
    pos = {i: r[i].copy() for i in range(N)}
    members = {i: (i,) for i in range(N)}
    children = {}
    free = list(range(N))
    next_id = N
    while len(free) > 1:
        # nearest free node of every free node
        P = np.array([pos[i] for i in free])
        d2 = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        nearest = d2.argmin(axis=1)
        merged_any = False
        used = set()
        for ii in range(len(free)):
            jj = nearest[ii]
            if ii in used or jj in used:
                continue
            if nearest[jj] == ii and ii < jj:     # mutual pair
                a, b = free[ii], free[jj]
                children[next_id] = (a, b)
                members[next_id] = members[a] + members[b]
                ma, mb = len(members[a]), len(members[b])
                pos[next_id] = (pos[a] * ma + pos[b] * mb) / (ma + mb)
                used.update((ii, jj))
                merged_any = True
                next_id += 1
        if not merged_any:
            # degenerate chain: force-merge the globally closest pair
            ii, jj = np.unravel_index(d2.argmin(), d2.shape)
            a, b = free[ii], free[jj]
            children[next_id] = (a, b)
            members[next_id] = members[a] + members[b]
            pos[next_id] = 0.5 * (pos[a] + pos[b])
            used.update((ii, jj))
            next_id += 1
        free = [f for k, f in enumerate(free) if k not in used]
        free.extend(n for n in range(N, next_id) if n not in
                    {c for pair in children.values() for c in pair})
        free = sorted(set(free))
    return children, members


def build_subsystems(r: np.ndarray, v: np.ndarray, m: np.ndarray,
                     gpot: np.ndarray, Ncompmax: int = 4,
                     gpefrac: float = 1.0e-3) -> List[SubSystem]:
    """Identify bound, isolated sub-systems (BuildSubSystems).

    gpot: positive total potential |phi| per star (reference convention);
    a node qualifies when its stars' total gpe is internally dominated."""
    N = len(r)
    if N < 2:
        return []
    children, members = create_system_tree(r)
    out: List[SubSystem] = []
    claimed = set()
    # largest nodes first so a triple absorbs its inner binary
    for node in sorted(children, key=lambda n: -len(members[n])):
        mem = members[node]
        if len(mem) > Ncompmax or any(i in claimed for i in mem):
            continue
        idx = np.array(mem)
        gpe = 0.5 * float((m[idx] * gpot[idx]).sum())
        # internal pair energy
        dr = r[idx][:, None, :] - r[idx][None, :, :]
        d = np.sqrt((dr ** 2).sum(-1))
        np.fill_diagonal(d, np.inf)
        gpe_int = 0.5 * float((m[idx][:, None] * m[idx][None, :] / d).sum())
        if abs(gpe - gpe_int) >= gpefrac * abs(gpe):
            continue
        mtot = float(m[idx].sum())
        v_com = (m[idx][:, None] * v[idx]).sum(0) / mtot
        r_com = (m[idx][:, None] * r[idx]).sum(0) / mtot
        ketot = 0.5 * float((m[idx] * ((v[idx] - v_com) ** 2)
                             .sum(-1)).sum())
        vmean = np.sqrt(2.0 * ketot / mtot) if ketot > 0 else 1e-30
        tcross = np.sqrt(mtot * mtot / max(gpe_int, 1e-300)) / vmean
        out.append(SubSystem(members=tuple(mem), r_com=r_com, v_com=v_com,
                             m=mtot, gpe_internal=gpe_int, ketot=ketot,
                             tcross=tcross))
        claimed.update(mem)
    return out


def orbital_elements(r1, v1, m1, r2, v2, m2):
    """(a, e, period) of a two-body orbit, G = 1 (the reference's binary
    diagnostics; negative a = unbound)."""
    dr = np.asarray(r1) - np.asarray(r2)
    dv = np.asarray(v1) - np.asarray(v2)
    mu = m1 + m2
    d = np.linalg.norm(dr)
    v2rel = (dv ** 2).sum()
    eps = 0.5 * v2rel - mu / d                 # specific orbital energy
    a = -mu / (2.0 * eps) if eps != 0 else np.inf
    # eccentricity from the Laplace-Runge-Lenz vector (any ndim >= 2)
    hvec_sq = (dr ** 2).sum() * (dv ** 2).sum() - ((dr * dv).sum()) ** 2
    e2 = 1.0 + 2.0 * eps * hvec_sq / (mu * mu)
    e = np.sqrt(max(e2, 0.0))
    period = 2.0 * np.pi * np.sqrt(a ** 3 / mu) if a > 0 else np.inf
    return float(a), float(e), float(period)


# ---------------------------------------------------------------------------
# Internal sub-system integration (Nbody::IntegrateInternalMotion,
# src/Nbody/Nbody.cpp:481-720 + SystemParticle, src/Headers/Nbody.h:108)
# ---------------------------------------------------------------------------

def _few_body_forces(r, m, r_pert=None, m_pert=None, r_com=None):
    """Accel + jerk-ready pieces for <= Ncompmax bodies in COM-frame
    coordinates, plus the TIDAL field of external perturbers: the uniform
    part of the perturber force acts on the COM (it is already inside the
    globally-integrated COM trajectory), so only the residual
    a_pert(r_com + x) - a_pert(r_com) perturbs the internal motion
    (reference CalculatePerturberForces semantics)."""
    n = len(r)
    a = np.zeros_like(r)
    pot = np.zeros(n)
    for i in range(n):
        dr = r - r[i]
        d2 = (dr ** 2).sum(-1)
        d2[i] = 1.0
        inv = 1.0 / np.sqrt(d2)
        inv[i] = 0.0
        w = m * inv ** 3
        w[i] = 0.0
        a[i] = (w[:, None] * dr).sum(0)
        pot[i] = (m * inv).sum() - m[i] * inv[i]
    if r_pert is not None and len(r_pert):
        for i in range(n):
            dr_i = r_pert - (r_com + r[i])
            dr_c = r_pert - r_com
            inv_i = 1.0 / np.maximum(np.sqrt((dr_i ** 2).sum(-1)), 1e-30)
            inv_c = 1.0 / np.maximum(np.sqrt((dr_c ** 2).sum(-1)), 1e-30)
            a[i] += ((m_pert * inv_i ** 3)[:, None] * dr_i
                     - (m_pert * inv_c ** 3)[:, None] * dr_c).sum(0)
    return a, pot


def predict_cubic(traj, t):
    """Evaluate the cubic Hermite trajectory r(t) = r0 + v0 t + a0 t^2/2
    + adot0 t^3/6 (the reference's perturber prediction,
    NbodySystemTree.cpp:256-420 + Nbody.cpp perturber loops use the
    stored r0/v0/a0/adot0 of each perturber)."""
    r0, v0, a0, adot0 = traj
    return r0 + v0 * t + 0.5 * a0 * t * t + adot0 * (t ** 3) / 6.0


def integrate_internal_motion(rel_r, rel_v, m, dt_total,
                              nbody_mult: float = 0.1,
                              r_com=None, r_pert=None, m_pert=None,
                              pert_traj=None, com_traj=None,
                              max_steps: int = 200000):
    """Integrate the INTERNAL motion of one sub-system over the global
    step dt_total with an adaptive 4th-order Hermite P(EC)^2 scheme
    (host-side numpy: <= Ncompmax bodies, exactly like the reference's
    serial recursion, Nbody.cpp:481-720).

    rel_r/rel_v are COM-frame member coordinates; the COM itself is
    advanced by the GLOBAL integrator.  Perturber tidal forces:

    - with `pert_traj` = (r0, v0, a0, adot0) arrays from the START of the
      global step, perturber positions are PREDICTED along their cubic
      Hermite trajectories at each sub-step (the reference's
      CalculatePerturberForces uses the perturbers' stored derivatives);
      `com_traj` likewise predicts this system's own COM motion so the
      tidal residual is evaluated about the moving COM,
    - otherwise frozen `r_pert` end-of-step positions (leading order).

    Returns (rel_r, rel_v)."""
    r = np.array(rel_r, dtype=np.float64)
    v = np.array(rel_v, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)

    def forces(r, v, t_now):
        rp, rc = r_pert, r_com
        if pert_traj is not None:
            rp = predict_cubic(pert_traj, t_now)
        if com_traj is not None:
            rc = predict_cubic(com_traj, t_now)
        a, _ = _few_body_forces(r, m, rp, m_pert, rc)
        # jerk by direct formula
        n = len(r)
        adot = np.zeros_like(r)
        for i in range(n):
            dr = r - r[i]
            dv = v - v[i]
            d2 = (dr ** 2).sum(-1)
            d2[i] = 1.0
            inv = 1.0 / np.sqrt(d2)
            inv[i] = 0.0
            inv3 = inv ** 3
            drdv = (dr * dv).sum(-1)
            adot[i] = ((m * inv3)[:, None] * dv
                       - (3.0 * m * drdv * inv3 * inv ** 2)[:, None]
                       * dr).sum(0)
        return a, adot

    a, adot = forces(r, v, 0.0)
    t = 0.0
    steps = 0
    while t < dt_total and steps < max_steps:
        amag = np.sqrt((a ** 2).sum(-1))
        jmag = np.sqrt((adot ** 2).sum(-1))
        dt = nbody_mult * np.min(amag / np.maximum(jmag, 1e-30))
        dt = min(dt, dt_total - t)
        dt = max(dt, 1e-12 * dt_total)
        # predict
        r0, v0, a0, adot0 = r, v, a, adot
        r = r0 + v0 * dt + 0.5 * a0 * dt * dt + adot0 * dt ** 3 / 6.0
        v = v0 + a0 * dt + 0.5 * adot0 * dt * dt
        # P(EC)^2 Hermite corrector (NbodyHermite4::CorrectionTerms)
        for _ in range(2):
            a, adot = forces(r, v, t + dt)
            a2dot = (-6.0 * (a0 - a) - dt * (4.0 * adot0 + 2.0 * adot)) \
                / (dt * dt)
            a3dot = (12.0 * (a0 - a) + 6.0 * dt * (adot0 + adot)) \
                / (dt ** 3)
            v = v0 + 0.5 * dt * (a0 + a) - dt * dt * (adot - adot0) / 12.0
            r = r0 + 0.5 * dt * (v0 + v) - dt * dt * (a - a0) / 12.0
        t += dt
        steps += 1
    # re-centre: numerical COM drift stays out of the absolute coordinates
    M = m.sum()
    r -= (m[:, None] * r).sum(0) / M
    v -= (m[:, None] * v).sum(0) / M
    return r, v
