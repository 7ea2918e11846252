"""Exact Riemann solver for the 1D Euler equations (Toro 1999, ch. 4).

A copy of ``gandalf_tpu/analysis/riemann.py`` (numpy only, on the host):
the analytic shocktube solution that the Sod tube's L1 gate compares
with (the reference exposes its C++ ExactRiemannSolver/ShocktubeSolution
to Python for the same purpose -- src/Headers/RiemannSolver.h:421,
src/Hydrodynamics/RiemannSolver.cpp:135-430).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _pressure_function(p: float, pk: float, dk: float, ck: float,
                       gamma: float):
    """f_K(p) and df_K/dp for the pressure iteration (Toro eq. 4.6/4.7)."""
    if p > pk:  # shock
        ak = 2.0 / ((gamma + 1.0) * dk)
        bk = (gamma - 1.0) / (gamma + 1.0) * pk
        sq = np.sqrt(ak / (p + bk))
        f = (p - pk) * sq
        fp = sq * (1.0 - 0.5 * (p - pk) / (p + bk))
    else:  # rarefaction
        f = 2.0 * ck / (gamma - 1.0) * ((p / pk) ** ((gamma - 1.0) /
                                                     (2.0 * gamma)) - 1.0)
        fp = (p / pk) ** (-(gamma + 1.0) / (2.0 * gamma)) / (dk * ck)
    return f, fp


def star_region(dl, ul, pl, dr, ur, pr, gamma, tol=1e-12, max_iter=100):
    """(p*, u*) via Newton iteration with adaptive initial guess
    (Toro's GUESSP; ExactRiemannSolver::ComputeStarRegion)."""
    cl = np.sqrt(gamma * pl / dl)
    cr = np.sqrt(gamma * pr / dr)
    # vacuum check
    if 2.0 / (gamma - 1.0) * (cl + cr) <= ur - ul:
        return 0.0, 0.0
    # PVRS guess
    cup = 0.25 * (dl + dr) * (cl + cr)
    ppv = max(0.5 * (pl + pr) + 0.5 * (ul - ur) * cup, 0.0)
    pmin, pmax = min(pl, pr), max(pl, pr)
    if pmax / pmin <= 2.0 and pmin <= ppv <= pmax:
        p = ppv
    elif ppv < pmin:  # two-rarefaction
        g1 = (gamma - 1.0) / (2.0 * gamma)
        pq = (pl / pr) ** g1
        um = (pq * ul / cl + ur / cr
              + 2.0 / (gamma - 1.0) * (pq - 1.0)) / (pq / cl + 1.0 / cr)
        ptl = 1.0 + (gamma - 1.0) / 2.0 * (ul - um) / cl
        ptr = 1.0 + (gamma - 1.0) / 2.0 * (um - ur) / cr
        p = 0.5 * (pl * ptl ** (1.0 / g1) + pr * ptr ** (1.0 / g1))
    else:  # two-shock
        gel = np.sqrt((2.0 / ((gamma + 1.0) * dl))
                      / ((gamma - 1.0) / (gamma + 1.0) * pl + ppv))
        ger = np.sqrt((2.0 / ((gamma + 1.0) * dr))
                      / ((gamma - 1.0) / (gamma + 1.0) * pr + ppv))
        p = (gel * pl + ger * pr - (ur - ul)) / (gel + ger)
    p = max(p, 1e-30)

    for _ in range(max_iter):
        fl, flp = _pressure_function(p, pl, dl, cl, gamma)
        fr, frp = _pressure_function(p, pr, dr, cr, gamma)
        pold = p
        p = p - (fl + fr + ur - ul) / (flp + frp)
        if p < 1e-30:
            p = 1e-30
        elif 2.0 * abs(p - pold) / (p + pold) < tol:
            break
    fl, _ = _pressure_function(p, pl, dl, cl, gamma)
    fr, _ = _pressure_function(p, pr, dr, cr, gamma)
    u = 0.5 * (ul + ur) + 0.5 * (fr - fl)
    return p, u


def sample(xi: np.ndarray, dl, ul, pl, dr, ur, pr, gamma
           ) -> Dict[str, np.ndarray]:
    """Sample the self-similar solution at speeds xi = x/t (Toro's SAMPLE)."""
    cl = np.sqrt(gamma * pl / dl)
    cr = np.sqrt(gamma * pr / dr)
    pstar, ustar = star_region(dl, ul, pl, dr, ur, pr, gamma)

    d = np.empty_like(xi)
    u = np.empty_like(xi)
    p = np.empty_like(xi)
    g7 = (gamma - 1.0) / 2.0

    left = xi <= ustar
    # --- left side -----------------------------------------------------------
    if pstar <= pl:  # left rarefaction
        shl = ul - cl
        cml = cl * (pstar / pl) ** ((gamma - 1.0) / (2.0 * gamma))
        stl = ustar - cml
        in_l = left & (xi <= shl)
        in_fan = left & (xi > shl) & (xi < stl)
        in_star = left & (xi >= stl)
        d[in_l], u[in_l], p[in_l] = dl, ul, pl
        cfan = (2.0 / (gamma + 1.0)) * (cl + g7 * (ul - xi[in_fan]))
        u[in_fan] = (2.0 / (gamma + 1.0)) * (cl + g7 * ul + xi[in_fan])
        d[in_fan] = dl * (cfan / cl) ** (2.0 / (gamma - 1.0))
        p[in_fan] = pl * (cfan / cl) ** (2.0 * gamma / (gamma - 1.0))
        d[in_star] = dl * (pstar / pl) ** (1.0 / gamma)
        u[in_star], p[in_star] = ustar, pstar
    else:  # left shock
        sl = ul - cl * np.sqrt((gamma + 1.0) / (2.0 * gamma) * pstar / pl
                               + (gamma - 1.0) / (2.0 * gamma))
        in_l = left & (xi <= sl)
        in_star = left & (xi > sl)
        d[in_l], u[in_l], p[in_l] = dl, ul, pl
        ratio = pstar / pl
        g6 = (gamma - 1.0) / (gamma + 1.0)
        d[in_star] = dl * (ratio + g6) / (g6 * ratio + 1.0)
        u[in_star], p[in_star] = ustar, pstar

    right = ~left
    # --- right side ----------------------------------------------------------
    if pstar <= pr:  # right rarefaction
        shr = ur + cr
        cmr = cr * (pstar / pr) ** ((gamma - 1.0) / (2.0 * gamma))
        str_ = ustar + cmr
        in_r = right & (xi >= shr)
        in_fan = right & (xi < shr) & (xi > str_)
        in_star = right & (xi <= str_)
        d[in_r], u[in_r], p[in_r] = dr, ur, pr
        cfan = (2.0 / (gamma + 1.0)) * (cr - g7 * (ur - xi[in_fan]))
        u[in_fan] = (2.0 / (gamma + 1.0)) * (-cr + g7 * ur + xi[in_fan])
        d[in_fan] = dr * (cfan / cr) ** (2.0 / (gamma - 1.0))
        p[in_fan] = pr * (cfan / cr) ** (2.0 * gamma / (gamma - 1.0))
        d[in_star] = dr * (pstar / pr) ** (1.0 / gamma)
        u[in_star], p[in_star] = ustar, pstar
    else:  # right shock
        sr = ur + cr * np.sqrt((gamma + 1.0) / (2.0 * gamma) * pstar / pr
                               + (gamma - 1.0) / (2.0 * gamma))
        in_r = right & (xi >= sr)
        in_star = right & (xi < sr)
        d[in_r], u[in_r], p[in_r] = dr, ur, pr
        ratio = pstar / pr
        g6 = (gamma - 1.0) / (gamma + 1.0)
        d[in_star] = dr * (ratio + g6) / (g6 * ratio + 1.0)
        u[in_star], p[in_star] = ustar, pstar

    return {"rho": d, "vx": u, "pressure": p,
            "u": p / ((gamma - 1.0) * d)}


def shocktube_solution(dl, ul, pl, dr, ur, pr, gamma,
                       xl: float, x0: float, xr: float, t: float,
                       n: int = 16384) -> Dict[str, np.ndarray]:
    """Exact shocktube profile at time t on n points across [xl, xr]
    (analogue of ShocktubeSolution::ComputeShocktubeSolution)."""
    x = np.linspace(xl, xr, n)
    if t <= 0.0:
        left = x <= x0
        out = {
            "rho": np.where(left, dl, dr),
            "vx": np.where(left, ul, ur),
            "pressure": np.where(left, pl, pr),
        }
        out["u"] = out["pressure"] / ((gamma - 1.0) * out["rho"])
    else:
        out = sample((x - x0) / t, dl, ul, pl, dr, ur, pr, gamma)
    out["x"] = x
    return out
