"""Initial-condition generators of the port's configurations.

A copy of the generators of ``gandalf_tpu/sim/ic.py`` that the port's
slices use: the hydro tests of GANDALF's examples and regression suite
(``shocktube``, ``cdiscontinuity`` and ``soundwave`` in 1D, ``khi`` in
2D, ``sedov`` and
``noh`` in any dimension), the uniform box (``ic = box``) on a cubic
lattice, the uniform sphere (``ic = sphere``), lattice or random
(numpy's generator,
``rand_algorithm = default``; the xorshift generator's sphere sampler is
not ported and raises), and the periodic self-gravity tests of
EwaldIc.cpp (``jeans`` = ``ewaldsine``, ``ewaldsine2``, ``ewaldslab``,
``ewaldcylinder``), the Boss-Bodenheimer cloud (``bossbodenheimer`` =
``bb``), the hybrid gas-and-star Plummer sphere (``plummer``), and the
gas-and-dust tests: the dusty box (``dustybox``) and the Evrard collapse
(``evrard``, with a dust copy of its gas when dust_forces is set), and
the cold sphere of the Spitzer HII-region test (``spitzer``), with
``generate_ic``'s dispatch; and the N-body star sets (``plummer``,
``binary``, ``triple``, ``quadruple``) with ``generate_nbody_ic``'s.
Host-side numpy in float64, as there; each hydro generator returns a
dict with keys r, v, m, h, u (the hybrid Plummer also ``star``: r, v, m,
h of its stars; the dusty ones also ``ptype``), each N-body one r, v,
m, h.  Any other ``ic``, and the
Lloyd regularisation, raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..state import DUST_TYPE, GAS_TYPE
from ..utils.rng import XorshiftRand
from ..utils.rng import rng_from_params as _rng_from_params


def _sample_sphere(rng, n: int, ndim: int, radius: float) -> np.ndarray:
    """Uniform points in a sphere: batched rejection sampling from a
    numpy Generator."""
    if isinstance(rng, XorshiftRand):
        raise NotImplementedError(
            "the xorshift generator's sphere sampler (random_sphere) is "
            "not ported yet (ROADMAP queue 1, item 9)")
    pts = []
    got = 0
    while got < n:
        cand = rng.uniform(-radius, radius, size=(2 * n, ndim))
        cand = cand[(cand ** 2).sum(-1) <= radius * radius]
        pts.append(cand[: n - got])
        got += len(pts[-1])
    return np.concatenate(pts, axis=0)


def add_cubic_lattice(n_lattice, boxmin, boxmax) -> np.ndarray:
    """Cell-centred cubic lattice (Ic::AddCubicLattice, src/Ic/Ic.cpp:629)."""
    ndim = len(n_lattice)
    axes = [boxmin[k] + (np.arange(n_lattice[k]) + 0.5)
            * (boxmax[k] - boxmin[k]) / n_lattice[k] for k in range(ndim)]
    grids = np.meshgrid(*axes, indexing="ij")
    # match reference ordering: x fastest (ii innermost loop)
    r = np.stack([g.reshape(-1, order="F") for g in grids], axis=-1)
    return r


def uniform_box_ic(params, eos) -> Dict[str, np.ndarray]:
    """Uniform-density box ('box' IC, src/Ic/UniformIc.cpp)."""
    ndim = params.intparams["ndim"]
    fp = params.floatparams
    ip = params.intparams
    n_lattice = [ip[f"Nlattice1[{k}]"] for k in range(ndim)]
    boxmin = [fp[f"boxmin[{k}]"] for k in range(ndim)]
    boxmax = [fp[f"boxmax[{k}]"] for k in range(ndim)]
    rho0 = fp["rhofluid1"]
    press0 = fp["press1"]
    gammam1 = fp["gamma_eos"] - 1.0
    h_fac = fp["h_fac"]
    r = add_cubic_lattice(n_lattice, boxmin, boxmax)
    N = r.shape[0]
    volume = np.prod([boxmax[k] - boxmin[k] for k in range(ndim)])
    m = np.full(N, rho0 * volume / N)
    h = h_fac * (m / rho0) ** (1.0 / ndim)
    if params.stringparams["gas_eos"] == "isothermal":
        u = np.full(N, fp["temp0"] / gammam1 / fp["mu_bar"])
    else:
        u = np.full(N, press0 / (gammam1 * rho0))
    return {"r": r, "v": np.zeros((N, ndim)), "m": m, "h": h, "u": u}


def shocktube_ic(params, eos) -> Dict[str, np.ndarray]:
    """1D Riemann-problem shocktube (src/Ic/ShocktubeIc.cpp:57-206)."""
    ndim = params.intparams["ndim"]
    if ndim != 1:
        raise ValueError("shocktube IC is 1D only")
    fp = params.floatparams
    ip = params.intparams
    rho1, rho2 = fp["rhofluid1"], fp["rhofluid2"]
    press1, press2 = fp["press1"], fp["press2"]
    v1, v2 = fp["vfluid1[0]"], fp["vfluid2[0]"]
    N1, N2 = ip["Nlattice1[0]"], ip["Nlattice2[0]"]
    xmin, xmax = fp["boxmin[0]"], fp["boxmax[0]"]
    h_fac = fp["h_fac"]
    gammam1 = fp["gamma_eos"] - 1.0

    if params.stringparams["gas_eos"] == "isothermal":
        u1 = u2 = fp["temp0"] / gammam1 / fp["mu_bar"]
    else:
        u1 = press1 / (gammam1 * rho1)
        u2 = press2 / (gammam1 * rho2)

    r1 = add_cubic_lattice([N1], [xmin], [0.0])
    r2 = add_cubic_lattice([N2], [0.0], [xmax])
    vol1, vol2 = -xmin, xmax
    m1 = np.full(N1, rho1 * vol1 / N1)
    m2 = np.full(N2, rho2 * vol2 / N2)
    u = np.concatenate([np.full(N1, u1), np.full(N2, u2)])
    v = np.zeros((N1 + N2, 1))
    v[:N1, 0] = v1
    v[N1:, 0] = v2
    r = np.concatenate([r1, r2], axis=0)
    m = np.concatenate([m1, m2])
    rho = np.concatenate([np.full(N1, rho1), np.full(N2, rho2)])
    h = h_fac * (m / rho) ** (1.0 / ndim)
    return {"r": r, "v": v, "m": m, "h": h, "u": u}


def cdiscontinuity_ic(params, eos) -> Dict[str, np.ndarray]:
    """1D contact discontinuity: two densities, equal pressure
    (src/Ic/ContactDiscontinuityIc.cpp)."""
    p2 = params.copy()
    p2.set("press2", params.floatparams["press1"])
    p2.set("vfluid1[0]", 0.0)
    p2.set("vfluid2[0]", 0.0)
    return shocktube_ic(p2, eos)


def soundwave_ic(params, eos) -> Dict[str, np.ndarray]:
    """1D linear soundwave perturbation (src/Ic/SoundwaveIc.cpp:
    lattice + Ic::AddSinusoidalDensityPerturbation)."""
    ndim = params.intparams["ndim"]
    if ndim != 1:
        raise ValueError("soundwave IC is 1D only")
    fp = params.floatparams
    ip = params.intparams
    rho0 = fp["rhofluid1"]
    press0 = fp["press1"]
    amp = fp["amp"]
    temp0 = fp["temp0"]
    mu_bar = fp["mu_bar"]
    gamma = fp["gamma_eos"]
    gammam1 = gamma - 1.0
    N = ip["Nhydro"] if ip["Nhydro"] > 0 else ip["Nlattice1[0]"]
    xmin, xmax = fp["boxmin[0]"], fp["boxmax[0]"]
    h_fac = fp["h_fac"]

    if params.stringparams["gas_eos"] == "isothermal":
        u0 = temp0 / gammam1 / mu_bar
        press0 = gammam1 * rho0 * u0
        csound = np.sqrt(press0 / rho0)
    else:
        u0 = press0 / (gammam1 * rho0)
        csound = np.sqrt(gamma * press0 / rho0)

    lam = xmax - xmin
    kwave = 2.0 * np.pi / lam
    x = add_cubic_lattice([N], [xmin], [xmax])[:, 0]
    # iterate x_new = x - amp*(1 - cos(k x_new))/k  (reference fixed point)
    xnew = x.copy()
    for _ in range(200):
        xnew = x - amp * (1.0 - np.cos(kwave * xnew)) / kwave
    xnew = np.where(xnew > xmax, xnew - lam, xnew)
    xnew = np.where(xnew < xmin, xnew + lam, xnew)
    x = xnew
    v = np.zeros((N, 1))
    v[:, 0] = csound * amp * np.sin(kwave * x)
    m = np.full(N, rho0 * lam / N)
    h = h_fac * (m / rho0)
    u = u0 * np.ones(N)
    return {"r": x[:, None], "v": v, "m": m, "h": h, "u": u}


def sedov_ic(params, eos) -> Dict[str, np.ndarray]:
    """Sedov-Taylor blast wave: cold lattice + energy injected in a central
    kernel-sized hot region (src/Ic/SedovBlastwaveIc.cpp).  The smoothed
    injection weighs by the port's own M4 kernel."""
    ip, fp = params.intparams, params.floatparams
    ndim = ip["ndim"]
    n_lattice = [ip[f"Nlattice1[{k}]"] for k in range(ndim)]
    boxmin = [fp[f"boxmin[{k}]"] for k in range(ndim)]
    boxmax = [fp[f"boxmax[{k}]"] for k in range(ndim)]
    rho0 = fp["rhofluid1"]
    kefrac = fp["kefrac"]
    h_fac = fp["h_fac"]
    smooth = bool(ip["smooth_ic"])
    import torch

    from ..kernels.smoothing import kernel_factory
    kern = kernel_factory(params.stringparams["kernel"], ndim,
                          params.intparams["tabulated_kernel"])

    r = add_cubic_lattice(n_lattice, boxmin, boxmax)
    N = r.shape[0]
    volume = np.prod([boxmax[k] - boxmin[k] for k in range(ndim)])
    m = np.full(N, rho0 * volume / N)
    h = h_fac * (m / rho0) ** (1.0 / ndim)
    r_hot = h_fac * kern.kernrange * (boxmax[0] - boxmin[0]) / n_lattice[0]

    drsqd = (r ** 2).sum(-1)
    hot = drsqd < r_hot * r_hot
    if smooth:
        w = kern.w0(torch.as_tensor(
            kern.kernrange * np.sqrt(drsqd) / r_hot)).numpy()
        u = np.where(hot, m * w, 0.0)
    else:
        u = np.where(hot, m, 0.0)
    utot = u.sum()
    ufrac = max(0.0, 1.0 - kefrac)
    u_hot = u / utot / m
    v = np.zeros((N, ndim))
    drmag = np.sqrt(drsqd) + 1e-30
    vmag = np.sqrt(2.0 * kefrac * u_hot)
    v = np.where(hot[:, None], vmag[:, None] * r / drmag[:, None], v)
    u = np.where(hot, ufrac * u_hot, 1.0e-6 / m)
    return {"r": r, "v": v, "m": m, "h": h, "u": u}


def khi_ic(params, eos) -> Dict[str, np.ndarray]:
    """Kelvin-Helmholtz instability: two shearing layers + seeded mode
    (src/Ic/KhiIc.cpp)."""
    ip, fp = params.intparams, params.floatparams
    if ip["ndim"] != 2:
        raise ValueError("khi IC is 2D only")
    boxmin = [fp["boxmin[0]"], fp["boxmin[1]"]]
    boxmax = [fp["boxmax[0]"], fp["boxmax[1]"]]
    Ly = boxmax[1] - boxmin[1]
    rho1, rho2 = fp["rhofluid1"], fp["rhofluid2"]
    press1, press2 = fp["press1"], fp["press2"]
    v1, v2 = fp["vfluid1[0]"], fp["vfluid2[0]"]
    amp, lam = fp["amp"], fp["lambda"]
    gammam1 = fp["gamma_eos"] - 1.0
    h_fac = fp["h_fac"]
    N1 = [ip["Nlattice1[0]"], ip["Nlattice1[1]"]]
    N2 = [ip["Nlattice2[0]"], ip["Nlattice2[1]"]]
    # bottom half = fluid 1, top half = fluid 2, both then shifted down by
    # Ly/4 so the interfaces sit at y = +-0.25 (reference :31-76)
    half = boxmin[1] + 0.5 * Ly
    r1 = add_cubic_lattice(N1, boxmin, [boxmax[0], half])
    r2 = add_cubic_lattice(N2, [boxmin[0], half], boxmax)
    volume = (boxmax[0] - boxmin[0]) * 0.5 * Ly
    r = np.concatenate([r1, r2], axis=0)
    r[:, 1] -= 0.25 * Ly
    r[:, 1] = np.where(r[:, 1] < boxmin[1], r[:, 1] + Ly, r[:, 1])
    n1, n2 = len(r1), len(r2)
    m = np.concatenate([np.full(n1, rho1 * volume / n1),
                        np.full(n2, rho2 * volume / n2)])
    rho = np.concatenate([np.full(n1, rho1), np.full(n2, rho2)])
    u = np.concatenate([np.full(n1, press1 / rho1 / gammam1),
                        np.full(n2, press2 / rho2 / gammam1)])
    h = h_fac * (m / rho) ** 0.5
    v = np.zeros((n1 + n2, 2))
    v[:n1, 0] = v1
    v[n1:, 0] = v2
    sigma = 0.05 / np.sqrt(2.0)
    v[:, 1] = amp * np.sin(2.0 * np.pi * r[:, 0] / lam) * (
        np.exp(-((r[:, 1] + 0.25) ** 2) / (2.0 * sigma ** 2))
        + np.exp(-((r[:, 1] - 0.25) ** 2) / (2.0 * sigma ** 2)))
    return {"r": r, "v": v, "m": m, "h": h, "u": u}


def gresho_ic(params, eos) -> Dict[str, np.ndarray]:
    """Gresho-Chan vortex (src/Ic/GreshoVortexIc.cpp): a rotationally
    supported vortex in exact steady state, on a lattice of uniform
    density."""
    ip, fp = params.intparams, params.floatparams
    if ip["ndim"] != 2:
        raise ValueError("gresho IC is 2D only")
    n_lattice = [ip["Nlattice1[0]"], ip["Nlattice1[1]"]]
    boxmin = [fp["boxmin[0]"], fp["boxmin[1]"]]
    boxmax = [fp["boxmax[0]"], fp["boxmax[1]"]]
    gammam1 = fp["gamma_eos"] - 1.0
    h_fac = fp["h_fac"]
    rho0 = 1.0
    r = add_cubic_lattice(n_lattice, boxmin, boxmax)
    N = r.shape[0]
    rad = np.sqrt((r ** 2).sum(-1)) + 1e-30
    # azimuthal velocity and pressure profiles (Gresho & Chan 1990)
    vphi = np.where(rad < 0.2, 5.0 * rad,
                    np.where(rad < 0.4, 2.0 - 5.0 * rad, 0.0))
    press = np.where(
        rad < 0.2, 5.0 + 12.5 * rad ** 2,
        np.where(rad < 0.4,
                 9.0 + 12.5 * rad ** 2 - 20.0 * rad + 4.0 * np.log(rad / 0.2),
                 3.0 + 4.0 * np.log(2.0)))
    v = np.stack([-vphi * r[:, 1] / rad, vphi * r[:, 0] / rad], axis=-1)
    volume = np.prod([boxmax[k] - boxmin[k] for k in range(2)])
    m = np.full(N, rho0 * volume / N)
    h = h_fac * (m / rho0) ** 0.5
    u = press / (rho0 * gammam1)
    return {"r": r, "v": v, "m": m, "h": h, "u": u}


def noh_ic(params, eos) -> Dict[str, np.ndarray]:
    """Noh problem: uniform gas with radial inflow v_r = -1
    (src/Ic/NohIc.cpp)."""
    ip, fp = params.intparams, params.floatparams
    ndim = ip["ndim"]
    n_lattice = [ip[f"Nlattice1[{k}]"] for k in range(ndim)]
    boxmin = [fp[f"boxmin[{k}]"] for k in range(ndim)]
    boxmax = [fp[f"boxmax[{k}]"] for k in range(ndim)]
    rho0 = fp["rhofluid1"]
    press0 = fp["press1"]
    gammam1 = fp["gamma_eos"] - 1.0
    h_fac = fp["h_fac"]
    r = add_cubic_lattice(n_lattice, boxmin, boxmax)
    N = r.shape[0]
    rad = np.sqrt((r ** 2).sum(-1)) + 1e-30
    v = -r / rad[:, None]
    volume = np.prod([boxmax[k] - boxmin[k] for k in range(ndim)])
    m = np.full(N, rho0 * volume / N)
    h = h_fac * (m / rho0) ** (1.0 / ndim)
    u = np.full(N, press0 / (rho0 * gammam1))
    return {"r": r, "v": v, "m": m, "h": h, "u": u}


def add_lattice_sphere(n_target: int, radius: float, ndim: int = 3
                       ) -> np.ndarray:
    """Cubic-lattice points inside a sphere, tuned to ~n_target points
    (Ic::AddLatticeSphere, src/Ic/Ic.cpp)."""
    # search the lattice resolution whose sphere cut best matches.  Past
    # the target the count only grows with the resolution (by ~n^(ndim-1)
    # a step, far above the lattice's fluctuation), so two resolutions in
    # a row beyond the best match's distance end the search where the JAX
    # package's loop runs on to its last resolution with the same result
    best = None
    beyond = 0
    lo, hi = 2, max(4, int(3.0 * n_target ** (1.0 / ndim)))
    for n_lat in range(lo, hi):
        r = add_cubic_lattice([n_lat] * ndim, [-radius] * ndim,
                              [radius] * ndim)
        inside = (r ** 2).sum(-1) <= radius * radius
        cnt = int(inside.sum())
        if best is None or abs(cnt - n_target) < abs(best[0] - n_target):
            best = (cnt, r[inside])
        if cnt >= n_target and best[0] == cnt:
            break
        beyond = beyond + 1 if cnt - n_target > abs(best[0] - n_target) \
            else 0
        if beyond == 2:
            break
    return best[1]


def sphere_ic(params, eos) -> Dict[str, np.ndarray]:
    """Uniform-density sphere ('sphere' IC; UniformIc sphere branch,
    src/Ic/UniformIc.cpp)."""
    ip, fp = params.intparams, params.floatparams
    ndim = ip["ndim"]
    n_target = ip["Nhydro"]
    mcloud = fp["mcloud"]
    radius = fp["radius"]
    press = fp["press1"]
    gammam1 = fp["gamma_eos"] - 1.0
    h_fac = fp["h_fac"]
    dist = params.stringparams["particle_distribution"]
    if dist == "random":
        r = _sample_sphere(_rng_from_params(params), n_target, ndim,
                           radius)
    else:
        r = add_lattice_sphere(n_target, radius, ndim)
    N = r.shape[0]
    if ndim == 1:
        volume = 2.0 * radius
    elif ndim == 2:
        volume = np.pi * radius ** 2
    else:
        volume = 4.0 / 3.0 * np.pi * radius ** 3
    rho0 = mcloud / volume
    m = np.full(N, mcloud / N)
    h = h_fac * (m / rho0) ** (1.0 / ndim)
    u = np.full(N, press / (gammam1 * rho0))
    return {"r": r, "v": np.zeros((N, ndim)), "m": m, "h": h, "u": u}


def spitzer_ic(params, eos) -> Dict[str, np.ndarray]:
    """The cold uniform lattice sphere of the Spitzer HII-region
    expansion test (src/Ic/SpitzerExpansionIc.cpp:57-130): u tiny, the
    ionisation drives the dynamics."""
    fp, ip = params.floatparams, params.intparams
    if ip["ndim"] != 3:
        raise ValueError("spitzer IC is 3D only")
    mcloud, radius = fp["mcloud"], fp["radius"]
    r = add_lattice_sphere(ip["Nhydro"], radius, 3)
    N = len(r)
    rho = mcloud / (4.0 / 3.0 * np.pi * radius ** 3)
    m = np.full(N, mcloud / N)
    h = fp["h_fac"] * (m / rho) ** (1.0 / 3.0)
    return {"r": r, "v": np.zeros_like(r), "m": m, "h": h,
            "u": np.full(N, 1e-20)}


def evrard_ic(params, eos) -> Dict[str, np.ndarray]:
    """Evrard collapse: 1/r density sphere, cold gas
    (src/Ic/EvrardCollapseIc.cpp:50-135).  A unit lattice sphere is
    stretched with rnew = R r^{3/2} so rho ~ 1/r.  With dust_forces set,
    a dust copy of the gas (mass times dust_mass_factor, u = 0) offset
    by 0.01 h along every axis follows it."""
    ip, fp = params.intparams, params.floatparams
    ndim = ip["ndim"]
    if ndim != 3:
        raise ValueError("evrard IC is 3D only")
    mcloud = fp["mcloud"]
    radius = fp["radius"]
    u_fac = fp["thermal_energy"]
    r = add_lattice_sphere(ip["Nhydro"], 1.0, ndim)
    N = r.shape[0]
    rad = np.sqrt((r ** 2).sum(-1)) + 1e-30
    rnew = radius * rad * np.sqrt(rad)
    r = r * (rnew / rad)[:, None]
    m = np.full(N, mcloud / N)
    rho = (mcloud / (2.0 * np.pi * radius ** ndim)) * (radius / rnew)
    h = fp["h_fac"] * (m / rho) ** (1.0 / ndim)
    u = np.full(N, u_fac * mcloud / radius)
    out = {"r": r, "v": np.zeros((N, ndim)), "m": m, "h": h, "u": u}
    if params.stringparams["dust_forces"] not in ("none", "null", ""):
        d2g = fp["dust_mass_factor"]
        rd = r.copy()
        rd += 0.01 * h[:, None]
        out = {
            "r": np.concatenate([r, rd]),
            "v": np.zeros((2 * N, ndim)),
            "m": np.concatenate([m, m * d2g]),
            "h": np.concatenate([h, h]),
            "u": np.concatenate([u, np.zeros(N)]),
            "ptype": np.concatenate([np.full(N, GAS_TYPE, np.int32),
                                     np.full(N, DUST_TYPE, np.int32)]),
        }
    return out


def dustybox_ic(params, eos) -> Dict[str, np.ndarray]:
    """Uniform gas box + slightly-offset dust lattice with a velocity
    offset (DUSTYBOX drag test; src/Ic/DustyBoxIc.cpp:40-150)."""
    gas = uniform_box_ic(params, eos)
    fp = params.floatparams
    N = len(gas["m"])
    gas["v"][:, 0] = fp["vfluid1[0]"]
    d2g = fp["dust_mass_factor"]
    dust_r = gas["r"].copy()
    dust_r[:, 0] += 0.01 * gas["h"]
    dust_v = np.zeros_like(gas["v"])
    dust_v[:, 0] = fp["vfluid2[0]"]
    return {
        "r": np.concatenate([gas["r"], dust_r]),
        "v": np.concatenate([gas["v"], dust_v]),
        "m": np.concatenate([gas["m"], gas["m"] * d2g]),
        "h": np.concatenate([gas["h"], gas["h"]]),
        "u": np.concatenate([gas["u"], np.zeros(N)]),
        "ptype": np.concatenate([np.full(N, GAS_TYPE, np.int32),
                                 np.full(N, DUST_TYPE, np.int32)]),
    }


def bossbodenheimer_ic(params, eos) -> Dict[str, np.ndarray]:
    """Boss-Bodenheimer rotating cloud collapse with an m=2 azimuthal
    density perturbation (src/Ic/BossBodenheimerIc.cpp)."""
    ip, fp = params.intparams, params.floatparams
    if ip["ndim"] != 3:
        raise ValueError("bossbodenheimer IC is 3D only")
    Npart = ip["Nhydro"]
    mcloud = fp["mcloud"]
    radius = fp["radius"]
    angvel = fp["angvel"]
    amp = fp["amp"]
    temp0 = fp["temp0"]
    mu_bar = fp["mu_bar"]
    gammam1 = fp["gamma_eos"] - 1.0
    h_fac = fp["h_fac"]
    mpert = 2

    dist = params.stringparams["particle_distribution"]
    if dist == "random":
        r = _sample_sphere(_rng_from_params(params), Npart, 3, radius)
    else:
        r = add_lattice_sphere(Npart, radius, 3)
    N = r.shape[0]

    # azimuthal remap: find phi' with phi = phi' + (amp/m) cos(m phi')
    # (Ic::AddAzimuthalDensityPerturbation) — Newton iteration
    phi = np.arctan2(r[:, 1], r[:, 0]) % (2 * np.pi)
    Rmag = np.sqrt(r[:, 0] ** 2 + r[:, 1] ** 2)
    phip = phi.copy()
    for _ in range(60):
        f = phip + (amp / mpert) * np.cos(mpert * phip) - phi
        fp_ = 1.0 - amp * np.sin(mpert * phip)
        phip = phip - f / fp_
    r[:, 0] = Rmag * np.cos(phip)
    r[:, 1] = Rmag * np.sin(phip)

    # solid-body rotation about z (Ic::AddRotationalVelocityField)
    v = np.zeros((N, 3))
    v[:, 0] = -angvel * r[:, 1]
    v[:, 1] = angvel * r[:, 0]

    rho0 = 3.0 * mcloud / (4.0 * np.pi * radius ** 3)
    u0 = temp0 / gammam1 / mu_bar
    m = np.full(N, mcloud / N)
    h = h_fac * (m / rho0) ** (1.0 / 3.0)
    u = np.full(N, u0)
    return {"r": r, "v": v, "m": m, "h": h, "u": u}


def plummer_hybrid_ic(params, eos) -> Dict[str, np.ndarray]:
    """Plummer sphere with both gas and stars (gasfrac/starfrac;
    src/Ic/PlummerSphereIc.cpp hybrid branch — the 'hybridplummer' test)."""
    ip, fp = params.intparams, params.floatparams
    gasfrac = fp["gasfrac"]
    starfrac = fp["starfrac"]
    tot = gasfrac + starfrac
    gasfrac, starfrac = gasfrac / tot, starfrac / tot
    gamma = fp["gamma_eos"]
    mplummer, rplummer = fp["mplummer"], fp["rplummer"]

    star = plummer_stars_ic(params)     # star positions/velocities
    Nhydro = ip["Nhydro"]
    out: Dict[str, np.ndarray] = {}
    if Nhydro > 0:
        p2 = params.copy()
        p2.set("Nstar", Nhydro)
        # independent draw from the same distribution (a shared seed would
        # place the first Nstar gas particles exactly on top of the stars)
        p2.set("randseed", params.intparams["randseed"] + 1)
        gas = plummer_stars_ic(p2)
        N = len(gas["m"])
        rad = np.sqrt((gas["r"] ** 2).sum(-1)) / rplummer
        sound = np.sqrt(1.0 / 6.0 / np.sqrt(1.0 + rad * rad)) \
            * np.sqrt(mplummer / rplummer)
        out["r"] = gas["r"]
        out["v"] = np.zeros_like(gas["v"])   # gas pressure-supported
        out["m"] = np.full(N, gasfrac * mplummer / N)
        out["u"] = sound ** 2 / (gamma - 1.0)
        rho0 = 3.0 * mplummer / (4.0 * np.pi * rplummer ** 3)
        out["h"] = fp["h_fac"] * (out["m"] / rho0) ** (1.0 / 3.0)
    star["m"] = star["m"] * starfrac
    out["star"] = star
    return out


def _thermal_u(params) -> float:
    """u from either the isothermal (temp0/mu_bar) or adiabatic
    (press1/rho1) parameters, as the reference IC generators do."""
    fp = params.floatparams
    gammam1 = fp["gamma_eos"] - 1.0
    if params.stringparams["gas_eos"] == "isothermal":
        return fp["temp0"] / gammam1 / fp["mu_bar"]
    return fp["press1"] / fp["rhofluid1"] / gammam1


def _sinusoidal_displace(x: np.ndarray, amp: float, lam: float) -> np.ndarray:
    """Displace lattice x so the density becomes rho0(1 + amp sin(k x))
    (Ic::AddSinusoidalDensityPerturbation fixed-point iteration)."""
    kwave = 2.0 * np.pi / lam
    xnew = x.copy()
    for _ in range(200):
        xnew = x - amp * (1.0 - np.cos(kwave * xnew)) / kwave
    return xnew


def jeans_ic(params, eos) -> Dict[str, np.ndarray]:
    """Sinusoidal density perturbation on a 3D periodic lattice for the
    Jeans-instability / Ewald sine-perturbation tests
    (src/Ic/EwaldIc.cpp:139-186, 'ewaldsine' == 'jeans')."""
    fp, ip = params.floatparams, params.intparams
    ndim = ip["ndim"]
    n_lat = [ip[f"Nlattice1[{k}]"] for k in range(ndim)]
    lo = [fp[f"boxmin[{k}]"] for k in range(ndim)]
    hi = [fp[f"boxmax[{k}]"] for k in range(ndim)]
    rho0 = fp["rhofluid1"]
    amp = fp["amp"]
    lam = hi[0] - lo[0]
    r = add_cubic_lattice(n_lat, lo, hi)
    r[:, 0] = _sinusoidal_displace(r[:, 0], amp, lam)
    # wrap displaced particles back into the periodic box
    r[:, 0] = lo[0] + np.mod(r[:, 0] - lo[0], lam)
    N = len(r)
    volume = np.prod(np.asarray(hi) - np.asarray(lo))
    m = np.full(N, rho0 * volume / N)
    h = fp["h_fac"] * (m / rho0) ** (1.0 / ndim)
    u = np.full(N, _thermal_u(params))
    return {"r": r, "v": np.zeros_like(r), "m": m, "h": h, "u": u}


def _mass_weighted_box(params, rho_fn) -> Dict[str, np.ndarray]:
    """Lattice positions with per-particle masses following rho_fn(r)
    (the EwaldIc variable-mass pattern, src/Ic/EwaldIc.cpp:187-320)."""
    fp, ip = params.floatparams, params.intparams
    ndim = ip["ndim"]
    n_lat = [ip[f"Nlattice1[{k}]"] for k in range(ndim)]
    lo = [fp[f"boxmin[{k}]"] for k in range(ndim)]
    hi = [fp[f"boxmax[{k}]"] for k in range(ndim)]
    r = add_cubic_lattice(n_lat, lo, hi)
    N = len(r)
    volume = np.prod(np.asarray(hi) - np.asarray(lo))
    rho = rho_fn(r)
    m = rho * volume / N
    h = fp["h_fac"] * (m / np.maximum(rho, 1e-30)) ** (1.0 / ndim)
    u = np.full(N, _thermal_u(params))
    return {"r": r, "v": np.zeros_like(r), "m": m, "h": h, "u": u}


def _periodicity_code(params) -> int:
    """Bitmask of fully-periodic dimensions (EwaldIc.cpp:122-134)."""
    ndim = params.intparams["ndim"]
    code = 0
    for k in range(ndim):
        if (params.stringparams[f"boundary_lhs[{k}]"] == "periodic"
                and params.stringparams[f"boundary_rhs[{k}]"] == "periodic"):
            code |= 1 << k
    return code


def _ic_sound_speed(params) -> float:
    fp = params.floatparams
    if params.stringparams["gas_eos"] == "isothermal":
        return float(np.sqrt(fp["temp0"] / fp["mu_bar"]))
    return float(np.sqrt(fp["gamma_eos"] * fp["press1"] / fp["rhofluid1"]))


def ewaldsine2_ic(params, eos) -> Dict[str, np.ndarray]:
    fp = params.floatparams
    lam = fp["boxmax[0]"] - fp["boxmin[0]"]
    kwave = 2.0 * np.pi / lam
    return _mass_weighted_box(
        params, lambda r: fp["rhofluid1"]
        * (1.0 + fp["amp"] * np.sin(kwave * r[:, 0])))


def ewaldslab_ic(params, eos) -> Dict[str, np.ndarray]:
    """Self-gravitating isothermal slab: rho = rho0 sech^2(z/h0) with
    h0 = cs/sqrt(2 pi rho0) normal to the non-periodic dimension."""
    fp = params.floatparams
    rho0 = fp["rhofluid1"]
    cs = _ic_sound_speed(params)
    h0 = cs / np.sqrt(2.0 * np.pi * rho0)
    per = _periodicity_code(params)
    axis = {3: 2, 5: 1, 6: 0}.get(per)
    if axis is None:
        raise ValueError("ewaldslab needs periodic boundaries in exactly "
                         "two dimensions")
    return _mass_weighted_box(
        params, lambda r: rho0 / np.cosh(r[:, axis] / h0) ** 2)


def ewaldcylinder_ic(params, eos) -> Dict[str, np.ndarray]:
    """Self-gravitating isothermal cylinder (Ostriker profile):
    rho = rho0 / (1 + pi rho0 r_perp^2 / (2 cs^2))^2."""
    fp = params.floatparams
    rho0 = fp["rhofluid1"]
    cs = _ic_sound_speed(params)
    a2inv = np.pi * rho0 * 0.5 / cs ** 2
    per = _periodicity_code(params)
    perp = {1: (1, 2), 2: (0, 2), 4: (0, 1)}.get(per)
    if perp is None:
        raise ValueError("ewaldcylinder needs periodic boundaries in "
                         "exactly one dimension")
    return _mass_weighted_box(
        params, lambda r: rho0 / (1.0 + a2inv * (r[:, perp[0]] ** 2
                                                 + r[:, perp[1]] ** 2)) ** 2)


def plummer_stars_ic(params) -> Dict[str, np.ndarray]:
    """Plummer sphere of stars via the Aarseth rejection method
    (src/Ic/PlummerSphereIc.cpp:57-170, star branch)."""
    ip, fp = params.intparams, params.floatparams
    Nstar = ip["Nstar"]
    mplummer = fp["mplummer"]
    rplummer = fp["rplummer"]
    radius = fp["radius"]
    rstar = fp["rstar"]
    rng = _rng_from_params(params)

    r = np.zeros((Nstar, 3))
    v = np.zeros((Nstar, 3))
    n = 0
    while n < Nstar:
        x1, x2, x3 = rng.random(3)
        if x1 <= 0.0:
            continue
        rad = 1.0 / np.sqrt(x1 ** (-2.0 / 3.0) - 1.0)
        if rad > radius / rplummer:
            continue
        z = (1.0 - 2.0 * x2) * rad
        rxy = np.sqrt(max(rad * rad - z * z, 0.0))
        r[n] = [rxy * np.cos(2 * np.pi * x3), rxy * np.sin(2 * np.pi * x3), z]
        # velocity: rejection-sample q = v/v_esc from q^2 (1-q^2)^3.5
        ve = np.sqrt(2.0 / np.sqrt(1.0 + rad * rad))
        while True:
            x4, x5 = rng.random(2)
            if 0.1 * x5 <= x4 * x4 * (1.0 - x4 * x4) ** 3.5:
                break
        vm = ve * x4
        x6, x7 = rng.random(2)
        w = (1.0 - 2.0 * x6) * vm
        vxy = np.sqrt(max(vm * vm - w * w, 0.0))
        v[n] = [vxy * np.cos(2 * np.pi * x7), vxy * np.sin(2 * np.pi * x7), w]
        n += 1

    # scale to physical units (G = 1; Plummer natural units -> mplummer,
    # rplummer; velocity scale sqrt(M/R))
    vscale = np.sqrt(mplummer / rplummer)
    r *= rplummer
    v *= vscale
    m = np.full(Nstar, mplummer / Nstar)
    h = np.full(Nstar, rstar)
    ndim = params.intparams["ndim"]
    return {"r": r[:, :ndim], "v": v[:, :ndim], "m": m, "h": h}


def _binary_offsets(sma, ecc, m1, m2, M, ndim):
    """Positions/velocities of a two-body pair about its barycentre from
    orbital elements at mean anomaly M (Ic::AddBinaryStar, src/Ic/Ic.cpp).

    Returns (r1, v1, r2, v2) each of shape (ndim,)."""
    Ee = M
    for _ in range(100):
        Ee = Ee - (Ee - ecc * np.sin(Ee) - M) / (1.0 - ecc * np.cos(Ee))
    theta = 2.0 * np.arctan(np.sqrt((1.0 + ecc) / (1.0 - ecc))
                            * np.tan(0.5 * Ee))
    sep = sma * (1.0 - ecc * ecc) / (1.0 + ecc * np.cos(theta))
    vel = np.sqrt((m1 + m2) * (2.0 / sep - 1.0 / sma))
    hc = np.sqrt((1.0 + ecc * np.cos(theta)) / (2.0 - sep / sma))
    phi = np.arccos(np.clip(hc, -1.0, 1.0))
    mbin = m1 + m2
    rx = sep * np.cos(theta)
    ry = sep * np.sin(theta)
    vx = -vel * np.cos(0.5 * np.pi - theta + phi)
    vy = vel * np.sin(0.5 * np.pi - theta + phi)
    r1 = np.zeros(ndim)
    v1 = np.zeros(ndim)
    r2 = np.zeros(ndim)
    v2 = np.zeros(ndim)
    r1[0], r1[1] = rx * m2 / mbin, ry * m2 / mbin
    v1[0], v1[1] = vx * m2 / mbin, vy * m2 / mbin
    r2[0], r2[1] = -rx * m1 / mbin, -ry * m1 / mbin
    v2[0], v2[1] = -vx * m1 / mbin, -vy * m1 / mbin
    return r1, v1, r2, v2


def binary_ic(params) -> Dict[str, np.ndarray]:
    """Binary star from orbital elements (Ic::AddBinaryStar,
    src/Ic/Ic.cpp)."""
    fp = params.floatparams
    ndim = params.intparams["ndim"]
    if ndim < 2:
        raise ValueError("binary IC needs ndim >= 2")
    rng = _rng_from_params(params)
    M = 2.0 * np.pi * rng.random()
    m1, m2 = fp["m1"], fp["m2"]
    r1, v1, r2, v2 = _binary_offsets(fp["abin"], fp["ebin"], m1, m2, M,
                                     ndim)
    return {"r": np.stack([r1, r2]), "v": np.stack([v1, v2]),
            "m": np.array([m1, m2]), "h": np.full(2, fp["rstar"])}


def triple_ic(params) -> Dict[str, np.ndarray]:
    """Hierarchical triple: outer binary of (m1+m2) and m3 at abin, the
    first component replaced by an inner (m1, m2) binary at abin2
    (HierarchicalSystemIc.cpp:88-117)."""
    fp = params.floatparams
    ndim = params.intparams["ndim"]
    if ndim < 2:
        raise ValueError("triple IC needs ndim >= 2")
    rng = _rng_from_params(params)
    m1, m2, m3 = fp["m1"], fp["m2"], fp["m3"]
    R1, V1, R3, V3 = _binary_offsets(fp["abin"], fp["ebin"], m1 + m2, m3,
                                     2.0 * np.pi * rng.random(), ndim)
    r1, v1, r2, v2 = _binary_offsets(fp["abin2"], fp["ebin2"], m1, m2,
                                     2.0 * np.pi * rng.random(), ndim)
    return {
        "r": np.stack([R1 + r1, R1 + r2, R3]),
        "v": np.stack([V1 + v1, V1 + v2, V3]),
        "m": np.array([m1, m2, m3]),
        "h": np.full(3, fp["rstar"]),
    }


def quadruple_ic(params) -> Dict[str, np.ndarray]:
    """Hierarchical quadruple: outer binary of (m1+m2) and (m3+m4), each
    component an inner binary at abin2 (HierarchicalSystemIc.cpp:119-150)."""
    fp = params.floatparams
    ndim = params.intparams["ndim"]
    if ndim < 2:
        raise ValueError("quadruple IC needs ndim >= 2")
    rng = _rng_from_params(params)
    m1, m2, m3, m4 = fp["m1"], fp["m2"], fp["m3"], fp["m4"]
    RA, VA, RB, VB = _binary_offsets(fp["abin"], fp["ebin"],
                                     m1 + m2, m3 + m4,
                                     2.0 * np.pi * rng.random(), ndim)
    r1, v1, r2, v2 = _binary_offsets(fp["abin2"], fp["ebin2"], m1, m2,
                                     2.0 * np.pi * rng.random(), ndim)
    r3, v3, r4, v4 = _binary_offsets(fp["abin2"], fp["ebin2"], m3, m4,
                                     2.0 * np.pi * rng.random(), ndim)
    return {
        "r": np.stack([RA + r1, RA + r2, RB + r3, RB + r4]),
        "v": np.stack([VA + v1, VA + v2, VB + v3, VB + v4]),
        "m": np.array([m1, m2, m3, m4]),
        "h": np.full(4, fp["rstar"]),
    }


_IC_REGISTRY = {
    "shocktube": shocktube_ic,
    "cdiscontinuity": cdiscontinuity_ic,
    "soundwave": soundwave_ic,
    "sedov": sedov_ic,
    "khi": khi_ic,
    "gresho": gresho_ic,
    "noh": noh_ic,
    "box": uniform_box_ic,
    "sphere": sphere_ic,
    "jeans": jeans_ic,
    "ewaldsine": jeans_ic,
    "ewaldsine2": ewaldsine2_ic,
    "ewaldslab": ewaldslab_ic,
    "ewaldcylinder": ewaldcylinder_ic,
    "bossbodenheimer": bossbodenheimer_ic,
    "bb": bossbodenheimer_ic,
    "plummer": plummer_hybrid_ic,
    "dustybox": dustybox_ic,
    "evrard": evrard_ic,
    "spitzer": spitzer_ic,
}

_NBODY_IC_REGISTRY = {
    "plummer": plummer_stars_ic,
    "binary": binary_ic,
    "triple": triple_ic,
    "quadruple": quadruple_ic,
}


def generate_nbody_ic(params) -> Dict[str, np.ndarray]:
    """The star set of a pure N-body run, keyed by the `ic` parameter."""
    name = params.stringparams["ic"]
    if name not in _NBODY_IC_REGISTRY:
        raise NotImplementedError(
            f"nbody ic {name!r} is not ported yet (ROADMAP queue 1, item "
            f"9); the port generates {sorted(_NBODY_IC_REGISTRY)}")
    return _NBODY_IC_REGISTRY[name](params)


def generate_ic(params, eos) -> Dict[str, np.ndarray]:
    """IC factory keyed by the `ic` parameter (SimulationIC.hpp:88-186),
    for the generators above."""
    name = params.stringparams["ic"]
    if name not in _IC_REGISTRY:
        raise NotImplementedError(
            f"ic {name!r} is not ported yet (ROADMAP queue 1, item 9); "
            f"the port generates {sorted(_IC_REGISTRY)}")
    if params.intparams["regularise_particle_ics"]:
        raise NotImplementedError(
            "regularise_particle_ics = 1 is not ported yet (ROADMAP queue "
            "1, item 9)")
    return _IC_REGISTRY[name](params, eos)
