"""Initial-condition generators of the port's configurations.

A copy of the generators of ``gandalf_tpu/sim/ic.py`` that the port's
slices use: the uniform box (``ic = box``) on a cubic lattice, the
uniform sphere (``ic = sphere``), lattice or random (numpy's generator,
``rand_algorithm = default``; the xorshift generator's sphere sampler is
not ported and raises), and the periodic self-gravity tests of
EwaldIc.cpp (``jeans`` = ``ewaldsine``, ``ewaldsine2``, ``ewaldslab``,
``ewaldcylinder``), the Boss-Bodenheimer cloud (``bossbodenheimer`` =
``bb``) and the hybrid gas-and-star Plummer sphere (``plummer``), with
``generate_ic``'s dispatch; and the N-body star sets (``plummer``,
``binary``, ``triple``, ``quadruple``) with ``generate_nbody_ic``'s.
Host-side numpy in float64, as there; each hydro generator returns a
dict with keys r, v, m, h, u (the hybrid Plummer also ``star``: r, v, m,
h of its stars), each N-body one r, v, m, h.  Any other ``ic``, and the
Lloyd regularisation, raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

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


def add_lattice_sphere(n_target: int, radius: float, ndim: int = 3
                       ) -> np.ndarray:
    """Cubic-lattice points inside a sphere, tuned to ~n_target points
    (Ic::AddLatticeSphere, src/Ic/Ic.cpp)."""
    # binary-search the lattice resolution whose sphere cut best matches
    best = None
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
