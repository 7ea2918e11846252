"""Initial-condition generators of the port's configurations.

A copy of the generators of ``gandalf_tpu/sim/ic.py`` that the port's
slices use: the uniform box (``ic = box``) on a cubic lattice and the
uniform sphere (``ic = sphere``), lattice or random (numpy's generator,
``rand_algorithm = default``; the xorshift generator raises), with
``generate_ic``'s dispatch.  Host-side numpy in float64, as there; each
generator returns a dict with keys r, v, m, h, u.  Any other ``ic``, and
the Lloyd regularisation, raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..utils.rng import rng_from_params as _rng_from_params


def _sample_sphere(rng, n: int, ndim: int, radius: float) -> np.ndarray:
    """Uniform points in a sphere: batched rejection sampling from a
    numpy Generator."""
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


_IC_REGISTRY = {
    "box": uniform_box_ic,
    "sphere": sphere_ic,
}


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
