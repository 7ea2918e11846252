"""The slice's configuration and IC, and the comparison of each kernel
with its plain version on the same inputs.

``slice_params`` is the hydro-only configuration of the JAX package's
benchmark (``bench.build_sim(n_side, self_gravity=0)``) and
``jittered_box_ic`` its jittered lattice (``bench.measure``).
``compare_kernels`` runs K1, K2 and K3 and their plain versions on one
state, on whatever device the state lives, and reports errors against
the tolerances below, and optionally times both.  ``chip_smoke.py`` and
the CUDA tests use it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gandalf_tpu.params import Parameters
from gandalf_tpu.sim.ic import generate_ic

from . import _ext
from .ops import sph_grid27 as g27

# Tolerances, kernel against plain version on the same inputs.
# float64: both evaluate the same formulas; only the order of the sums
# differs, which moves results by ~1e-15.
TOL_F64 = 1e-10
# float32, K2: summation order moves rho by ~1e-6 relative, which can
# let a particle sitting on the convergence test (|h - h(rho)|/h = 0.01)
# stop one fixed-point step earlier or later; that step moves h by less
# than h_converge = 1% and rho by less than that.  So every slot within
# 2e-2, and at most 0.1% of slots beyond 1e-4.
TOL_F32_DENSITY_MAX = 2e-2
TOL_F32_DENSITY_TYPICAL = 1e-4
TOL_F32_DENSITY_FRACTION = 1e-3
# float32, K3 (same dense inputs on both sides): ~60 pair terms inside
# the support, each rounded at 6e-8 relative, partly cancelling in a
# near-uniform medium; errors stay well below 1e-4 of the largest value.
TOL_F32_FORCES = 1e-4


def slice_params(n_side: int, tend: float = 1.0e30) -> Parameters:
    """3D periodic unit box, n_side^3 lattice, M4, energy_eqn (gamma 1.4),
    mon97 viscosity, no self-gravity: bench.build_sim(n_side, 0)."""
    p = Parameters()
    updates = {
        "run_id": "", "sim": "gradhsph", "ic": "box", "ndim": 3,
        "dimensionless": 1, "gas_eos": "energy_eqn", "gamma_eos": 1.4,
        "rhofluid1": 1.0, "press1": 1.0, "tend": tend,
        "tsnapfirst": 1.0e30, "self_gravity": 0,
    }
    for k in range(3):
        updates[f"boxmin[{k}]"] = 0.0
        updates[f"boxmax[{k}]"] = 1.0
        updates[f"boundary_lhs[{k}]"] = "periodic"
        updates[f"boundary_rhs[{k}]"] = "periodic"
        updates[f"Nlattice1[{k}]"] = n_side
    for k, v in updates.items():
        p.set(k, v)
    return p


def jittered_box_ic(params: Parameters, n_side: int, seed: int = 42):
    """The lattice IC with positions jittered by 0.2 spacing N(0,1) and
    velocities 0.05 N(0,1) (numpy generator `seed`)."""
    ic = generate_ic(params, None)
    rng = np.random.default_rng(seed)
    spacing = 1.0 / n_side
    ic["r"] = np.mod(ic["r"] + 0.2 * spacing
                     * rng.standard_normal(ic["r"].shape), 1.0)
    ic["v"] = 0.05 * rng.standard_normal(ic["v"].shape)
    return {k: ic[k] for k in ("r", "v", "m", "h", "u")}


def _time_ms(fn, repeats: int) -> float:
    """Mean milliseconds of fn() over `repeats` calls after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def _rel(x, ref, fill):
    """Largest elementwise relative error over filled slots."""
    return float((torch.abs(x - ref) / torch.abs(ref))[fill].max())


def _scaled(x, ref, fill):
    """Largest error over filled slots relative to the largest |ref|."""
    err = torch.abs(x - ref)[fill].max()
    return float(err / torch.abs(ref)[fill].max())


def compare_kernels(sim, state, repeats: int = 0):
    """Run K1, K2, K3 and their plain versions on the same inputs, from a
    state on a CUDA device; returns {kernel: report}.  A report holds the errors,
    `ok` against this module's tolerances, `max_abs_err` of the primary
    output and, with `repeats` > 0, `ms` and `plain_ms`.  Launch counts
    are restored afterwards, so comparisons never count as main-path
    launches."""
    saved = dict(_ext.LAUNCHES)
    spec, kern, visc = sim.gridspec, sim.kern, sim.visc
    f64 = state.r.dtype == torch.float64
    out = {}

    # K1 at the plan's K and at a K too small for the densest cell
    b_k = g27.bin_particles(spec, state.r)
    b_p = g27.bin_particles_plain(spec, state.r)
    tiny = dataclasses.replace(spec, k_cell=2)
    t_k = g27.bin_particles(tiny, state.r)
    t_p = g27.bin_particles_plain(tiny, state.r)
    mismatch = sum(int((x != y).sum()) for x, y in
                   ((b_k.cell_of, b_p.cell_of), (b_k.slot_of, b_p.slot_of),
                    (t_k.cell_of, t_p.cell_of), (t_k.slot_of, t_p.slot_of)))
    flags = [bool(b_k.overflow), bool(b_p.overflow), bool(t_k.overflow),
             bool(t_p.overflow)]
    out["grid27_bin"] = {
        "mismatches": mismatch, "overflow": flags,
        "max_abs_err": float(max(
            (b_k.cell_of - b_p.cell_of).abs().max(),
            (b_k.slot_of - b_p.slot_of).abs().max())),
        "ok": mismatch == 0 and flags == [False, False, True, True]}

    # K2 on the dense state; the finish is shared torch code
    d = lambda x: g27.to_dense(spec, b_p, x)  # noqa: E731
    fill = g27.dense_fill_mask(spec, b_p)
    r_d, v_d, m_d, h_d = d(state.r), d(state.v), d(state.m), d(state.h)
    hmax = g27.hmax_of(spec, kern.kernrange)
    args = (kern, spec, sim.h_fac, sim.h_converge, hmax, r_d, m_d, h_d, fill)
    s_k = _ext.grid27_density(spec, kern, sim.h_fac, sim.h_converge, hmax,
                              r_d, m_d, h_d, fill)
    s_p = g27.density_sums_plain(*args)
    dens = {tag: g27.density_finish(spec, sim.h_fac, hmax, m_d, fill, *sums)
            for tag, sums in (("kernel", s_k), ("plain", s_p))}
    errs = {f: (_scaled if f == "zeta" else _rel)(
        getattr(dens["kernel"], f), getattr(dens["plain"], f), fill)
        for f in ("h", "rho", "invomega", "zeta")}
    same_done = bool(torch.equal(s_k[3], s_p[3]))
    rep = {"rel_err": errs, "same_converged": same_done,
           "max_abs_err": float(torch.abs(dens["kernel"].rho
                                          - dens["plain"].rho)[fill].max())}
    if f64:
        rep["ok"] = same_done and max(errs.values()) <= TOL_F64
    else:
        rel = torch.abs(dens["kernel"].rho / dens["plain"].rho - 1.0)[fill]
        frac = float((rel > TOL_F32_DENSITY_TYPICAL).float().mean())
        rep["fraction_beyond_typical"] = frac
        rep["ok"] = (max(errs.values()) <= TOL_F32_DENSITY_MAX
                     and frac <= TOL_F32_DENSITY_FRACTION)
    out["grid27_density"] = rep

    # K3 on the plain density's outputs
    dp = dens["plain"]
    u_d, p_d, c_d = sim.eos.thermal_update(torch.clamp_min(dp.rho, 1e-30),
                                           d(state.u))
    fields = {"m": m_d, "h": dp.h, "rho": dp.rho, "u": u_d, "pressure": p_d,
              "sound": c_d, "invomega": dp.invomega, "hfactor": dp.hfactor,
              "alpha": d(state.alpha)}
    packed = torch.stack([fields[k] for k in g27.FORCE_SCALARS], dim=-1)
    f_k = _ext.grid27_forces(spec, kern, visc, r_d, v_d, packed, fill)
    f_p = g27.force_sums_plain(kern, visc, spec, r_d, v_d, packed, fill)
    fill3 = fill[..., None].expand(f_k[0].shape)
    errs = {name: _scaled(xk, xp, fl) for name, xk, xp, fl in
            zip(("a", "dudt", "div_v"), f_k, f_p, (fill3, fill, fill))}
    out["grid27_forces"] = {
        "scaled_err": errs,
        "max_abs_err": float(torch.abs(f_k[0] - f_p[0])[fill3].max()),
        "ok": max(errs.values()) <= (TOL_F64 if f64 else TOL_F32_FORCES)}

    if repeats > 0:
        timed = {
            "grid27_bin": (lambda: g27.bin_particles(spec, state.r),
                           lambda: g27.bin_particles_plain(spec, state.r)),
            "grid27_density": (
                lambda: _ext.grid27_density(spec, kern, sim.h_fac,
                                            sim.h_converge, hmax, r_d, m_d,
                                            h_d, fill),
                lambda: g27.density_sums_plain(*args)),
            "grid27_forces": (
                lambda: _ext.grid27_forces(spec, kern, visc, r_d, v_d,
                                           packed, fill),
                lambda: g27.force_sums_plain(kern, visc, spec, r_d, v_d,
                                             packed, fill)),
        }
        for name, (kfn, pfn) in timed.items():
            # plain, kernel, kernel, plain: each side's mean of two turns
            p1 = _time_ms(pfn, 1)
            k1 = _time_ms(kfn, repeats)
            k2 = _time_ms(kfn, repeats)
            p2 = _time_ms(pfn, 1)
            out[name]["ms"] = 0.5 * (k1 + k2)
            out[name]["plain_ms"] = 0.5 * (p1 + p2)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out

