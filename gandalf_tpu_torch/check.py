"""The slices' configurations and IC, and the comparison of each kernel
with its plain version on the same inputs.

``slice_params`` is the configuration of the JAX package's benchmark
(``bench.build_sim(n_side, self_gravity)``) and ``jittered_box_ic`` its
jittered lattice (``bench.measure``); ``sphere_block_params`` is the
block-timestep cold collapse (``cold_sphere_block``).
``compare_kernels`` runs K1, K2 and K3 and their plain versions on one
state, on whatever device the state lives, and reports errors against
the tolerances below, and optionally times both; ``compare_tree_kernels``
does the same for the tree kernels K4-K7, and ``compare_active_kernels``
for the block tick's K8, K9 and the group-list launches of K6 and K7.
``gravity_accuracy`` holds the tree's accelerations against the direct
sum.  ``mfv_params`` is the meshless finite-volume configuration
``mfv_box``; ``compare_mfv_kernels`` compares K10-K12 and K7's MFV mode
with their plain versions, and ``mfv_gravity_accuracy`` holds the MFV
tree against the all-pairs ``mfv_smoothed_gravity``.  ``nbody_params``
is the N-body configuration ``plummer_cluster``; ``compare_nbody_kernels``
compares K13-K15 with their plain versions.  ``jeans_params`` is the
periodic self-gravitating configuration ``ewald_jeans_box`` (the Ewald
sum), and ``periodic_gravity_accuracy`` holds a periodic tree against
the min-imaged direct sum plus each pair's Ewald correction;
``compare_tree_kernels`` takes each walk option (the Ewald sum, the
gadget2 and eigenmac MACs, the fast multipoles) of the simulation it is
given.  ``chip_smoke.py`` and the CUDA tests use them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _ext
from .ops import active_grid as ag
from .ops import mfv as mfv_ops
from .ops import mfv_grid27 as mg
from .ops import sph_grid27 as g27
from .ops import tree as tr
from .ops.density import finish_h
from .ops.sph_gravity import direct_sph_gravity
from .params import Parameters
from .sim.ic import generate_ic
from .state import OPEN, DomainBox

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
# float32, K3 on a quiet lattice (the Jeans box: a regular lattice with
# a 2.5% density mode and no jitter): the pressure force is a residual of
# pair terms that cancel almost exactly, so the same rounding shows at a
# larger fraction of its largest value: 2.8e-4 on the card at 64^3.
TOL_F32_FORCES_QUIET = 1e-3
# K5 in float64: each level's fields within 1e-12 of the level's largest
# value of the field; the quadrupole's scale is max m*|half|^2, since a
# near-uniform cell's traceless quadrupole is itself a cancellation.
TOL_F64_TREE_BUILD = 1e-12
# float32, K5: sums over 32 slots and over child pairs in another order,
# each rounded at 6e-8; errors stay far below 1e-5 of the scale.
TOL_F32_TREE_BUILD = 1e-5
# K6: the MAC takes the same rounded steps in both versions (see
# ops/tree.py), so near lists and overflow agree exactly in both
# precisions; the bound still admits MAC flips (cells whose test lies
# within rounding of 0) in at most 1e-4 of the groups.  float32 far
# field: a few hundred multipole terms per slot, rounded at 6e-8 and
# summed in another order; within 1e-4 of the largest |a| and pot.
TOL_TREE_FLIP_FRACTION = 1e-4
TOL_F32_TREE_FAR = 1e-4
# float32, K7: ~3,000 partners per slot, most of them Newtonian terms of
# one sign; summation order moves a and gpot by ~1e-6 of their maxima.
TOL_F32_TREE_NEAR = 1e-4
# float32, K7 with the Ewald sum: in a near-uniform periodic box the net
# field and the potential (whose background term makes it hover about 0)
# are small residuals of the pair terms and their corrections, so the
# same rounding, summed in another order, shows at a larger fraction of
# their maxima: on the card (Jeans and MFV boxes at 16^3) 9.8e-5 of the
# largest |a| and up to 3.7e-4 of the largest |gpot|.
TOL_F32_EWALD_NEAR = 1e-3
# float32, K11: E and the two gradient sums over ~60 pairs each, rounded
# at 6e-8 and summed in another order (and with fused multiply-adds on
# the card); B = E^-1 and the gradients move by ~1e-6 of their largest
# values, the cell alphas (a clipped ratio) by as much relative to 1.
# A bad-gradient flag may flip where |E|^2|B|^2/9 lies within rounding of
# 1e4: at most 1e-3 of the particles.
TOL_F32_MFV_GRADIENTS = 1e-4
TOL_F32_MFV_BAD_FRACTION = 1e-3
# float32, K12: each particle's dQdt is the sum of ~60 face fluxes of
# order p |A| that cancel to a net one to two orders smaller in a
# near-uniform medium, so the rounding of the terms (6e-8 each) shows
# at ~1e-5 of the largest net value; the Gizmo clamp and the HLLC wave
# choice take the same branch except within rounding of a tie.
TOL_F32_MFV_FLUXES = 1e-3
# K13-K15 (all-pairs sums over the stars), each output's largest error
# relative to its largest |value|.  float64: the same formulas, the sums
# in another order (the kernel's tiles against torch's reductions) and
# with fused multiply-adds on the card; 1e-12 leaves room for N up to
# 65,536 terms.  float32: each term is rounded at 6e-8 and the N terms
# are summed in another order; the error grows like sqrt(N) 6e-8 of the
# sum of |terms|, which for the jerk and snap of a star in the crowded
# core is some 10-100 times its own largest value: 1e-4 at N = 8,192.
TOL_F64_NBODY = 1e-12
TOL_F32_NBODY = 1e-4

# The least time the card could take for a kernel's work (its bound):
# the larger of the bytes it must move (each input read once, each output
# written once) over the memory rate and its operations over the peak
# rate of their type.  Published rates of one H100 SXM at its full 700 W
# (NVIDIA's data sheet; float arithmetic outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# Operations per unit of work, counted by hand from each kernel's source
# (a multiply, add, compare, square root or division counts one): per
# particle (K1), per slot (K4), per slot and per cell (K5), per pair
# within a support (kernrange h_i for K2, K8, K10, K11; kernrange
# max(h_i, h_j) for K3, K9, K12), per live cell tested and per accepted
# cell and slot (K6; with the fast multipoles per accepted cell, the
# field and its Jacobian, and per live slot the expansion in K7), per
# near pair (K7), per ordered pair of distinct stars in 3D (K13 with the
# jerk, K14 with the jerk and beyond the kernel's support, where nearly
# every pair of the Plummer cluster lies, K15).  The accuracy MACs add
# their test to each cell tested (eigenmac's power counted as 20), the
# Ewald sum its min-image to each MAC test (3 x 4) and to each far term
# and near pair the min-image and the correction: 35 operations of the
# trilinear lookup and the sign, plus its 8 corner loads counted as one
# each.  The pair work counts one sweep of the h iterations, the least
# the data needs.
FLOPS_PER = {
    "grid27_bin": 15, "grid27_density": 40, "grid27_forces": 80,
    "tree_gather": 10, "tree_build_slot": 30, "tree_build_cell": 60,
    "tree_walk_mac": 15, "tree_walk_far": 60, "tree_near": 20,
    "mac_gadget2": 5, "mac_eigenmac": 35, "mac_ewald": 12,
    "tree_walk_fast": 100, "tree_near_fast": 25, "ewald_pair": 55,
    "active_density": 40, "active_forces": 80,
    "mfv_density": 40, "mfv_gradients": 120, "mfv_fluxes": 450,
    "direct_nbody": 46, "direct_softened": 66, "direct_snap": 74,
}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _work(inputs, outputs, flops):
    return {"bytes": _nbytes(*inputs) + _nbytes(*outputs),
            "flops": int(flops)}


def bound(work, dtype):
    """(ms, "bytes" or "operations") of a report's work in `dtype`."""
    t_mem = work["bytes"] / HBM_BYTES_PER_S
    t_ops = work["flops"] / PEAK_FLOPS[dtype]
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                     else "operations")


def _support_counts(row, col, d2, h, kernrange):
    """Pairs of a pair list within kernrange h_row, and within
    kernrange max(h_row, h_col)."""
    rad_i = kernrange * h[row]
    rad_ij = kernrange * torch.maximum(h[row], h[col])
    return (int((d2 < rad_i * rad_i).sum()),
            int((d2 < rad_ij * rad_ij).sum()))


def _slot_support_counts(spec, kern, ids_d, r, h, rows=None):
    """Support pair counts (see _support_counts) over the slot map, of
    all particles or of the rows `rows` (bool (N,))."""
    cut2 = (kern.kernrange * float(h.max())) ** 2 * (1.0 + 1e-6)
    row, col, _, d2 = mg.slot_pairs(spec, ids_d, r, cut2, True)
    if rows is not None:
        keep = rows[row]
        row, col, d2 = row[keep], col[keep], d2[keep]
    return _support_counts(row, col, d2, h, kern.kernrange)


def slice_params(n_side: int, tend: float = 1.0e30,
                 self_gravity: int = 0) -> Parameters:
    """3D periodic unit box, n_side^3 lattice, M4, energy_eqn (gamma 1.4),
    mon97 viscosity: bench.build_sim(n_side, self_gravity).  With
    self-gravity, the tree has no Ewald sum and its buckets are replanned
    every 32 steps, as in the benchmark."""
    p = Parameters()
    updates = {
        "run_id": "", "sim": "gradhsph", "ic": "box", "ndim": 3,
        "dimensionless": 1, "gas_eos": "energy_eqn", "gamma_eos": 1.4,
        "rhofluid1": 1.0, "press1": 1.0, "tend": tend,
        "tsnapfirst": 1.0e30, "self_gravity": self_gravity,
    }
    if self_gravity:
        updates.update({"ewald": 0, "ntreebuildstep": 32})
    for k in range(3):
        updates[f"boxmin[{k}]"] = 0.0
        updates[f"boxmax[{k}]"] = 1.0
        updates[f"boundary_lhs[{k}]"] = "periodic"
        updates[f"boundary_rhs[{k}]"] = "periodic"
        updates[f"Nlattice1[{k}]"] = n_side
    for k, v in updates.items():
        p.set(k, v)
    return p


def mfv_params(n_side: int, self_gravity: int = 1,
               tend: float = 1.0e30) -> Parameters:
    """The mfv_box configuration: slice_params(n_side, self_gravity) run
    through the meshless finite-volume MUSCL scheme (sim = meshlessfv)
    with the JAX package's defaults riemann_solver = hllc, slope_limiter
    = gizmo and zero_mass_flux = 1, and a global timestep."""
    p = slice_params(n_side, tend, self_gravity)
    p.set("sim", "meshlessfv")
    return p


def jeans_params(n_side: int, tend: float = 1.0e30,
                 ntreebuildstep: int = 32) -> Parameters:
    """The ewald_jeans_box configuration: GANDALF's Jeans test with the
    Ewald sum (tests/test_ewald.py:335-346): ic = jeans, a sinusoidal
    density perturbation of amplitude 0.025 along x on an n_side^3
    lattice (temp0 = mu_bar = 1), ewald = 1 with nEwaldGrid = 16 (a 16^3
    table) and ewald_mult = 1, in a 3D periodic unit box; every other
    option slice_params(n_side, self_gravity=1)'s (M4, energy_eqn gamma
    1.4, mon97, KDK global dt, quadrupole tree with the geometric MAC at
    theta^2 = 0.1, KD buckets of 32), the tree replanned every
    `ntreebuildstep` steps."""
    p = slice_params(n_side, tend, self_gravity=1)
    for k, v in {"ic": "jeans", "ewald": 1, "nEwaldGrid": 16,
                 "ewald_mult": 1.0, "amp": 0.025, "temp0": 1.0,
                 "mu_bar": 1.0, "ntreebuildstep": ntreebuildstep}.items():
        p.set(k, v)
    return p


def sphere_block_params(n_target: int, tend: float = 1.0e30,
                        ntreebuildstep: int = 32,
                        self_gravity: int = 1) -> Parameters:
    """The cold_sphere_block configuration: the JAX package's block and
    self-gravity test (tests/test_block.py:test_block_gravity_compact_
    freefall) as a cold collapse with hydro forces on.  A uniform sphere
    (mcloud 1, radius 1, cubic lattice of about `n_target` particles) in
    an open box, dimensionless, M4, energy_eqn with gamma 5/3 and press1
    1e-4, mon97 viscosity, courant 0.1 and accel 0.2, Nlevels 4 with
    level_diff_max 1, and (with `self_gravity`) quadrupole tree gravity
    with the geometric MAC theta^2 0.1 and KD buckets, rebuilt every
    `ntreebuildstep` ticks."""
    p = Parameters()
    updates = {
        "run_id": "", "sim": "gradhsph", "ic": "sphere", "ndim": 3,
        "Nhydro": n_target, "particle_distribution": "cubic_lattice",
        "mcloud": 1.0, "radius": 1.0, "dimensionless": 1,
        "hydro_forces": 1, "gas_eos": "energy_eqn",
        "press1": 1.0e-4, "self_gravity": self_gravity, "kernel": "m4",
        "courant_mult": 0.1, "accel_mult": 0.2, "Nlevels": 4,
        "level_diff_max": 1, "neib_search": "kdtree",
        "multipole": "quadrupole", "gravity_mac": "geometric",
        "thetamaxsqd": 0.1, "ntreebuildstep": ntreebuildstep,
        "tend": tend, "tsnapfirst": 1.0e30,
    }
    for k, v in updates.items():
        p.set(k, v)
    return p


def nbody_params(n_star: int = 65536, tend: float = 1.0e30,
                 **overrides) -> Parameters:
    """The plummer_cluster configuration: a Plummer cluster of `n_star`
    equal-mass stars (mplummer 1, rplummer 1, cut at radius 10,
    dimensionless, 3D) drawn by the reference's xorshift generator at the
    default randseed, integrated by the pure N-body controller (sim =
    nbody) with the defaults hermite4, Npec 1 and nbody_mult 0.1, and
    mean-h M4-softened gravity (nbody_softening 1) with rstar 0.01.
    `overrides` are further parameters (nbody, nbody_softening, ...)."""
    p = Parameters()
    updates = {
        "run_id": "", "sim": "nbody", "ndim": 3, "dimensionless": 1,
        "ic": "plummer", "Nstar": n_star, "mplummer": 1.0, "rplummer": 1.0,
        "radius": 10.0, "rstar": 0.01, "nbody": "hermite4", "Npec": 1,
        "nbody_mult": 0.1, "nbody_softening": 1, "rand_algorithm": "xorshift",
        "tend": tend, "tsnapfirst": 1.0e30,
    }
    updates.update(overrides)
    for k, v in updates.items():
        p.set(k, v)
    return p


def nbody_energy(s) -> float:
    """E = sum m v^2/2 - sum m gpot/2 of an NbodyState, in float64 (gpot
    is the softened potential under softening)."""
    m, v = s.m.double(), s.v.double()
    return float(torch.sum(0.5 * m * torch.sum(v * v, dim=-1))
                 - 0.5 * torch.sum(m * s.gpot.double()))


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


def _time_pairs(out, timed, repeats):
    """Kernel and plain times of each entry of `timed`, in the order
    plain, kernel, kernel, plain: each side's mean of two turns."""
    for name, (kfn, pfn) in timed.items():
        p1 = _time_ms(pfn, 1)
        k1 = _time_ms(kfn, repeats)
        k2 = _time_ms(kfn, repeats)
        p2 = _time_ms(pfn, 1)
        out[name]["ms"] = 0.5 * (k1 + k2)
        out[name]["plain_ms"] = 0.5 * (p1 + p2)


def _rel(x, ref, fill):
    """Largest elementwise relative error over filled slots."""
    return float((torch.abs(x - ref) / torch.abs(ref))[fill].max())


def _scaled(x, ref, fill):
    """Largest error over filled slots relative to the largest |ref|."""
    err = torch.abs(x - ref)[fill].max()
    return float(err / torch.abs(ref)[fill].max())


def compare_kernels(sim, state, repeats: int = 0, quiet: bool = False):
    """Run K1, K2, K3 and their plain versions on the same inputs, from a
    state on a CUDA device; returns {kernel: report}.  A report holds the errors,
    `ok` against this module's tolerances, `max_abs_err` of the primary
    output and, with `repeats` > 0, `ms` and `plain_ms`.  `quiet` takes
    K3's float32 tolerance for a quiet lattice (TOL_F32_FORCES_QUIET).
    Launch counts are restored afterwards, so comparisons never count as
    main-path launches."""
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
        "ok": max(errs.values()) <= (TOL_F64 if f64 else TOL_F32_FORCES_QUIET
                                     if quiet else TOL_F32_FORCES)}

    ids_d = ag.dense_ids(spec, b_p)
    n_i, n_ij = _slot_support_counts(spec, kern, ids_d, state.r, state.h)
    N = state.N
    out["grid27_bin"]["work"] = _work(
        (state.r,), (b_k.cell_of, b_k.slot_of), FLOPS_PER["grid27_bin"] * N)
    out["grid27_density"]["work"] = _work(
        (r_d, m_d, h_d, fill), s_k, FLOPS_PER["grid27_density"] * (n_i + N))
    out["grid27_forces"]["work"] = _work(
        (r_d, v_d, packed, fill), f_k, FLOPS_PER["grid27_forces"] * n_ij)

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
        _time_pairs(out, timed, repeats)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def gravity_inputs(sim, state):
    """The arguments of tree_gravity_grouped after gmap, as the
    simulation's gravity pass builds them: r, m, h, kern, zh and the
    periodic extent."""
    pdims = sim.box.periodic_dims()
    pext = ([sim.box.size[k] if k in pdims else 0.0 for k in range(3)]
            if pdims else None)
    return (state.r, sim._gravity_mass(state), state.h, sim.kern,
            state.zeta * state.hfactor, pext)


def walk_options(sim, state, spec=None):
    """The walk's options as the simulation's gravity pass passes them:
    (gfac, ewald), the accuracy MAC's per-group factor (None with the
    geometric MAC) and the (EwaldTable, periodic extent) pair (None
    without the Ewald sum)."""
    spec = spec or sim.treespec
    ptab, alive = tr.gather_to_buckets_plain(
        spec, state.bucket_map, state.r, state.m)
    mac_kw = _mac_kwargs(sim, state, spec)
    gfac = tr.mac_factors(spec, state.bucket_map, alive,
                          mac_kw.get("amag"), mac_kw.get("gpot_prev"),
                          dtype=state.r.dtype)
    ewald = (None if sim.ewald_table is None
             else (sim.ewald_table, sim._periodic_extent()))
    return gfac, ewald


def _mac_kwargs(sim, state, spec) -> dict:
    """The accuracy MAC's inputs as the simulation's gravity pass gives
    them for `spec` (the MFV controller gives none)."""
    if not hasattr(sim, "_mac_inputs"):
        return {}
    return sim._mac_inputs(state, spec)


def _tree_build_errors(spec, ctab, ref):
    """Per level and field, error relative to the level's scale of the
    field (K5 tolerance above); returns the largest.  Positions (com,
    centre) are compared on the scale of the particle set's extent, at
    least the root's half-width: the root of a sphere centred on the
    origin has a COM near 0, far below the rounding of its sum."""
    worst = 0.0
    fields = {"m": slice(tr.C_M, tr.C_M + 1),
              "com": slice(tr.C_COM, tr.C_COM + 3),
              "half": slice(tr.C_HALF, tr.C_HALF + 3),
              "q": slice(tr.C_Q, tr.C_Q + 6),
              "centre": slice(tr.C_CEN, tr.C_CEN + 3)}
    extent = float(ref[0, tr.C_HALF:tr.C_HALF + 3].abs().max())
    for ell in range(spec.depth + 1):
        x = tr.level_rows(spec, ctab, ell)
        y = tr.level_rows(spec, ref, ell)
        live = y[:, tr.C_M] > 0.0
        if not bool(live.any()):
            continue
        for name, cols in fields.items():
            err = torch.abs(x[:, cols] - y[:, cols])[live].max()
            if name == "q":
                half = y[:, tr.C_HALF:tr.C_HALF + 3]
                scale = (y[:, tr.C_M] * (half * half).sum(-1))[live].max()
            else:
                scale = torch.abs(y[:, cols])[live].max()
                if name in ("com", "centre"):
                    scale = max(float(scale), extent)
            worst = max(worst, float(err) / max(float(scale), 1e-300))
    # empty cells: equal m and sentinels
    same_empty = bool(torch.equal(ctab[:, tr.C_M] > 0, ref[:, tr.C_M] > 0))
    return worst, same_empty


def _scaled_all(x, ref, rows):
    """Largest error over `rows` relative to the largest |ref| there (0
    where both are 0)."""
    err = float(torch.abs(x - ref)[rows].max())
    return err / max(float(torch.abs(ref)[rows].max()), 1e-300)


def compare_tree_kernels(sim, state, repeats: int = 0, spec=None,
                         listed: bool = False, near: bool = True):
    """Run K4-K7 and their plain versions on the same inputs from a
    self-gravitating state on a CUDA device (an SPH or, in its zeta
    mode, an MFV simulation), with the walk options of the simulation's
    gravity pass (check.walk_options) and `spec` (default the
    simulation's TreeSpec); returns {kernel: report} as compare_kernels
    does, K6 and K7 under the names of their launch counts
    (_ext.launch_names),
    plus a forced-overflow case (near cap, one level cap and the support
    cap shrunk) where both versions must overflow.  `listed` also
    compares the group-list launches of K6 and K7 over every other group
    (no Ewald sum and the MACs' default factors, as the block tick's walk
    takes them, ROADMAP fault F11) under tree_walk_list and
    tree_near_list.  `near` False leaves K7 out: an accuracy MAC whose
    near lists reach the whole tree (gadget2 about a group of |a| near
    0) makes K7's plain version a chunked all-pairs sum, minutes at
    64^3, and K7 runs there in the mode the other paths hold.  Launch
    counts are restored afterwards."""
    saved = dict(_ext.LAUNCHES)
    spec = spec or sim.treespec
    gmap = state.bucket_map
    mfv = hasattr(state, "Qcons0")
    if mfv and listed:
        raise ValueError("the MFV zeta mode has no group-list launch")
    zeta = "mfv" if mfv else "sph"
    r, m, h, kern, zh, pext = (mfv_gravity_inputs if mfv
                               else gravity_inputs)(sim, state)
    gfac, ewald = walk_options(sim, state, spec)
    wname, nname = _ext.launch_names(spec, ewald is not None, mfv=mfv)
    f64 = r.dtype == torch.float64
    G, L = spec.n_leaves, spec.leaf_size
    out = {}

    # K4: exact (the unwrap's arithmetic is written to match)
    pk, ak = _ext.tree_gather(spec, gmap, r, m, h, zh, pext)
    pp, ap = tr.gather_to_buckets_plain(spec, gmap, r, m, h, zh, pext)
    same = bool(torch.equal(ak, ap)) and bool(torch.equal(pk, pp))
    out["tree_gather"] = {"equal": same,
                          "max_abs_err": float(torch.abs(pk - pp).max()),
                          "ok": same}

    # K5 on the plain slot table
    ck = _ext.tree_build(spec, pp, ap)
    cp = tr.build_tree_plain(spec, pp, ap)
    worst, same_empty = _tree_build_errors(spec, ck, cp)
    out["tree_build"] = {
        "scaled_err": worst, "same_empty_cells": same_empty,
        "max_abs_err": float(torch.abs(ck - cp)[cp[:, tr.C_M] > 0].max()),
        "ok": same_empty and worst <= (TOL_F64_TREE_BUILD if f64
                                       else TOL_F32_TREE_BUILD)}

    # K6 on the plain tree
    wkw = dict(gfac=gfac, ewald=ewald)
    wk = _ext.tree_walk(spec, cp, pp, ap, **wkw)
    wstats = {}
    wp = tr.tree_walk_plain(spec, cp, pp, ap, stats=wstats, **wkw)
    out[wname] = _walk_report(spec, wk, wp, ap, f64)
    out[wname]["mac"] = spec.mac
    out[wname]["fast"] = spec.fast
    out[wname]["ewald"] = ewald is not None

    N = r.shape[0]
    nargs = (spec, kern, cp, pp, ap, wp[2], wp[0], wp[1], gmap, N)
    nkw = dict(zeta_scaling=zeta, ewald=ewald)
    every = torch.ones((N,), dtype=torch.bool, device=r.device)
    if near:
        # K7 on the plain walk, results in particle order
        nk = _ext.tree_near(*nargs, **nkw)
        np_ = tr.tree_near_plain(*nargs, **nkw)
        errs = {"a": _scaled_all(nk[0], np_[0], every),
                "gpot": _scaled_all(nk[1], np_[1], every)}
        same_ovf = bool(nk[2]) == bool(np_[2])
        tol = (TOL_F64 if f64 else TOL_F32_EWALD_NEAR if ewald is not None
               else TOL_F32_TREE_NEAR)
        out[nname] = {
            "scaled_err": errs, "overflow": bool(nk[2]),
            "same_overflow": same_ovf, "zeta_scaling": zeta,
            "max_abs_err": float(torch.abs(nk[0] - np_[0]).max()),
            "ok": same_ovf and not bool(np_[2]) and max(errs.values()) <= tol}

    out["tree_gather"]["work"] = _work(
        (gmap, r, m, h, zh), (pk, ak), FLOPS_PER["tree_gather"] * G * L)
    out["tree_build"]["work"] = _work(
        (pp, ap), (ck,), FLOPS_PER["tree_build_slot"] * G * L
        + FLOPS_PER["tree_build_cell"] * ck.shape[0])
    out[wname]["work"] = _work(
        (cp, pp, ap, gfac), [x for x in wk if x is not None],
        _walk_flops(spec, ewald, wstats))
    if near:
        n_pairs = _near_pairs(spec, ap, wp[2])
        near_flops = (FLOPS_PER["tree_near"]
                      + (FLOPS_PER["ewald_pair"] if ewald else 0)) * n_pairs
        if spec.fast:
            near_flops += FLOPS_PER["tree_near_fast"] * int(ap.sum())
        out[nname]["work"] = _work(
            [x for x in (cp, pp, ap, wp[2], wp[0], wp[1], gmap)
             if x is not None], nk[:2], near_flops)

    # forced overflow: both versions must raise the flag
    lv = spec.depth // 2 + 1
    fl = list(spec.frontier_levels or [spec.level_cap(ell) if ell else 1
                                       for ell in range(spec.depth + 1)])
    fl[lv] = max(1, spec.level_cap(lv) // 4)
    tight = dataclasses.replace(spec, frontier_levels=tuple(fl))
    # below the longest near list: an accuracy MAC's caps never shrink,
    # so its near cap can be 4 times what this state needs
    need = int((wp[2] >= 0).sum(1).max())
    small = dataclasses.replace(
        spec, near_cap=max(1, min(spec.near_cap // 4, need - 1)))
    no_sup = dataclasses.replace(spec, support_cap=1)
    flags = {
        "level_cap": [bool(_ext.tree_walk(tight, cp, pp, ap, **wkw)[3]),
                      bool(tr.tree_walk_plain(tight, cp, pp, ap, **wkw)[3])],
        "near_cap": [bool(_ext.tree_walk(small, cp, pp, ap, **wkw)[3]),
                     bool(tr.tree_walk_plain(small, cp, pp, ap, **wkw)[3])]}
    if near:
        flags["support_cap"] = [
            bool(_ext.tree_near(no_sup, *nargs[1:], **nkw)[2]),
            bool(tr.tree_near_plain(no_sup, *nargs[1:], **nkw)[2])]
    out["forced_overflow"] = {"flags": flags, "ok": all(
        f == [True, True] for f in flags.values())}

    timed = {
        "tree_gather": (
            lambda: _ext.tree_gather(spec, gmap, r, m, h, zh, pext),
            lambda: tr.gather_to_buckets_plain(spec, gmap, r, m, h, zh,
                                               pext)),
        "tree_build": (lambda: _ext.tree_build(spec, pp, ap),
                       lambda: tr.build_tree_plain(spec, pp, ap)),
        wname: (lambda: _ext.tree_walk(spec, cp, pp, ap, **wkw),
                lambda: tr.tree_walk_plain(spec, cp, pp, ap, **wkw)),
    }
    if near:
        timed[nname] = (lambda: _ext.tree_near(*nargs, **nkw),
                        lambda: tr.tree_near_plain(*nargs, **nkw))

    if listed:
        # every other group, the block tick's walk (F11)
        group_ids = torch.arange(0, G, 2, dtype=torch.int32,
                                 device=r.device)
        lfac = tr.mac_factors(spec, gmap, ap, dtype=r.dtype)
        lk = _ext.tree_walk(spec, cp, pp, ap, group_ids, lfac)
        lstats = {}
        lp = tr.tree_walk_plain(spec, cp, pp, ap, group_ids, stats=lstats,
                                gfac=lfac)
        rows = torch.zeros((G,), dtype=torch.bool, device=r.device)
        rows[group_ids.long()] = True
        out["tree_walk_list"] = _walk_report(spec, lk, lp, ap, f64, rows)
        largs = (spec, kern, cp, pp, ap, lp[2], lp[0], lp[1], gmap, N,
                 group_ids)
        lnk = _ext.tree_near(*largs)
        lnp = tr.tree_near_plain(*largs)
        errs = {"a": _scaled_all(lnk[0], lnp[0], every),
                "gpot": _scaled_all(lnk[1], lnp[1], every)}
        same_ovf = bool(lnk[2]) == bool(lnp[2])
        out["tree_near_list"] = {
            "scaled_err": errs, "same_overflow": same_ovf,
            "max_abs_err": float(torch.abs(lnk[0] - lnp[0]).max()),
            "ok": (same_ovf and not bool(lnp[2]) and max(errs.values())
                   <= (TOL_F64 if f64 else TOL_F32_TREE_NEAR))}
        out["tree_walk_list"]["work"] = _work(
            (cp, pp, ap, group_ids), [x for x in lk if x is not None],
            _walk_flops(spec, None, lstats))
        out["tree_near_list"]["work"] = _work(
            [x for x in (cp, pp, ap, lp[2], lp[0], lp[1], gmap, group_ids)
             if x is not None], lnk[:2],
            FLOPS_PER["tree_near"] * _near_pairs(spec, ap, lp[2], group_ids))
        timed["tree_walk_list"] = (
            lambda: _ext.tree_walk(spec, cp, pp, ap, group_ids, lfac),
            lambda: tr.tree_walk_plain(spec, cp, pp, ap, group_ids,
                                       gfac=lfac))
        timed["tree_near_list"] = (lambda: _ext.tree_near(*largs),
                                   lambda: tr.tree_near_plain(*largs))

    if repeats > 0:
        _time_pairs(out, timed, repeats)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def _walk_report(spec, wk, wp, alive, f64, rows=None):
    """K6 against its plain version: near lists equal per group (MAC
    flips allowed in float32 only, in at most TOL_TREE_FLIP_FRACTION of
    the groups), overflow equal and false, and the far field (or the
    fast expansions) of the groups with equal near lists within
    tolerance.  `rows` (G,) bool restricts to the walked groups (list
    launches), whose other rows must be zero."""
    G, L = spec.n_leaves, spec.leaf_size
    if rows is None:
        rows = torch.ones((G,), dtype=torch.bool, device=alive.device)
    differ = (wk[2] != wp[2]).any(1)
    n_differ = int(differ.sum())
    live_g = alive.reshape(G, L).any(1)
    if spec.fast:
        same_rows = ~differ & rows & live_g
        far_k, far_p = {"fast": wk[0]}, {"fast": wp[0]}
        other = ~rows
    else:
        same_rows = (~differ & rows).repeat_interleave(L) & alive
        far_k, far_p = {"a": wk[0], "pot": wk[1]}, {"a": wp[0], "pot": wp[1]}
        other = ~rows.repeat_interleave(L)
    errs = ({k: _scaled_all(far_k[k], far_p[k], same_rows) for k in far_k}
            if bool(same_rows.any()) else {})
    zero_elsewhere = not any(bool(x[other].any()) for x in far_k.values())
    same_ovf = bool(wk[3]) == bool(wp[3])
    tol = TOL_F64 if f64 else TOL_F32_TREE_FAR
    first = next(iter(far_k))
    return {
        "groups": int(rows.sum()), "of": G,
        "groups_with_other_near_list": n_differ, "overflow": bool(wk[3]),
        "same_overflow": same_ovf, "scaled_err": errs,
        "zero_elsewhere": zero_elsewhere,
        "max_abs_err": float(torch.abs(far_k[first] - far_p[first])
                             [same_rows].max()) if bool(same_rows.any())
        else 0.0,
        "ok": (same_ovf and not bool(wp[3]) and zero_elsewhere
               and max(errs.values(), default=0.0) <= tol
               and n_differ <= (0 if f64 else
                                int(TOL_TREE_FLIP_FRACTION * G)))}


def _walk_flops(spec, ewald, wstats) -> int:
    """K6's operations from the plain walk's counts (FLOPS_PER)."""
    per_test = FLOPS_PER["tree_walk_mac"]
    if spec.mac != "geometric":
        per_test += FLOPS_PER[f"mac_{spec.mac}"]
    if ewald is not None:
        per_test += FLOPS_PER["mac_ewald"]
    extra = FLOPS_PER["ewald_pair"] if ewald is not None else 0
    if spec.fast:
        far = (FLOPS_PER["tree_walk_fast"] + extra) * wstats["fast_terms"]
    else:
        far = (FLOPS_PER["tree_walk_far"] + extra) * wstats["far_terms"]
    return per_test * wstats["mac_tests"] + far


def _near_pairs(spec, alive, near, group_ids=None) -> int:
    """Pairs K7 evaluates: live slots of each walked group times the live
    slots of its near leaves."""
    G, L = spec.n_leaves, spec.leaf_size
    live = alive.reshape(G, L).sum(1)
    per_leaf = torch.where(near >= 0, live[torch.clamp_min(near, 0).long()],
                           0).sum(1)
    pairs = live * per_leaf
    if group_ids is not None:
        pairs = pairs[group_ids.long()]
    return int(pairs.sum())


def gravity_accuracy(sim, n_sample: int = 2048, seed: int = 0,
                     among=None, spec=None):
    """The tree's gravitational acceleration at `n_sample` particles
    (numpy generator `seed`) against the float64 direct sum over all
    particles at the bucket-unwrapped positions, the sum the tree
    approximates without an Ewald sum.  `among` (int32 indices) samples
    from those particles only and walks only their buckets (the block
    tick's walk); `spec` replaces the simulation's TreeSpec (a monopole
    one, say), its accuracy MAC taking the inputs the simulation's
    gravity pass would give it.  Returns rms|da| / rms|a| and the walk's
    overflow."""
    s = sim.state
    r, m, h, kern, zh, pext = gravity_inputs(sim, s)
    spec = spec or sim.treespec
    gmap = s.bucket_map
    if among is None:
        a_tree, _, overflow = tr.tree_gravity_grouped(
            spec, gmap, r, m, h, kern, zh, pext,
            **_mac_kwargs(sim, s, spec))
        pool = np.arange(r.shape[0])
    else:
        a_tree, _, overflow = tr.tree_gravity_active(
            spec, gmap, r, m, h, kern, zh, sim._active_groups(among), pext)
        pool = among.cpu().numpy()
    ptab, alive = tr.gather_to_buckets(spec, gmap, r, m, h, zh, pext)
    r_unw = r.double().clone()
    r_unw[gmap.reshape(-1).long()[alive]] = ptab[alive, :3].double()
    idx = np.random.default_rng(seed).choice(
        pool, size=min(n_sample, len(pool)), replace=False)
    t = torch.as_tensor(np.sort(idx), device=r.device)
    a_ref, _ = direct_sph_gravity(kern, r_unw, m.double(), h.double(),
                                  s.zeta.double(), s.hfactor.double(),
                                  targets=t)
    da = a_tree[t].double() - a_ref
    err = torch.sqrt(torch.sum(da * da) / torch.sum(a_ref * a_ref))
    return {"n_sample": int(t.numel()), "rms_rel_err": float(err),
            "overflow": bool(overflow)}


def periodic_gravity_accuracy(sim, n_sample: int = 2048, seed: int = 0,
                              spec=None, ewald: bool = True):
    """The periodic tree's acceleration (K4-K7 with the simulation's
    Ewald table and walk options) at `n_sample` particles (numpy
    generator `seed`) against the float64 direct sum over all particles
    at min-image separations, kernel-softened, plus each pair's m_j
    times the Ewald correction: rms|da| / rms|a| and the walk's
    overflow.  `spec` replaces the simulation's TreeSpec; `ewald` False
    walks without the correction (what the gate must reject)."""
    s = sim.state
    mfv = hasattr(s, "Qcons0")
    r, m, h, kern, zh, pext = (mfv_gravity_inputs if mfv
                               else gravity_inputs)(sim, s)
    spec = spec or sim.treespec
    mac_kw = _mac_kwargs(sim, s, spec)
    a_tree, _, overflow = tr.tree_gravity_grouped(
        spec, s.bucket_map, r, m, h, kern, zh, pext,
        zeta_scaling="mfv" if mfv else "sph",
        ewald_table=sim.ewald_table if ewald else None, **mac_kw)
    idx = np.random.default_rng(seed).choice(
        r.shape[0], size=min(n_sample, r.shape[0]), replace=False)
    t = torch.as_tensor(np.sort(idx), device=r.device)
    if mfv:
        raise NotImplementedError("the periodic oracle takes SPH states")
    a_ref, _ = direct_sph_gravity(kern, r.double(), m.double(), h.double(),
                                  s.zeta.double(), s.hfactor.double(),
                                  targets=t, box=sim.box,
                                  ewald_table=sim.ewald_table)
    da = a_tree[t].double() - a_ref
    err = torch.sqrt(torch.sum(da * da) / torch.sum(a_ref * a_ref))
    return {"n_sample": int(t.numel()), "rms_rel_err": float(err),
            "rms_a": float(torch.sqrt(torch.mean(torch.sum(
                a_ref * a_ref, -1)))),
            "overflow": bool(overflow)}


def compare_active_kernels(sim, state, idx, repeats: int = 0):
    """Run K8, K9 and the group-list launches of K6 and K7 and their plain
    versions on the same inputs, from a block-slice state on a CUDA
    device: K8 and K9 for the particles idx (n,) int32, K6 and K7 for the
    buckets of idx (skipped without self-gravity).  K9 and K7 take the
    plain K8's and K6's outputs.  Returns {kernel: report} as
    compare_kernels does, with the tolerances of K2, K3, K6 and K7 and
    levelneib exactly equal.  Launch counts are restored afterwards.
    `idx` must not be empty."""
    saved = dict(_ext.LAUNCHES)
    spec, kern, visc = sim.gridspec, sim.kern, sim.visc
    f64 = state.r.dtype == torch.float64
    il = idx.long()
    out = {}

    # K8 on the plain binning's slot map; the finish is shared torch code
    b = g27.bin_particles_plain(spec, state.r)
    ids_d = ag.dense_ids(spec, b)
    hmax = g27.hmax_of(spec, kern.kernrange)
    kargs = (spec, kern, sim.h_fac, sim.h_converge, hmax, idx, b.cell_of,
             ids_d, state.r, state.m, state.h)
    pargs = (kern, spec) + kargs[2:]
    s_k = _ext.active_density(*kargs)
    s_p = ag.active_density_plain(*pargs)
    m_a = state.m[il]
    dens = {tag: finish_h(3, sim.h_fac, m_a, *sums)
            for tag, sums in (("kernel", s_k), ("plain", s_p))}
    every = torch.ones_like(m_a, dtype=torch.bool)
    errs = {f: (_scaled if f == "zeta" else _rel)(
        getattr(dens["kernel"], f), getattr(dens["plain"], f), every)
        for f in ("h", "rho", "invomega", "zeta")}
    same_done = bool(torch.equal(s_k[3], s_p[3]))
    rep = {"n": int(il.numel()), "rel_err": errs,
           "same_converged": same_done,
           "max_abs_err": float(torch.abs(dens["kernel"].rho
                                          - dens["plain"].rho).max())}
    if f64:
        rep["ok"] = same_done and max(errs.values()) <= TOL_F64
    else:
        rel = torch.abs(dens["kernel"].rho / dens["plain"].rho - 1.0)
        frac = float((rel > TOL_F32_DENSITY_TYPICAL).float().mean())
        rep["fraction_beyond_typical"] = frac
        rep["ok"] = (max(errs.values()) <= TOL_F32_DENSITY_MAX
                     and frac <= TOL_F32_DENSITY_FRACTION)
    out["active_density"] = rep

    # K9 on the state with the plain K8's rows written back
    dp = dens["plain"]
    u_a, p_a, c_a = sim.eos.thermal_update(torch.clamp_min(dp.rho, 1e-30),
                                           state.u[il])
    s2 = state.replace(**{f: getattr(state, f).index_copy(0, il, x)
                          for f, x in (("h", dp.h), ("rho", dp.rho),
                                       ("invomega", dp.invomega),
                                       ("hfactor", dp.hfactor),
                                       ("u", u_a), ("pressure", p_a),
                                       ("sound", c_a))})
    packed = torch.stack([getattr(s2, k) for k in g27.FORCE_SCALARS], -1)
    fargs = (spec, idx, b.cell_of, ids_d, s2.r, s2.v, packed, s2.level,
             s2.levelneib, sim.hydro_forces)
    f_k = _ext.active_forces(fargs[0], kern, visc, *fargs[1:])
    f_p = ag.active_forces_plain(kern, visc, *fargs)
    every3 = every[:, None].expand(f_k[0].shape)
    # without hydro forces both sides are zero and the errors 0
    errs = {name: _scaled_all(xk, xp, fl) for name, xk, xp, fl in
            zip(("a", "dudt", "div_v"), f_k[:3], f_p[:3],
                (every3, every, every))}
    same_lneib = bool(torch.equal(f_k[3], f_p[3]))
    out["active_forces"] = {
        "n": int(il.numel()), "scaled_err": errs,
        "same_levelneib": same_lneib,
        "levelneib_raised": int((f_p[3] != s2.levelneib).sum()),
        "max_abs_err": float(torch.abs(f_k[0] - f_p[0]).max()),
        "ok": same_lneib and max(errs.values())
        <= (TOL_F64 if f64 else TOL_F32_FORCES)}

    rows = torch.zeros((state.N,), dtype=torch.bool, device=state.r.device)
    rows[il] = True
    n_i, n_ij = _slot_support_counts(spec, kern, ids_d, s2.r, s2.h, rows)
    out["active_density"]["work"] = _work(
        kargs[5:], s_k, FLOPS_PER["active_density"] * (n_i + il.numel()))
    out["active_forces"]["work"] = _work(
        fargs[1:9], f_k, FLOPS_PER["active_forces"] * n_ij)
    timed = {
        "active_density": (lambda: _ext.active_density(*kargs),
                           lambda: ag.active_density_plain(*pargs)),
        "active_forces": (
            lambda: _ext.active_forces(fargs[0], kern, visc, *fargs[1:]),
            lambda: ag.active_forces_plain(kern, visc, *fargs)),
    }

    if sim.self_gravity:
        tspec, gmap = sim.treespec, state.bucket_map
        group_ids = sim._active_groups(idx)
        r, m, h, _, zh, pext = gravity_inputs(sim, state)
        G, L = tspec.n_leaves, tspec.leaf_size
        pp, ap = tr.gather_to_buckets_plain(tspec, gmap, r, m, h, zh, pext)
        cp = tr.build_tree_plain(tspec, pp, ap)
        gl = group_ids.long()
        listed = torch.zeros((G,), dtype=torch.bool, device=r.device)
        listed[gl] = True
        rows = listed.repeat_interleave(L) & ap

        # K6 over the list: listed rows and near lists, zeros elsewhere
        wk = _ext.tree_walk(tspec, cp, pp, ap, group_ids)
        wstats = {}
        wp = tr.tree_walk_plain(tspec, cp, pp, ap, group_ids, stats=wstats)
        differ = (wk[2] != wp[2]).any(1)
        n_differ = int(differ.sum())
        same_rows = ~differ.repeat_interleave(L) & rows
        errs = ({"a": _scaled_all(wk[0], wp[0], same_rows),
                 "pot": _scaled_all(wk[1], wp[1], same_rows)}
                if bool(same_rows.any()) else {})
        zero_elsewhere = (not bool(wk[0][~rows].any())
                          and not bool(wk[1][~rows].any()))
        same_ovf = bool(wk[3]) == bool(wp[3])
        tol = TOL_F64 if f64 else TOL_F32_TREE_FAR
        out["tree_walk_list"] = {
            "groups": int(gl.numel()), "of": G,
            "groups_with_other_near_list": n_differ,
            "same_overflow": same_ovf, "scaled_err": errs,
            "zero_elsewhere": zero_elsewhere,
            "max_abs_err": float(torch.abs(wk[0] - wp[0])[same_rows].max())
            if bool(same_rows.any()) else 0.0,
            "ok": (same_ovf and not bool(wp[3]) and zero_elsewhere
                   and max(errs.values(), default=0.0) <= tol
                   and n_differ <= (0 if f64 else
                                    int(TOL_TREE_FLIP_FRACTION * G)))}

        # K7 over the list on the plain walk, in particle order
        N = r.shape[0]
        nargs = (tspec, sim.kern, cp, pp, ap, wp[2], wp[0], wp[1], gmap, N,
                 group_ids)
        nk = _ext.tree_near(*nargs)
        np_ = tr.tree_near_plain(*nargs)
        mine = torch.zeros((N,), dtype=torch.bool, device=r.device)
        mine[gmap.reshape(-1).long()[rows]] = True
        errs = ({"a": _scaled_all(nk[0], np_[0], mine),
                 "gpot": _scaled_all(nk[1], np_[1], mine)}
                if bool(mine.any()) else {})
        zero_elsewhere = (not bool(nk[0][~mine].any())
                          and not bool(nk[1][~mine].any()))
        same_ovf = bool(nk[2]) == bool(np_[2])
        tol = TOL_F64 if f64 else TOL_F32_TREE_NEAR
        out["tree_near_list"] = {
            "scaled_err": errs, "same_overflow": same_ovf,
            "zero_elsewhere": zero_elsewhere,
            "max_abs_err": float(torch.abs(nk[0] - np_[0]).max()),
            "ok": (same_ovf and not bool(np_[2]) and zero_elsewhere
                   and max(errs.values(), default=0.0) <= tol)}
        out["tree_walk_list"]["work"] = _work(
            (cp, pp, ap, group_ids), wk,
            FLOPS_PER["tree_walk_mac"] * wstats["mac_tests"]
            + FLOPS_PER["tree_walk_far"] * wstats["far_terms"])
        out["tree_near_list"]["work"] = _work(
            (cp, pp, ap, wp[2], wp[0], wp[1], gmap, group_ids), nk[:2],
            FLOPS_PER["tree_near"] * _near_pairs(tspec, ap, wp[2],
                                                 group_ids))
        timed["tree_walk_list"] = (
            lambda: _ext.tree_walk(tspec, cp, pp, ap, group_ids),
            lambda: tr.tree_walk_plain(tspec, cp, pp, ap, group_ids))
        timed["tree_near_list"] = (lambda: _ext.tree_near(*nargs),
                                   lambda: tr.tree_near_plain(*nargs))

    if repeats > 0:
        _time_pairs(out, timed, repeats)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def mfv_gravity_inputs(sim, state):
    """The arguments of the MFV gravity pass after gmap: r, m, h, kern,
    zh and the periodic extent."""
    return (state.r, state.m, state.h, sim.kern, state.zeta * state.hfactor,
            sim._periodic_extent())


def compare_mfv_kernels(sim, state, repeats: int = 0):
    """Run K10, K11, K12 and (with self-gravity) K7 in its MFV zeta mode
    and their plain versions on the same inputs, from an MfvState on a
    CUDA device; returns {kernel: report} as compare_kernels does, under
    the names mfv_density, mfv_gradients, mfv_fluxes and tree_near_mfv.
    K12 takes the plain K11's outputs.  Launch counts are restored
    afterwards."""
    saved = dict(_ext.LAUNCHES)
    spec, kern = sim.gridspec, sim.kern
    f64 = state.r.dtype == torch.float64
    N = state.N
    every = torch.ones((N,), dtype=torch.bool, device=state.r.device)
    out = {}

    # K10 on the plain binning's slot map; the finish is shared torch code
    b = g27.bin_particles_plain(spec, state.r)
    ids_d = ag.dense_ids(spec, b)
    hmax = g27.hmax_of(spec, kern.kernrange)
    dargs = (sim.h_fac, sim.h_converge, hmax, ids_d, state.r, state.m,
             state.h)
    s_k = _ext.mfv_density(spec, kern, *dargs)
    s_p = mg.density_sums_plain(kern, spec, *dargs)
    dens = {tag: mg.density_finish(sim.h_fac, hmax, state.m, *sums)
            for tag, sums in (("kernel", s_k), ("plain", s_p))}
    errs = {f: (_scaled if f == "zeta" else _rel)(
        getattr(dens["kernel"], f), getattr(dens["plain"], f), every)
        for f in ("h", "ndens", "rho", "invomega", "zeta")}
    same_done = bool(torch.equal(s_k[3], s_p[3]))
    rep = {"rel_err": errs, "same_converged": same_done,
           "max_abs_err": float(torch.abs(dens["kernel"].h
                                          - dens["plain"].h).max())}
    if f64:
        rep["ok"] = same_done and max(errs.values()) <= TOL_F64
    else:
        rel = torch.abs(dens["kernel"].h / dens["plain"].h - 1.0)
        frac = float((rel > TOL_F32_DENSITY_TYPICAL).float().mean())
        rep["fraction_beyond_typical"] = frac
        rep["ok"] = (max(errs.values()) <= TOL_F32_DENSITY_MAX
                     and frac <= TOL_F32_DENSITY_FRACTION)
    out["mfv_density"] = rep

    # K11 on the state's fields
    gpk = torch.cat([state.h[:, None], state.ndens[:, None], state.Wprim,
                     state.sound[:, None]], -1).contiguous()
    g_k = mfv_ops.GradientResult(*_ext.mfv_gradients(spec, kern, ids_d,
                                                     state.r, gpk))
    g_p = mg.gradients_plain(kern, spec, ids_d, state.r, gpk)
    # a flag within rounding of the guard may flip in float32: compare the
    # other outputs where both took the same branch
    same = g_k.bad == g_p.bad
    rows3 = same[:, None, None]
    errs = {"B": _scaled_all(g_k.B, g_p.B, rows3.expand_as(g_p.B)),
            "grad": _scaled_all(g_k.grad, g_p.grad,
                                rows3.expand_as(g_p.grad)),
            "alpha_slope": float(torch.abs(g_k.alpha_slope
                                           - g_p.alpha_slope)[same].max()),
            "vsig_max": _scaled_all(g_k.vsig_max, g_p.vsig_max, every)}
    n_bad_differ = int((~same).sum())
    if f64:
        ok = n_bad_differ == 0 and max(errs.values()) <= TOL_F64
    else:
        ok = (n_bad_differ <= TOL_F32_MFV_BAD_FRACTION * N
              and max(errs.values()) <= TOL_F32_MFV_GRADIENTS)
    out["mfv_gradients"] = {
        "scaled_err": errs, "bad_flags_differ": n_bad_differ,
        "bad": int(g_p.bad.sum()),
        "max_abs_err": float(torch.abs(g_k.grad - g_p.grad).max()),
        "ok": ok}

    # K12 on the plain K11's outputs and the state's a0 and dt
    fpk = mg.pack_flux_fields(state.h, state.ndens, state.Wprim,
                              state.sound, state.a0, g_p.B, g_p.grad,
                              g_p.alpha_slope, g_p.bad)
    dt_t = state.dt
    f_k = _ext.mfv_fluxes(spec, kern, sim.mfv_cfg, dt_t, ids_d, state.r,
                          fpk)
    f_p = mg.fluxes_plain(kern, sim.mfv_cfg, spec, dt_t, ids_d, state.r, fpk)
    errs = {"dQdt": _scaled_all(f_k[0], f_p.dQdt, every[:, None]
                                .expand_as(f_p.dQdt)),
            "rdmdt_dot": _scaled_all(f_k[1], f_p.rdmdt_dot, every[:, None]
                                     .expand_as(f_p.rdmdt_dot))}
    out["mfv_fluxes"] = {
        "scaled_err": errs,
        "max_abs_err": float(torch.abs(f_k[0] - f_p.dQdt).max()),
        "ok": max(errs.values()) <= (TOL_F64 if f64 else TOL_F32_MFV_FLUXES)}

    n_i, n_ij = _slot_support_counts(spec, kern, ids_d, state.r,
                                     dens["plain"].h)
    out["mfv_density"]["work"] = _work(
        (ids_d, state.r, state.m, state.h), s_k,
        FLOPS_PER["mfv_density"] * (n_i + N))
    out["mfv_gradients"]["work"] = _work(
        (ids_d, state.r, gpk), g_k, FLOPS_PER["mfv_gradients"] * n_i)
    out["mfv_fluxes"]["work"] = _work(
        (ids_d, state.r, fpk, dt_t), f_k, FLOPS_PER["mfv_fluxes"] * n_ij)
    timed = {
        "mfv_density": (lambda: _ext.mfv_density(spec, kern, *dargs),
                        lambda: mg.density_sums_plain(kern, spec, *dargs)),
        "mfv_gradients": (
            lambda: _ext.mfv_gradients(spec, kern, ids_d, state.r, gpk),
            lambda: mg.gradients_plain(kern, spec, ids_d, state.r, gpk)),
        "mfv_fluxes": (
            lambda: _ext.mfv_fluxes(spec, kern, sim.mfv_cfg, dt_t, ids_d,
                                    state.r, fpk),
            lambda: mg.fluxes_plain(kern, sim.mfv_cfg, spec, dt_t, ids_d,
                                    state.r, fpk)),
    }

    if sim.self_gravity:
        # K7 in its MFV zeta mode on the plain walk, in particle order
        tspec, gmap = sim.treespec, state.bucket_map
        r, m, h, _, zh, pext = mfv_gravity_inputs(sim, state)
        pp, ap = tr.gather_to_buckets_plain(tspec, gmap, r, m, h, zh, pext)
        cp = tr.build_tree_plain(tspec, pp, ap)
        wp = tr.tree_walk_plain(tspec, cp, pp, ap)
        nargs = (tspec, kern, cp, pp, ap, wp[2], wp[0], wp[1], gmap, N)
        nk = _ext.tree_near(*nargs, zeta_scaling="mfv")
        np_ = tr.tree_near_plain(*nargs, zeta_scaling="mfv")
        errs = {"a": _scaled_all(nk[0], np_[0], every),
                "gpot": _scaled_all(nk[1], np_[1], every)}
        same_ovf = bool(nk[2]) == bool(np_[2])
        out["tree_near_mfv"] = {
            "scaled_err": errs, "same_overflow": same_ovf,
            "max_abs_err": float(torch.abs(nk[0] - np_[0]).max()),
            "ok": same_ovf and not bool(np_[2]) and max(errs.values())
            <= (TOL_F64 if f64 else TOL_F32_TREE_NEAR)}
        out["tree_near_mfv"]["work"] = _work(
            nargs[2:9], nk[:2],
            FLOPS_PER["tree_near"] * _near_pairs(tspec, ap, wp[2]))
        timed["tree_near_mfv"] = (
            lambda: _ext.tree_near(*nargs, zeta_scaling="mfv"),
            lambda: tr.tree_near_plain(*nargs, zeta_scaling="mfv"))

    if repeats > 0:
        _time_pairs(out, timed, repeats)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def mfv_gravity_accuracy(sim, n_sample: int = 2048, seed: int = 0,
                         spec=None):
    """The MFV tree's acceleration (K4-K7 with the MFV zeta term) at
    `n_sample` particles (numpy generator `seed`) against
    ops.mfv.mfv_smoothed_gravity in float64 over all particles at the
    bucket-unwrapped positions in an open box: the sum the tree
    approximates without an Ewald sum.  `spec` replaces the simulation's
    TreeSpec.  Returns rms|da| / rms|a| and the walk's overflow."""
    s = sim.state
    r, m, h, kern, zh, pext = mfv_gravity_inputs(sim, s)
    spec = spec or sim.treespec
    gmap = s.bucket_map
    a_tree, _, overflow = tr.tree_gravity_grouped(
        spec, gmap, r, m, h, kern, zh, pext, zeta_scaling="mfv")
    ptab, alive = tr.gather_to_buckets(spec, gmap, r, m, h, zh, pext)
    r_unw = r.double().clone()
    r_unw[gmap.reshape(-1).long()[alive]] = ptab[alive, :3].double()
    idx = np.random.default_rng(seed).choice(
        r.shape[0], size=min(n_sample, r.shape[0]), replace=False)
    t = torch.as_tensor(np.sort(idx), device=r.device)
    open_box = DomainBox(3, sim.box.boxmin, sim.box.boxmax, (OPEN,) * 3,
                         (OPEN,) * 3)
    # the oracle is O(N) per target: chunks of targets bound its memory
    step = max(1, (1 << 23) // r.shape[0])
    a_ref = torch.cat([mfv_ops.mfv_smoothed_gravity(
        kern, open_box, r_unw, m.double(), h.double(), s.zeta.double(),
        s.hfactor.double(), targets=t[c0:c0 + step])[0]
        for c0 in range(0, t.numel(), step)])
    da = a_tree[t].double() - a_ref
    err = torch.sqrt(torch.sum(da * da) / torch.sum(a_ref * a_ref))
    return {"n_sample": int(t.numel()), "rms_rel_err": float(err),
            "overflow": bool(overflow)}


def nbody_kernel_inputs(n_star: int, device, dtype, coincident: bool = True):
    """r, v, m, h (and the softening kernel) of a Plummer cluster of
    n_star stars from nbody_params, or of the 2D circular binary for
    n_star = 2, on `device` in `dtype`.  With `coincident`, star 1 is
    moved onto star 0 (n_star > 2), the case of a collapsed sub-system."""
    from .kernels.smoothing import kernel_factory
    from .sim.ic import generate_nbody_ic

    if n_star == 2:
        p = nbody_params(2, ic="binary", ndim=2, abin=1.0, ebin=0.0)
    else:
        p = nbody_params(n_star)
    ic = generate_nbody_ic(p)
    if coincident and n_star > 2:
        ic["r"][1] = ic["r"][0]
    kw = dict(device=device, dtype=dtype)
    return ([torch.as_tensor(ic[k], **kw).contiguous()
             for k in ("r", "v", "m", "h")],
            kernel_factory("m4", p.intparams["ndim"]))


def compare_nbody_kernels(r, v, m, h, kern, repeats: int = 0,
                          which=("direct_nbody", "direct_softened",
                                 "direct_snap")):
    """Run K13 (with the jerk), K14 (with and without the jerk) and K15
    (from the plain K13's a) and their plain versions on the same CUDA
    tensors; returns {kernel: report} as compare_kernels does, each
    output's error relative to its largest |value|, against TOL_*_NBODY.
    A report also holds `work` and the `dtype`; with `repeats` > 0, `ms`
    and `plain_ms` of the calls the path makes (with the jerk).  `which`
    picks the kernels.  Launch counts are restored afterwards."""
    from .ops import gravity as gr

    saved = dict(_ext.LAUNCHES)
    f64 = r.dtype == torch.float64
    tol = TOL_F64_NBODY if f64 else TOL_F32_NBODY
    N = r.shape[0]
    every = torch.ones((N,), dtype=torch.bool, device=r.device)
    pairs = N * (N - 1)

    def report(name, got, want, inputs, outputs):
        errs = {k: _scaled_all(x, y, every) for k, x, y in zip(
            ("a", "adot", "gpot"), got, want) if y is not None}
        return {"N": N, "ndim": r.shape[1], "scaled_err": errs,
                "max_abs_err": float(torch.abs(got[0] - want[0]).max()),
                "dtype": str(r.dtype), "ok": max(errs.values()) <= tol,
                "work": _work(inputs, outputs, FLOPS_PER[name] * pairs)}

    out, timed = {}, {}
    if "direct_nbody" in which or "direct_snap" in which:
        plain = gr.direct_nbody_plain(r, v, m, True)
    if "direct_nbody" in which:
        got = gr.direct_nbody(r, v, m, True)
        out["direct_nbody"] = report("direct_nbody", got, plain, (r, v, m),
                                     got)
        timed["direct_nbody"] = (lambda: gr.direct_nbody(r, v, m, True),
                                 lambda: gr.direct_nbody_plain(r, v, m,
                                                               True))
    if "direct_softened" in which:
        got = gr.direct_softened(r, v, m, h, kern, True)
        want = gr.direct_softened_plain(r, v, m, h, kern, True)
        rep = report("direct_softened", got, want, (r, v, m, h), got)
        # without the jerk: a and gpot as with it, adot exactly zero
        nj = gr.direct_softened(r, v, m, h, kern, False)
        wnj = gr.direct_softened_plain(r, v, m, h, kern, False)
        rep["no_jerk_scaled_err"] = {
            "a": _scaled_all(nj.a, wnj.a, every),
            "gpot": _scaled_all(nj.gpot, wnj.gpot, every)}
        rep["no_jerk_adot_zero"] = not bool(nj.adot.any())
        rep["ok"] = (rep["ok"] and rep["no_jerk_adot_zero"]
                     and max(rep["no_jerk_scaled_err"].values()) <= tol)
        out["direct_softened"] = rep
        timed["direct_softened"] = (
            lambda: gr.direct_softened(r, v, m, h, kern, True),
            lambda: gr.direct_softened_plain(r, v, m, h, kern, True))
    if "direct_snap" in which:
        a = plain.a
        got = gr.direct_snap(r, v, a, m)
        want = gr.direct_snap_plain(r, v, a, m)
        out["direct_snap"] = report("direct_snap", (got,), (want,),
                                    (r, v, a, m), (got,))
        timed["direct_snap"] = (lambda: gr.direct_snap(r, v, a, m),
                                lambda: gr.direct_snap_plain(r, v, a, m))
    if repeats > 0:
        _time_pairs(out, timed, repeats)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out
