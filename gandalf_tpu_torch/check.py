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
given, and its dead particles (K4's alive input).  ``bb_params`` is the
Boss-Bodenheimer sink collapse ``bb_sink_collapse`` (GANDALF's own
example); ``compare_sink_kernels`` compares K16-K18 with their plain
versions on ``sink_kernel_inputs`` (synthetic, with the edge cases) or
``sim_sink_inputs`` (a simulation's state), ``sink_ledger`` records each
step's sink gain against the mass the gas gave up, and ``gravity_accuracy``
adds the star-gas term on both sides when there are sinks.
``bb_block_params`` and ``plummer_block_params`` are the block-stepped
star-formation configurations (the Boss-Bodenheimer cloud and the hybrid
Plummer sphere with Nlevels > 1, smooth accretion and mm97 viscosity);
``compare_td_sink_kernels`` compares K20 (on ``smooth_accretion_inputs``
or a simulation's state), K21 at the grid's ndim and K22 with their
plain versions.
``sod_params``, ``khi_params`` and ``mirror_params`` are the 1D Sod
tube, the 2D Kelvin-Helmholtz instability and the mirror-wall box of the
JAX package's tests (``published_params`` reads GANDALF's examples as
written), ``mirror_ic`` the mirror tests' jittered lattice and
``sod_l1`` the Sod gate; ``compare_kernels`` takes grids of any ndim,
and ``compare_mirror_kernels`` compares K19, K1 with its discard mask
and K2/K3 on the mirror path's extended set with their plain versions.
``dustybox_params`` is the dusty box of the JAX package's dust tests and
``dust_params`` the dusty Evrard collapse (``dusty_evrard``);
``compare_dust_kernels`` compares K23 and K24 with their plain versions
on ``dust_kernel_inputs`` (synthetic, with the edge cases) or a
simulation's state, and ``dust_energy`` is a dust run's total energy.
``sm2012_params`` runs a configuration through SM2012SphSimulation,
``contact_params`` is the contact discontinuity of the JAX package's
SM2012 tests, ``plummer_stars_params`` the hybrid Plummer sphere with
accreting stars, ``extpot_box_params`` the external-potential box, and ``compare_sm2012_kernels`` compares K25 and K26 with
their plain versions on ``sm2012_kernel_inputs`` (synthetic, with the
edge cases) or a simulation's state.
``radws_params`` puts a configuration on the RadWS thermodynamics and
``radfb_params`` adds radiative feedback; ``compare_radws_kernels``
compares K27-K29 with their plain versions on ``radws_kernel_inputs``
(the synthetic ideal table or ``nonideal_table``, with both clamps) or
``radws_sim_inputs`` (a simulation's state), counting the elements
whose table indices differ, and ``compare_ambient_kernels`` compares
K30 on ``ambient_kernel_inputs`` or a simulation's particles and slots.
``chip_smoke.py`` and the CUDA tests use them.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from . import _ext
from .ops import active_grid as ag
from .ops import forces as fo
from .ops import mfv as mfv_ops
from .ops import mfv_grid27 as mg
from .ops import sinks as sk_ops
from .ops import sph_gravity as sg
from .ops import sph_grid27 as g27
from .ops import tree as tr
from .ops.density import finish_h
from .ops.sph_gravity import direct_sph_gravity
from .analysis.riemann import shocktube_solution
from .kernels.smoothing import VARIANTS
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
# K11's cell alpha of a variable whose gradient is rounding noise (below
# this fraction of the variable's largest gradient; float64, float32)
# follows the noise (ROADMAP fault F25) and is not compared; its limited
# gradient alpha * grad is, with the others
TOL_MFV_NOISE_GRAD = {True: 1e-10, False: 1e-4}
# float32, K12: each particle's dQdt is the sum of ~60 face fluxes of
# order p |A| that cancel to a net one to two orders smaller in a
# near-uniform medium, so the rounding of the terms (6e-8 each) shows
# at ~1e-5 of the largest net value; the Gizmo clamp and the HLLC wave
# choice take the same branch except within rounding of a tie.
TOL_F32_MFV_FLUXES = 1e-3
# float32, K31: a ratio per variable and pair, rounded at 6e-8, and the
# min over the pairs; an alpha moves by ~1e-6 where the same pair sets
# the min, and by up to 1 where a pair within rounding of the edge
# kernrange h_i, or a tvdscalar ratio within rounding of a clip, counts
# on one side only: at most 1e-3 of the particles beyond 1e-4.  K11's
# extrema (max(Wmax, W) - W) share the edge (mfv_exact_box's state at
# 64^3 had one particle 5% off in dWmin, NVIDIA H100 80GB HBM3, 700 W),
# and the cell alphas of such a particle follow its extrema: at most
# 1e-3 of the particles with an extremum beyond TOL_F32_MFV_GRADIENTS;
# on every other row the alphas and limited gradients are held to it.
TOL_F32_MFV_LIMITER = 1e-4
TOL_F32_MFV_LIMITER_FRACTION = 1e-3
# float32, K32 and K33: a signal velocity is one pair's (or cell pair's)
# terms, a dot product of ndim products, a square root and two divisions,
# each rounded at 6e-8 (and fused multiply-adds on the card), then a
# max; the same pair sets the max in both versions except within
# rounding of a tie, where the two values are as close.  1e-5 of each
# output's largest value.
TOL_F32_MFV_VSIG = 1e-5
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
# K16 in float32: the gas side sums Ns slot terms, the star side N gas
# terms of both signs (a star's net pull is a residual of pulls from all
# sides), each rounded at 6e-8 and summed in another order with fused
# multiply-adds: 1e-4 of each output's largest value, as K13-K15.  K18
# in float32: the masks are exact (the distance is computed in the same
# rounded steps on both sides) and the sums of up to a few hundred eaten
# particles' m, m v and m r within 1e-5 of their largest value.
TOL_F32_STAR_GAS = 1e-4
TOL_F32_ACCRETION = 1e-5
# K23 and K24 in float32, each output's largest error relative to its
# largest |value|.  A pair's Xi holds 1 - exp(-tau): near the branch at
# tau = 1e-3 the difference keeps 3 fewer digits than its operands, so
# an ulp of exp (6e-8) moves Xi by up to 6e-5 relative, and the card's
# expf and fused multiply-adds differ from torch's by such ulps; a_drag
# and the deposit then sum pair terms of both signs.  The maxima (the
# dust's sound speed, |dv|) and norm (a sum of positive terms) stay far
# inside the same bound.
TOL_F32_DRAG = 1e-3
# K25 in float32: the h-rho iteration of K2 and K8 with one more sweep,
# the q sum at the final h, so the same rule as K2 holds h, rho, q and
# hfactor (a particle on the convergence test may take one fixed-point
# step more or less, moving h by less than h_converge and rho and q by
# less than ndim times that).  K26 in float32 (the same packed inputs on
# both sides): a particle's force sums ~30-60 pair terms (the
# pressure-energy term and the viscosity) that cancel to a net one to
# two orders smaller where the medium is smooth; where u jumps, as at
# the KHI's interface, 1/q_i + 1/q_j sums two terms of different size,
# and the rounding of each term (6e-8) shows at ~1e-5 of the largest net
# value: 1e-3 of each output's largest value, as K3 on a quiet lattice.
TOL_F32_SM2012_FORCES = 1e-3
# K2, K3, K7, K8 and K9 with the quintic, gaussian and tabulated kernels
# (compare_family_kernels) keep the M4 tolerances above.  Their kernel
# functions take the plain version's rounded steps (csrc/
# kernel_family.cuh: no fused products in the quintic and gaussian, the
# same exp, IEEE division and square root), and K2, K3, K7 and K8 sum
# d^2 in the plain version's steps too, so a pair's W equals the plain
# version's wherever its h does; what differs is, as for M4, the order
# of the sums.  That matters: the quintic's derivative cancels some three
# digits near s = 2, so an ulp of s moves it by ~2e-5 relative in
# float32, and K3's |a| error at the 64^3 box fell from 2.9e-5 to 9.4e-6
# of the largest |a| when d^2 stopped being fused (NVIDIA H100 80GB
# HBM3, 700 W).  K9's plain version sums d^2 through torch.sum, whose
# order the kernel need not share.  At kernrange 3 a particle sums 3.4
# times M4's pairs, which moves a sum by sqrt(3.4) = 1.8 times as much:
# still inside the bounds.  A tabulated kernel takes the base polynomial
# at the table point floor(s/step) step; where a rounding difference in s
# or s^2 moves a pair across a table point, W jumps by |W'| step (~1e-3
# of W at res = 1000).  K3 and K7 form s from the plain version's d^2, so
# their indices agree wherever h does; K2 and K8 reach h by an iteration
# whose float32 sums differ in order, so their pairs near a table point
# can flip.  A flip moves rho by ~1e-3/~200 pairs = 5e-6, inside
# TOL_F32_DENSITY_TYPICAL.  compare_kernels counts the pairs within 4
# ulps of a table point ("table": "near_grid"), an upper bound on the
# flips.

# The least time the card could take for a kernel's work (its bound):
# the larger of the bytes it must move (each input read once, each output
# written once) over the memory rate and its operations over the peak
# rate of their type.  Published rates of one H100 SXM at its full 700 W
# (NVIDIA's data sheet; float arithmetic outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# Operations per unit of work, counted by hand from each kernel's source
# (a multiply, add, compare, square root or division counts one): per
# particle (K1, K17), per star-gas pair (K16: one evaluation feeding
# both sides' sums, with the M4 kernel's branch beyond its support and
# the extra work of the branches inside it, counted from the pairs'
# separations; K18: the distance test and the slot match), per
# slot (K4), per slot and per cell (K5), per pair
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
# the data needs.  K2 and K3 (and K8 and K9) in 2D and 1D drop the
# missing dims' share of a pair: 4 operations a dim of the separation
# for K2 and K8, 9 of the separation, dv, dvdr and the acceleration for
# K3 and K9; K1 5 a dim; K19
# one per reflected component and three for the keep test of an image.
# K20 counts per claimed (gas, sink) pair: its terms (distance, kernel,
# potential, log and the radial-drift product, about 70) and its share
# of the update (dm r, dm v and the spin's cross product, about 40).
# K21 per pair within kernrange h_i: the separation, the kernel
# derivative and 3 ndim^2 multiply-adds of the outer products (85, 50
# and 26 in 3D, 2D and 1D); K22 per pair within kernrange max(h_i, h_j),
# each particle with itself included: d^2, the radius and the compare
# (12).  K23 per cross-type candidate what the function needs there
# (the separation, d^2, dv and |dv|: 10 a dim; the d^2 > 0 and support
# tests and the two maxima: 8) and per pair inside the drag kernel's
# support what only such a pair needs (the kernel, the law, Xi and
# Lambda with one exp, S: 50; the unit vector, da, dv.r and da.r and
# the acceleration: 9 a dim); K24 per dust candidate of a gas
# target (d^2 and the support test: 2 plus 3 a dim) and per pair inside
# the support (the kernel and the payload's product, 14).  K25 per
# candidate visited in a sweep (the separation and d^2, 4 a dim; s and
# the support test, 3), two sweeps (one of the iteration, the least the
# data needs, and the q sweep), and per pair inside kernrange h_i the
# kernel and the sum, 12 in the rho sweep and 13 in the q sweep.  K26
# per candidate visited (d^2, 4 a dim, and the d^2 > 0 test) and per
# pair inside kernrange max(h_i, h_j): the two kernel derivatives, the
# pressure-energy term, du/dt and div v (38), the unit vector, dv.r and
# the acceleration (6 a dim), and for an approaching pair the viscosity
# (22).
FLOPS_PER = {
    "grid27_bin": 15, "grid27_density": 40, "grid27_forces": 80,
    "grid27_bin_2d": 10, "grid27_density_2d": 36, "grid27_forces_2d": 71,
    "grid27_bin_1d": 5, "grid27_density_1d": 32, "grid27_forces_1d": 62,
    "grid27_mirror": 4,
    "tree_gather": 10, "tree_build_slot": 30, "tree_build_cell": 60,
    "tree_walk_mac": 15, "tree_walk_far": 60, "tree_near": 20,
    "mac_gadget2": 5, "mac_eigenmac": 35, "mac_ewald": 12,
    "tree_walk_fast": 100, "tree_near_fast": 25, "ewald_pair": 55,
    "active_density": 40, "active_forces": 80,
    "active_density_2d": 36, "active_forces_2d": 71,
    "active_density_1d": 32, "active_forces_1d": 62,
    "mfv_density": 40, "mfv_gradients": 120, "mfv_fluxes": 450,
    "direct_nbody": 46, "direct_softened": 66, "direct_snap": 74,
    "star_gas_forces": 46, "star_gas_mid": 20, "star_gas_near": 11,
    "sink_candidate": 3, "accretion_sums": 15,
    "smooth_accretion": 110, "cullen_dehnen": 85, "cullen_dehnen_2d": 50,
    "cullen_dehnen_1d": 26, "levelneib": 12,
    "dust_drag_cross": 8, "dust_drag_cross_dim": 10,
    "dust_drag_pair": 50, "dust_drag_pair_dim": 9,
    "dust_drag_deposit_pair": 14, "dust_drag_deposit_cand": 2,
    "sm2012_density_cand": 3, "sm2012_density_cand_dim": 4,
    "sm2012_density_pair": 25, "sm2012_forces_cand": 1,
    "sm2012_forces_cand_dim": 4, "sm2012_forces_pair": 38,
    "sm2012_forces_pair_dim": 6, "sm2012_forces_approach": 22,
}
# K4-K7 below 3D: the same terms with fewer components (K4: 3 a dim for
# the unwrap and the copy, 1; K5: the COM, box and quadrupole sums; K6's
# MAC, 5 a dim, its quadrupole far field, whose Q.dr and dr.Q.dr shrink
# with the square of ndim, and the fast expansion's Jacobian, ndim^2
# terms; eigenmac's power, ~20, in every ndim; K7's separation and d^2
# per pair, 2 a dim, beside the rsqrt and the sums)
FLOPS_PER.update({
    "tree_gather_2d": 7, "tree_gather_1d": 4,
    "tree_build_slot_2d": 16, "tree_build_slot_1d": 7,
    "tree_build_cell_2d": 32, "tree_build_cell_1d": 13,
    "tree_walk_mac_2d": 10, "tree_walk_mac_1d": 5,
    "tree_walk_far_2d": 36, "tree_walk_far_1d": 18,
    "mac_gadget2_2d": 5, "mac_gadget2_1d": 5,
    "mac_eigenmac_2d": 26, "mac_eigenmac_1d": 22,
    "tree_walk_fast_2d": 55, "tree_walk_fast_1d": 25,
    "tree_near_2d": 16, "tree_near_1d": 12,
    "tree_near_fast_2d": 12, "tree_near_fast_1d": 5,
})


def tree_flops(name: str, ndim: int) -> int:
    """FLOPS_PER of tree term `name` (tree_walk_far, mac_eigenmac, ...)
    in `ndim` dims."""
    return FLOPS_PER[_ext.tree_count(name, ndim)]


# the operations a pair of the quintic, gaussian and tabulated kernels
# adds to M4's (K2 and K8: the three density polynomials; K3 and K9: two
# kernel derivatives).  Quintic: powers to s^7 and five- to seven-term
# polynomials (+16 for the density's three, +7 per derivative);
# gaussian: one exp (counted 20, as eigenmac's power) per pair and a few
# products (+2, +18 per derivative); a table adds the index (a division,
# a floor, a product; and the root of s^2 for K2, K8): +4 for the
# density, +4 per derivative.  K7's pairs count as M4's: the support tier
# is a few per cent of its near pairs.
_FAMILY_EXTRA = {"quintic": (16, 14), "gaussian": (2, 36),
                 "m4_tab": (4, 8), "quintic_tab": (20, 22),
                 "gaussian_tab": (6, 44)}
for _v, (_dd, _df) in _FAMILY_EXTRA.items():
    for _sfx in ("", "_2d", "_1d"):
        FLOPS_PER[f"grid27_density_{_v}{_sfx}"] = (
            FLOPS_PER[f"grid27_density{_sfx}"] + _dd)
        FLOPS_PER[f"grid27_forces_{_v}{_sfx}"] = (
            FLOPS_PER[f"grid27_forces{_sfx}"] + _df)
        FLOPS_PER[f"active_density_{_v}{_sfx}"] = (
            FLOPS_PER[f"active_density{_sfx}"] + _dd)
        FLOPS_PER[f"active_forces_{_v}{_sfx}"] = (
            FLOPS_PER[f"active_forces{_sfx}"] + _df)


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


def _star_gas_work(r, h, rs, hs):
    """K16's operations: FLOPS_PER["star_gas_forces"] for every pair
    (the M4 branch s >= 2), plus "star_gas_mid" for each pair at
    1 <= s < 2 and "star_gas_near" for each at s < 1, s = |dr| / hbar."""
    n_mid = n_near = 0
    step = max(1, (1 << 24) // max(rs.shape[0], 1))
    for c0 in range(0, r.shape[0], step):
        d = torch.cdist(r[c0:c0 + step], rs,
                        compute_mode="donot_use_mm_for_euclid_dist")
        s = d / (0.5 * (h[c0:c0 + step, None] + hs[None, :]))
        n_near += int((s < 1.0).sum())
        n_mid += int(((s >= 1.0) & (s < 2.0)).sum())
    return (FLOPS_PER["star_gas_forces"] * r.shape[0] * rs.shape[0]
            + FLOPS_PER["star_gas_mid"] * n_mid
            + FLOPS_PER["star_gas_near"] * n_near)


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
                 self_gravity: int = 0, ndim: int = 3) -> Parameters:
    """3D periodic unit box, n_side^3 lattice, M4, energy_eqn (gamma 1.4),
    mon97 viscosity: bench.build_sim(n_side, self_gravity).  With
    self-gravity, the tree has no Ewald sum and its buckets are replanned
    every 32 steps, as in the benchmark.  `ndim` 1 or 2 makes the same
    box in fewer dims (n_side^ndim particles)."""
    p = Parameters()
    updates = {
        "run_id": "", "sim": "gradhsph", "ic": "box", "ndim": ndim,
        "dimensionless": 1, "gas_eos": "energy_eqn", "gamma_eos": 1.4,
        "rhofluid1": 1.0, "press1": 1.0, "tend": tend,
        "tsnapfirst": 1.0e30, "self_gravity": self_gravity,
    }
    if self_gravity:
        updates.update({"ewald": 0, "ntreebuildstep": 32})
    for k in range(ndim):
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


def disc_params(n_target: int, ndim: int = 2, nlevels: int = 1,
                ntreebuildstep: int = 32, sim: str = "gradhsph",
                tend: float = 1.0e30) -> Parameters:
    """cold_sphere_block's configuration (sphere_block_params) at `ndim`
    1 or 2: a uniform disc (a rod in 1D) of mass 1 and radius 1 on a
    square lattice of about `n_target` particles in an open box, M4,
    energy_eqn with gamma 5/3 and press1 1e-4, mon97, the quadrupole
    tree with the geometric MAC at theta^2 0.1 over KD buckets of 32,
    rebuilt every `ntreebuildstep` steps, with a global timestep
    (`nlevels` 1) or block timesteps (level_diff_max 1), through `sim`
    (gradhsph, or mfvmuscl: MUSCL MFV)."""
    p = sphere_block_params(n_target, tend=tend,
                            ntreebuildstep=ntreebuildstep)
    p.set("ndim", ndim)
    p.set("Nlevels", nlevels)
    p.set("sim", sim)
    return p


def bb_params(n_target: int, rho_sink=None) -> Parameters:
    """The Boss-Bodenheimer collapse: GANDALF's own sink example
    (examples/bossbodenheimer.dat, read with Parameters.read_file) with
    Nhydro = n_target, no snapshots and no run id, and, when given,
    rho_sink (g cm^-3) in place of the file's 5e-13.  Everything else is
    the file's: physical units (pc, M_sun, Myr), a rotating 1 M_sun cloud
    with an m = 2 perturbation on a cubic lattice, the barotropic EOS,
    M4, mon97, a monopole tree with theta^2 = 0.15 over KD buckets, a
    global timestep (lfkdk), sink creation and plain accretion with
    sink_radius = 2 h."""
    p = Parameters()
    p.read_file(str(Path(__file__).resolve().parents[1] / "examples"
                    / "bossbodenheimer.dat"))
    updates = {"Nhydro": n_target, "tsnapfirst": 1.0e30, "dt_snap": 1.0e30,
               "run_id": ""}
    if rho_sink is not None:
        updates["rho_sink"] = rho_sink
    for k, v in updates.items():
        p.set(k, v)
    return p


def bb_block_params(n_target: int, rho_sink=2.0e-17) -> Parameters:
    """The bb_block_collapse configuration: bb_params(n_target,
    rho_sink) block-stepped (Nlevels = 5 with the file's level_diff_max
    = 2), with smooth accretion and time_dependent_avisc = mm97: the
    JAX package's star-formation setup (tests/test_sinks.py:179-215)
    on GANDALF's own collapse."""
    p = bb_params(n_target, rho_sink=rho_sink)
    for k, v in {"Nlevels": 5, "smooth_accretion": 1,
                 "time_dependent_avisc": "mm97"}.items():
        p.set(k, v)
    return p


def plummer_block_params(n_gas: int = 512, n_star: int = 16,
                         nlevels: int = 3) -> Parameters:
    """The hybrid Plummer sphere of tests/test_sinks.py:27-32 on the grid
    path (neib_search = kdtree): n_gas gas and n_star stars, half the
    mass each, dimensionless, energy_eqn, self-gravity, the stars
    accreting (create_sinks = 0), block-stepped (Nlevels = `nlevels`,
    level_diff_max = 1) with smooth accretion and mm97 viscosity."""
    p = Parameters()
    for k, v in dict(run_id="", sim="sph", ndim=3, ic="plummer",
                     Nhydro=n_gas, Nstar=n_star, gasfrac=0.5, starfrac=0.5,
                     self_gravity=1, hydro_forces=1, dimensionless=1,
                     gas_eos="energy_eqn", neib_search="kdtree",
                     sink_particles=1, create_sinks=0, Nlevels=nlevels,
                     level_diff_max=1, smooth_accretion=1,
                     time_dependent_avisc="mm97", tsnapfirst=1e30,
                     tend=1e30).items():
        p.set(k, v)
    return p


def plummer_stars_params(n_gas: int = 256, n_star: int = 8,
                         extpot: str = "none") -> Parameters:
    """The hybrid Plummer sphere of tests/test_torch_sink_sim.py with a
    global timestep: n_gas gas and n_star accreting stars (create_sinks =
    0), half the mass each, on the grid path with tree gravity,
    dimensionless, energy_eqn, in the external field `extpot` (plummer:
    mplummer 2, rplummer 0.5)."""
    p = Parameters()
    for k, v in dict(run_id="", sim="sph", ndim=3, ic="plummer",
                     Nhydro=n_gas, Nstar=n_star, gasfrac=0.5, starfrac=0.5,
                     self_gravity=1, hydro_forces=1, dimensionless=1,
                     gas_eos="energy_eqn", neib_search="kdtree",
                     sink_particles=1, create_sinks=0, tsnapfirst=1e30,
                     tend=1e30, external_potential=extpot, mplummer=2.0,
                     rplummer=0.5).items():
        p.set(k, v)
    return p


# the Spitzer HII region of tests/test_spitzer.py: the cloud's radius,
# mass and the Stromgren radius its source's Ndot sets (alphaB = mu_bar
# = 1)
SPITZER_RS = 0.35
SPITZER_RHO0 = 3.0 / (4.0 * math.pi)


def spitzer_params(n_hydro: int, radiation: str = "ionisation",
                   **over) -> Parameters:
    """tests/test_spitzer.py:21-29's configuration at n_hydro particles:
    the cold lattice sphere (ic = spitzer, mcloud = radius = 1),
    isothermal at temp0 1e-6 with temp_ion 0.05 and mu_ion = mu_bar = 1,
    no self-gravity, the grid path, the radiation field every step from
    the star (sink_particles 1, create_sinks 0), alphaB = 1, a global
    timestep; keyword overrides after."""
    p = Parameters()
    values = dict(run_id="", ndim=3, sim="sph", ic="spitzer",
                  Nhydro=n_hydro, mcloud=1.0, radius=1.0, dimensionless=1,
                  gas_eos="isothermal", gamma_eos=5.0 / 3.0, hydro_forces=1,
                  self_gravity=0, neib_search="kdtree", radiation=radiation,
                  nradstep=1, sink_particles=1, create_sinks=0,
                  temp_ion=0.05, mu_ion=1.0, mu_bar=1.0, arecomb=1.0,
                  Ndotmin=0.0, temp0=1e-6, courant_mult=0.1,
                  accel_mult=0.3, Nlevels=1, tsnapfirst=1e30, tend=1e30)
    values.update(over)
    for k, v in values.items():
        p.set(k, v)
    return p


def spitzer_ndot(radiation: str = "ionisation",
                 rs: float = SPITZER_RS) -> float:
    """The source's Ndot (alphaB = mu_bar = 1): 4 pi/3 rho0^2 Rs^3, whose
    Stromgren sphere has radius Rs (tests/test_spitzer.py:74); for
    treeray 4 pi rho0^2 Rs^3, whose OnTheSpot front, flux = alphaB n_H^2
    d, lies at Rs (tests/test_treeray.py:140)."""
    k = 4.0 * math.pi if radiation == "treeray" else 4.0 * math.pi / 3.0
    return k * SPITZER_RHO0 ** 2 * rs ** 3


def spitzer_star():
    """The IC's star: mass 1e-6 at rest at the origin, h 1e-3."""
    return {"r": np.zeros((1, 3)), "v": np.zeros((1, 3)),
            "m": np.asarray([1e-6]), "h": np.asarray([1e-3])}


def spitzer_table(ndot: float):
    """The flat stellar table of tests/test_spitzer.py:55-64: any mass
    gives `ndot`."""
    from .ops.stellar import StellarTable

    logn = math.log10(ndot)
    return StellarTable(mass=np.asarray([0.0, 1e3]), log_lum=np.zeros(2),
                        log_nlyc=np.asarray([logn, logn]),
                        teff=np.full(2, 4e4), mdot=np.zeros(2),
                        vwind=np.zeros(2))


def extpot_box_params(extpot: str, avert: float = -0.5) -> Parameters:
    """The uniform periodic box of tests/test_extpot.py:18-42 (a 6^3
    lattice in the unit box, energy_eqn gamma 1.4, rho 1, p 1) on the grid
    path (neib_search = kdtree) in the external field `extpot`: vertical
    along z with `avert`, or plummer (mplummer 1, rplummer 0.5)."""
    p = Parameters()
    for k, v in {"run_id": "", "sim": "gradhsph", "ic": "box", "ndim": 3,
                 "dimensionless": 1, "gas_eos": "energy_eqn",
                 "gamma_eos": 1.4, "rhofluid1": 1.0, "press1": 1.0,
                 "tend": 1e30, "tsnapfirst": 1e30,
                 "external_potential": extpot, "kgrav": 2, "avert": avert,
                 "mplummer": 1.0, "rplummer": 0.5,
                 "neib_search": "kdtree"}.items():
        p.set(k, v)
    for k in range(3):
        for key, val in (("boxmin", 0.0), ("boxmax", 1.0),
                         ("boundary_lhs", "periodic"),
                         ("boundary_rhs", "periodic"), ("Nlattice1", 6)):
            p.set(f"{key}[{k}]", val)
    return p


def dustybox_params(n: int = 32, ndim: int = 1, mirror_dim: int = None,
                    tend: float = 1.0e30, **over) -> Parameters:
    """The dusty box of tests/test_dust.py:20-40 on the grid path
    (neib_search = kdtree): an n^ndim gas lattice in the unit box,
    periodic (mirror walls at both ends of dim `mirror_dim` where one is
    given), rho 1, p 1,
    energy_eqn with gamma 5/3, the gas at rest and an equal-mass dust
    lattice (dust_mass_factor 1) moving at vx = 1, two-fluid drag with
    the fixed law, K = 1; `over` overrides any parameter."""
    p = Parameters()
    updates = {
        "run_id": "", "sim": "sph", "ic": "dustybox", "ndim": ndim,
        "dimensionless": 1, "rhofluid1": 1.0, "press1": 1.0,
        "gamma_eos": 1.6666666666666667, "vfluid1[0]": 0.0,
        "vfluid2[0]": 1.0, "dust_mass_factor": 1.0,
        "gas_eos": "energy_eqn", "hydro_forces": 1,
        "neib_search": "kdtree", "dust_forces": "full_twofluid",
        "drag_law": "fixed", "drag_coeff": 1.0, "tend": tend,
        "tsnapfirst": 1.0e30,
    }
    for k in range(ndim):
        side = "mirror" if k == mirror_dim else "periodic"
        updates.update({f"Nlattice1[{k}]": n, f"boxmin[{k}]": 0.0,
                        f"boxmax[{k}]": 1.0, f"boundary_lhs[{k}]": side,
                        f"boundary_rhs[{k}]": side})
    updates.update(over)
    for k, v in updates.items():
        p.set(k, v)
    return p


def dustybox_block_params() -> Parameters:
    """tests/test_dust.py:112-133's dusty box under block timesteps: the
    1D two-fluid box of dustybox_params (32 + 32 particles) with Nlevels
    3 and level_diff_max 1 on the grid path (the dense dust tick)."""
    return dustybox_params(32, 1, Nlevels=3, level_diff_max=1)


def dust_params(n_hydro: int, dust_forces: str = "full_twofluid",
                nlevels: int = 1, **over) -> Parameters:
    """The dusty_evrard configuration: GANDALF's Evrard collapse
    (EvrardCollapseIc.cpp; ic = evrard) with a dust copy of the gas: a
    1/r sphere of about n_hydro gas particles (mcloud 1, radius 1,
    thermal_energy 0.05) and as many dust particles of a hundredth of
    the mass (dust_mass_factor 0.01) offset by 0.01 h, in an open box,
    dimensionless, M4, energy_eqn with gamma 5/3, mon97, a global
    timestep (Nlevels = `nlevels` for block timesteps, level_diff_max
    1), quadrupole tree gravity with the geometric MAC at theta^2 0.1
    over KD buckets, and two-fluid (or test-particle) drag with the
    Epstein law, drag_coeff 1; `over` overrides any parameter."""
    p = Parameters()
    updates = {
        "run_id": "", "sim": "sph", "ic": "evrard", "ndim": 3,
        "Nhydro": n_hydro, "mcloud": 1.0, "radius": 1.0,
        "thermal_energy": 0.05, "dimensionless": 1,
        "gas_eos": "energy_eqn", "gamma_eos": 1.6666666666666667,
        "hydro_forces": 1, "self_gravity": 1, "kernel": "m4",
        "avisc": "mon97", "neib_search": "kdtree",
        "multipole": "quadrupole", "gravity_mac": "geometric",
        "thetamaxsqd": 0.1, "Nlevels": nlevels, "level_diff_max": 1,
        "dust_forces": dust_forces, "drag_law": "epstein",
        "drag_coeff": 1.0, "dust_mass_factor": 0.01, "tend": 1.0e30,
        "tsnapfirst": 1.0e30,
    }
    updates.update(over)
    for k, v in updates.items():
        p.set(k, v)
    return p


def sod_params(n1: int = 512, n2: int = 128, tend: float = 0.5,
               mirror: bool = False) -> Parameters:
    """The Sod tube of the JAX package's gate (tests/test_adsod.py:19-55)
    on the grid path (tests/test_grid_path.py:20-26): 1D, box [-2, 2]
    periodic (with `mirror`, mirror walls at both ends), n1 + n2
    lattice particles with rho 1 | 0.25 and p 1 | 0.1975 about x = 0,
    energy_eqn gamma 1.4, M4, mon97 (alpha 1, beta 2), h_converge 0.01,
    courant 0.2, accel 0.4, KDK with a global dt, to `tend`."""
    side = "mirror" if mirror else "periodic"
    p = Parameters()
    for k, v in {
            "run_id": "", "sim": "gradhsph", "ic": "shocktube", "ndim": 1,
            "vfluid1[0]": 0.0, "vfluid2[0]": 0.0, "press1": 1.0,
            "press2": 0.1975, "rhofluid1": 1.0, "rhofluid2": 0.25,
            "Nlattice1[0]": n1, "Nlattice2[0]": n2, "dimensionless": 1,
            "boxmin[0]": -2.0, "boxmax[0]": 2.0, "boundary_lhs[0]": side,
            "boundary_rhs[0]": side, "tend": tend, "tsnapfirst": 1.0e30,
            "dt_snap": 1.0e30, "hydro_forces": 1, "gas_eos": "energy_eqn",
            "gamma_eos": 1.4, "kernel": "m4", "h_converge": 0.01,
            "avisc": "mon97", "acond": "none", "alpha_visc": 1.0,
            "beta_visc": 2.0, "sph_integration": "lfkdk",
            "courant_mult": 0.2, "accel_mult": 0.4, "energy_mult": 0.5,
            "Nlevels": 1, "neib_search": "kdtree"}.items():
        p.set(k, v)
    return p


def khi_params(scale: int = 16, tend: float = 1.0e30,
               nlevels: int = 1) -> Parameters:
    """The Kelvin-Helmholtz instability of the JAX package's 2D gate
    (tests/test_ic_2d.py:36-53, the reference's hydro_tests/khi.dat):
    box [-0.5, 0.5]^2 periodic, rho 1 and 2 at p 2.5 shearing at v_x =
    +-0.5, a seeded mode of amplitude 0.1 and wavelength 0.5, energy_eqn
    gamma 1.4, M4, mon97, courant 0.2, accel 0.3, KDK with a global dt.
    The lattices 32x16 and 48x24 are scaled by `scale` per axis (16:
    512x256 and 768x384, 425,984 particles).  With `nlevels` > 1, block
    timesteps (level_diff_max 1) on the compacted tick."""
    p = Parameters()
    for k, v in {
            "run_id": "", "sim": "gradhsph", "ic": "khi", "ndim": 2,
            "dimensionless": 1, "gas_eos": "energy_eqn", "gamma_eos": 1.4,
            "kernel": "m4", "courant_mult": 0.2, "accel_mult": 0.3,
            "Nlevels": nlevels, "level_diff_max": 1,
            "neib_search": "kdtree", "rhofluid1": 1.0,
            "rhofluid2": 2.0, "press1": 2.5, "press2": 2.5, "amp": 0.1,
            "lambda": 0.5, "Nlattice1[0]": 32 * scale,
            "Nlattice1[1]": 16 * scale, "Nlattice2[0]": 48 * scale,
            "Nlattice2[1]": 24 * scale, "vfluid1[0]": 0.5,
            "vfluid2[0]": -0.5, "boxmin[0]": -0.5, "boxmax[0]": 0.5,
            "boxmin[1]": -0.5, "boxmax[1]": 0.5,
            "boundary_lhs[0]": "periodic", "boundary_rhs[0]": "periodic",
            "boundary_lhs[1]": "periodic", "boundary_rhs[1]": "periodic",
            "tend": tend, "tsnapfirst": 1.0e30, "dt_snap": 1.0e30}.items():
        p.set(k, v)
    return p


def block_sod_params(nlevels: int = 4, n1: int = 256, n2: int = 64,
                     tend: float = 0.25) -> Parameters:
    """The JAX package's block Sod tube (tests/test_block.py:21-44's
    _adsod_params, with neib_search = kdtree as :136 sets it): sod_params
    at n1 + n2 to `tend` with block timesteps, `nlevels` levels and
    level_diff_max 1, on the compacted tick."""
    p = sod_params(n1, n2, tend)
    p.set("Nlevels", nlevels)
    p.set("level_diff_max", 1)
    return p


def sedov_params(n_side: int, nlevels: int = 5) -> Parameters:
    """A 2D Sedov blast (the sedov IC, src/Ic/SedovBlastwaveIc.cpp, as
    tests/test_torch_copies.py sets it up): an n_side^2 lattice in the
    periodic box [-1, 1]^2, rho 1, the energy injected through the M4
    kernel in a central region of a few spacings (smooth_ic 1) with
    kefrac 0.3 of it kinetic, energy_eqn gamma 1.4, M4, mon97, block
    timesteps with `nlevels` levels and level_diff_max 1 on the grid path
    (the compacted tick).  The hot centre takes the finest levels and
    the cold lattice the coarsest."""
    p = Parameters()
    for k, v in {
            "run_id": "", "sim": "gradhsph", "ic": "sedov", "ndim": 2,
            "dimensionless": 1, "gas_eos": "energy_eqn", "gamma_eos": 1.4,
            "kernel": "m4", "avisc": "mon97", "rhofluid1": 1.0,
            "press1": 1.0, "kefrac": 0.3, "smooth_ic": 1,
            "Nlevels": nlevels, "level_diff_max": 1,
            "neib_search": "kdtree", "tend": 1.0e30, "tsnapfirst": 1.0e30,
            "dt_snap": 1.0e30}.items():
        p.set(k, v)
    for k in range(2):
        p.set(f"Nlattice1[{k}]", n_side)
        p.set(f"boxmin[{k}]", -1.0)
        p.set(f"boxmax[{k}]", 1.0)
        p.set(f"boundary_lhs[{k}]", "periodic")
        p.set(f"boundary_rhs[{k}]", "periodic")
    return p


def mfv_sod_params(n1: int = 512, n2: int = 128, tend: float = 0.5,
                   **over) -> Parameters:
    """The MFV Sod tube of the JAX package's gate (tests/test_mfv.py:
    15-35, the reference's AdSodMeshlessTest) on the grid path: 1D, box
    [-2, 2] periodic, n1 + n2 lattice particles with rho 1 | 0.25 and p 1
    | 0.1975, energy_eqn gamma 1.4, M4, h_converge 0.01, HLLC, the Gizmo
    limiter, zero mass flux, courant 0.2, accel 0.4, a global dt, to
    `tend`; `over` sets any other parameter (sim = mfvrk,
    riemann_solver, slope_limiter, static_particles, ...)."""
    p = Parameters()
    upd = {
        "run_id": "", "sim": "mfvmuscl", "ic": "shocktube", "ndim": 1,
        "press1": 1.0, "press2": 0.1975, "rhofluid1": 1.0,
        "rhofluid2": 0.25, "Nlattice1[0]": n1, "Nlattice2[0]": n2,
        "dimensionless": 1, "boxmin[0]": -2.0, "boxmax[0]": 2.0,
        "boundary_lhs[0]": "periodic", "boundary_rhs[0]": "periodic",
        "tend": tend, "dt_snap": 1.0e30, "tsnapfirst": 1.0e30,
        "gas_eos": "energy_eqn", "gamma_eos": 1.4, "kernel": "m4",
        "h_converge": 0.01, "riemann_solver": "hllc",
        "slope_limiter": "gizmo", "zero_mass_flux": 1, "courant_mult": 0.2,
        "accel_mult": 0.4, "Nlevels": 1, "neib_search": "kdtree"}
    upd.update(over)
    for k, v in upd.items():
        p.set(k, v)
    return p


def mfv_khi_params(n_side: int = 32, tend: float = 1.0e30,
                   **over) -> Parameters:
    """The 2D MFV box of the JAX package's grid-path gate
    (tests/test_mfv_grid.py:19-41): [0, 1]^2 periodic, two n_side^2
    lattices, rho 1 below and 2 above at p 2.5 and 1 (the default
    press2), at rest but for the seeded v_y mode (amp 0.1, lambda 0.5),
    energy_eqn gamma 5/3, M4, HLLC, the Gizmo limiter, zero mass flux,
    courant 0.2, accel 0.4, a global dt; `over` sets any other parameter.
    n_side 32 is the test's, 512 the 524,288-particle mfv_khi."""
    p = Parameters()
    upd = {
        "run_id": "", "sim": "mfvmuscl", "ic": "khi", "ndim": 2,
        "Nlattice1[0]": n_side, "Nlattice1[1]": n_side,
        "Nlattice2[0]": n_side, "Nlattice2[1]": n_side,
        "dimensionless": 1, "boxmin[0]": 0.0, "boxmax[0]": 1.0,
        "boxmin[1]": 0.0, "boxmax[1]": 1.0,
        "boundary_lhs[0]": "periodic", "boundary_rhs[0]": "periodic",
        "boundary_lhs[1]": "periodic", "boundary_rhs[1]": "periodic",
        "rhofluid1": 1.0, "rhofluid2": 2.0, "press1": 2.5,
        "gas_eos": "energy_eqn", "gamma_eos": 1.6666666666666667,
        "kernel": "m4", "riemann_solver": "hllc", "slope_limiter": "gizmo",
        "zero_mass_flux": 1, "courant_mult": 0.2, "accel_mult": 0.4,
        "Nlevels": 1, "tend": tend, "neib_search": "kdtree",
        "tsnapfirst": 1.0e30, "dt_snap": 1.0e30}
    upd.update(over)
    for k, v in upd.items():
        p.set(k, v)
    return p


def mfv_block_tube_params(nlevels: int, n1: int = 256, n2: int = 64,
                          limiter: str = "simple") -> Parameters:
    """The MFV Sod tube of the JAX package's block gate
    (tests/test_mfv_block.py:19-34) on the grid path: 1D, box [-2, 2]
    with open ends, n1 + n2 lattice particles, rho 1 | 0.25 and p 1 |
    0.1795 at rest, energy_eqn gamma 1.4, HLLC, the Gizmo limiter, tend
    0.2, `nlevels` levels and time_step_limiter `limiter` (every other
    option the defaults)."""
    p = Parameters()
    upd = {
        "run_id": "", "sim": "mfvmuscl", "ic": "shocktube", "ndim": 1,
        "dimensionless": 1, "gas_eos": "energy_eqn", "gamma_eos": 1.4,
        "riemann_solver": "hllc", "slope_limiter": "gizmo",
        "Nlattice1[0]": n1, "Nlattice2[0]": n2, "boxmin[0]": -2.0,
        "boxmax[0]": 2.0, "boundary_lhs[0]": "open",
        "boundary_rhs[0]": "open", "rhofluid1": 1.0, "press1": 1.0,
        "vfluid1[0]": 0.0, "rhofluid2": 0.25, "press2": 0.1795,
        "vfluid2[0]": 0.0, "tend": 0.2, "tsnapfirst": 1.0e30,
        "Nlevels": nlevels, "time_step_limiter": limiter,
        "neib_search": "kdtree"}
    for k, v in upd.items():
        p.set(k, v)
    return p


def mfv_block_sphere_params(n_target: int, ntreebuildstep: int = 32
                            ) -> Parameters:
    """The cold_sphere_block configuration (sphere_block_params: Nlevels
    4, level_diff_max 1, the quadrupole tree) through the MUSCL
    meshless finite-volume scheme (HLLC, the Gizmo limiter, zero mass
    flux) with the conservative timestep limiter: mfv_block_sphere."""
    p = sphere_block_params(n_target, ntreebuildstep=ntreebuildstep)
    p.set("sim", "mfvmuscl")
    p.set("time_step_limiter", "conservative")
    return p


def gresho_params(n_side: int = 32, tend: float = 0.3,
                  **over) -> Parameters:
    """The Gresho-Chan vortex of the JAX package's 2D gate
    (tests/test_ic_2d.py:78-109) through MFV: [-0.5, 0.5]^2 periodic, an
    n_side^2 lattice, gamma 1.4, M4, HLLC, courant 0.2, accel 0.3, a
    global dt, to `tend`."""
    p = Parameters()
    upd = {
        "run_id": "", "sim": "mfvmuscl", "ic": "gresho", "ndim": 2,
        "dimensionless": 1, "gas_eos": "energy_eqn", "gamma_eos": 1.4,
        "tsnapfirst": 1.0e30, "dt_snap": 1.0e30, "kernel": "m4",
        "courant_mult": 0.2, "accel_mult": 0.3, "Nlevels": 1,
        "neib_search": "kdtree", "riemann_solver": "hllc",
        "Nlattice1[0]": n_side, "Nlattice1[1]": n_side,
        "boxmin[0]": -0.5, "boxmax[0]": 0.5, "boxmin[1]": -0.5,
        "boxmax[1]": 0.5, "boundary_lhs[0]": "periodic",
        "boundary_rhs[0]": "periodic", "boundary_lhs[1]": "periodic",
        "boundary_rhs[1]": "periodic", "tend": tend}
    upd.update(over)
    for k, v in upd.items():
        p.set(k, v)
    return p


def gresho_l1(sim) -> float:
    """L1(v_phi) within r < 0.45 against the steady vortex
    (tests/test_ic_2d.py:96-109; the gate is 0.12)."""
    r = sim.state.r.double().cpu().numpy()
    v = sim.state.v.double().cpu().numpy()
    rad = np.sqrt((r ** 2).sum(-1)) + 1e-30
    vphi = (-v[:, 0] * r[:, 1] + v[:, 1] * r[:, 0]) / rad
    exact = np.where(rad < 0.2, 5.0 * rad,
                     np.where(rad < 0.4, 2.0 - 5.0 * rad, 0.0))
    mask = rad < 0.45
    return float(np.abs(vphi[mask] - exact[mask]).mean())


def mfv_soundwave_params(tend: float = 2.0) -> Parameters:
    """The MFV sound wave of the JAX package's regression
    (tests/test_soundwave.py:14-32 with sim = mfvmuscl, the M4 kernel and
    HLLC; gate L1(rho) < 2e-3, soundwave_l1) on the grid path
    (neib_search kdtree; the test runs the all-pairs path)."""
    p = soundwave_params(tend)
    p.set("sim", "mfvmuscl")
    p.set("kernel", "m4")
    p.set("riemann_solver", "hllc")
    return p


def jittered_lattice_ic(params: Parameters, seed: int = 7,
                        frac: float = 0.1):
    """The configuration's IC with positions moved by `frac` lattice
    spacings N(0,1) (numpy generator `seed`), wrapped into the periodic
    box: on an exact lattice a gradient component or a difference to a
    neighbour extremum that is 0 by symmetry is rounding noise in one
    order of the sums and 0 in another, and the cell limiters follow it
    (ROADMAP fault F25)."""
    ic = generate_ic(params, None)
    fp, nd = params.floatparams, params.intparams["ndim"]
    lo = np.array([fp[f"boxmin[{k}]"] for k in range(nd)])
    size = np.array([fp[f"boxmax[{k}]"] for k in range(nd)]) - lo
    spacing = (np.prod(size) / len(ic["m"])) ** (1.0 / nd)
    rng = np.random.default_rng(seed)
    r = ic["r"] + frac * spacing * rng.standard_normal(ic["r"].shape)
    ic["r"] = lo + np.mod(r - lo, size)
    return ic


# L1(vx) of the MFV Sod tube with the exact solver and tvdscalar
# (mfv_sod_params(riemann_solver="exact", slope_limiter="tvdscalar"), 512
# + 128 to t = 0.5) through the port's plain path on the CPU in float64,
# as tests/test_torch_mfv_dims.py::test_sod_tube_on_the_cpu reads it;
# chip_smoke.py holds the card's float64 run to it within 1e-9
MFV_EXACT_TUBE_L1 = 0.007004468589186162


# the five-step parity runs of MFV's options and its 1D and 2D grid path
# (tests/test_torch_mfv_dims.py against the JAX package, chip_smoke.py's
# mfv_dims_parity card against CPU): (configuration, jittered)
MFV_PARITY_CASES = {
    "tube": (lambda: mfv_sod_params(128, 32), False),
    "tube_mfvrk": (lambda: mfv_sod_params(128, 32, sim="mfvrk"), False),
    "tube_exact_tvdscalar": (lambda: mfv_sod_params(
        128, 32, riemann_solver="exact", slope_limiter="tvdscalar"), False),
    "tube_springel2009_static": (lambda: mfv_sod_params(
        128, 32, slope_limiter="springel2009", static_particles=1), False),
    "box2d_jittered_exact_tvdscalar": (lambda: mfv_khi_params(
        16, riemann_solver="exact", slope_limiter="tvdscalar"), True),
    "box2d_mfvrk_springel2009": (lambda: mfv_khi_params(
        16, sim="mfvrk", slope_limiter="springel2009"), False),
    "gresho_jittered": (lambda: gresho_params(16), True),
    "soundwave": (lambda: mfv_soundwave_params(), False),
}


def mfv_parity_case(name: str):
    """(params, IC or None) of MFV_PARITY_CASES[name]: None lets the
    controller generate the IC."""
    make, jitter = MFV_PARITY_CASES[name]
    params = make()
    return params, (jittered_lattice_ic(params) if jitter else None)


# the two wall layouts of tests/test_grid_mirror.py: (dim, lhs, rhs)
MIRROR_DIM0 = ((0, "mirror", "mirror"),)
MIRROR_MIXED = ((1, "mirror", "wall"), (2, "open", "mirror"))


def mirror_params(n_side: int, ndim: int = 3,
                  walls=MIRROR_DIM0) -> Parameters:
    """The mirror-wall box of tests/test_grid_mirror.py:22-41: a unit box
    of n_side^ndim lattice particles, rho 1, p 1, energy_eqn gamma 1.4
    (M4, mon97, KDK with a global dt), with the (dim, lhs, rhs)
    boundaries of `walls` and periodic dims elsewhere."""
    p = Parameters()
    updates = {
        "run_id": "", "sim": "gradhsph", "ic": "box", "ndim": ndim,
        "dimensionless": 1, "gas_eos": "energy_eqn", "gamma_eos": 1.4,
        "rhofluid1": 1.0, "press1": 1.0, "tend": 1.0e30,
        "tsnapfirst": 1.0e30, "neib_search": "kdtree",
    }
    wall_of = {k: (lhs, rhs) for (k, lhs, rhs) in walls}
    for k in range(ndim):
        updates[f"boxmin[{k}]"] = 0.0
        updates[f"boxmax[{k}]"] = 1.0
        lhs, rhs = wall_of.get(k, ("periodic", "periodic"))
        updates[f"boundary_lhs[{k}]"] = lhs
        updates[f"boundary_rhs[{k}]"] = rhs
        updates[f"Nlattice1[{k}]"] = n_side
    for k, v in updates.items():
        p.set(k, v)
    return p


def mirror_ic(params: Parameters, walls, seed: int = 7,
              jitter: float = 0.2):
    """tests/test_grid_mirror.py's jittered_state as an IC: the lattice
    jittered by `jitter` spacings N(0,1), clipped to [1e-4, 1 - 1e-4]
    along the wall dims and wrapped elsewhere, and v = 0.1 N(0,1)
    (numpy generator `seed`)."""
    ic = generate_ic(params, None)
    ndim = params.intparams["ndim"]
    rng = np.random.default_rng(seed)
    spacing = 1.0 / round(len(ic["m"]) ** (1.0 / ndim))
    r = ic["r"] + jitter * spacing * rng.standard_normal(ic["r"].shape)
    wall_dims = {k for (k, _, _) in walls}
    for k in range(ndim):
        if k in wall_dims:
            r[:, k] = np.clip(r[:, k], 1e-4, 1.0 - 1e-4)
        else:
            r[:, k] = np.mod(r[:, k], 1.0)
    ic["r"] = r
    ic["v"] = 0.1 * rng.standard_normal(ic["v"].shape)
    return {k: ic[k] for k in ("r", "v", "m", "h", "u")}


def published_params(name: str) -> Parameters:
    """GANDALF's examples/<name>.dat as written, but for no snapshots and
    no run id: adsod (the 1D Sod tube, 256 + 64 particles to t = 0.25)
    or khi (the 2D KHI, 64x64 + 64x64 to t = 1)."""
    p = Parameters()
    p.read_file(str(Path(__file__).resolve().parents[1] / "examples"
                    / f"{name}.dat"))
    for k, v in {"tsnapfirst": 1.0e30, "dt_snap": 1.0e30,
                 "run_id": ""}.items():
        p.set(k, v)
    return p


def sod_l1(sim) -> float:
    """L1(vx) over -1 < x < 1 against the exact Riemann solution at the
    simulation's time (tests/test_grid_path.py:29-43; the reference's
    gate is 9e-3 at 512 + 128 particles and t = 0.5)."""
    fp = sim.params.floatparams
    x = sim.state.r[:, 0].double().cpu().numpy()
    vx = sim.state.v[:, 0].double().cpu().numpy()
    sel = (x > -1.0) & (x < 1.0)
    sol = shocktube_solution(fp["rhofluid1"], fp["vfluid1[0]"], fp["press1"],
                             fp["rhofluid2"], fp["vfluid2[0]"], fp["press2"],
                             fp["gamma_eos"], -1.0, 0.0, 1.0, sim.t)
    v_ref = np.interp(x[sel], sol["x"], sol["vx"])
    return float(np.abs(vx[sel] - v_ref).mean())


def soundwave_params(tend: float = 2.0) -> Parameters:
    """The SPH sound wave of the JAX package's regression
    (tests/test_soundwave.py:14-32): 1D periodic unit box, 64 particles,
    amplitude 1e-3, isothermal (T0 1, mu 1), gaussian kernel, h_converge
    1e-3, courant 0.025, no viscosity, one period to t = 2, on the grid
    path (neib_search kdtree; the test runs the all-pairs path)."""
    p = Parameters()
    for k, v in {
            "run_id": "", "sim": "gradhsph", "ic": "soundwave", "ndim": 1,
            "Nhydro": 64, "rhofluid1": 1.0, "press1": 1.0, "amp": 0.001,
            "dimensionless": 1, "boxmin[0]": 0.0, "boxmax[0]": 1.0,
            "boundary_lhs[0]": "periodic", "boundary_rhs[0]": "periodic",
            "tend": tend, "dt_snap": 1.0, "tsnapfirst": 0.0,
            "gas_eos": "isothermal", "gamma_eos": 1.66666666666666666,
            "temp0": 1.0, "mu_bar": 1.0, "kernel": "gaussian",
            "h_converge": 0.001, "courant_mult": 0.025, "accel_mult": 0.1,
            "avisc": "none", "acond": "none", "Nlevels": 1,
            "neib_search": "kdtree"}.items():
        p.set(k, v)
    return p


def soundwave_l1(sim, xmin: float = 0.01, xmax: float = 0.99) -> float:
    """L1(rho) against the travelling linear wave at the simulation's
    time, as gandalf_tpu.analysis.compute.L1errornorm("soundwave", "x",
    "rho", 0.01, 0.99) takes it (the wave on a 2,000-point grid,
    interpolated at the particles inside the window); the JAX package's
    gate is 1e-4."""
    fp = sim.params.floatparams
    rho0, amp = fp["rhofluid1"], fp["amp"]
    xl, xr = fp["boxmin[0]"], fp["boxmax[0]"]
    if sim.params.stringparams["gas_eos"] == "isothermal":
        cs = math.sqrt(fp["temp0"] / fp["mu_bar"])
    else:
        cs = math.sqrt(fp["gamma_eos"] * fp["press1"] / rho0)
    lam = xr - xl
    ax = np.linspace(xl, xr, 2000)
    ay = rho0 * (1.0 + amp * np.sin(2.0 * math.pi / lam * ax
                                    - 2.0 * math.pi * cs / lam * sim.t))
    keep = (ax > xmin) & (ax < xmax)
    ax, ay = ax[keep], ay[keep]
    px = sim.state.r[:, 0].double().cpu().numpy()
    py = sim.state.rho.double().cpu().numpy()
    sel = (px > ax.min()) & (px < ax.max())
    px, py = px[sel], py[sel]
    return float(np.abs(py - np.interp(px, ax, ay)).sum() / px.size)


def family_params(variant: str, params: Parameters) -> Parameters:
    """`params` with the smoothing kernel of `variant` (a key of
    kernels.smoothing.VARIANTS, or "m4")."""
    name, tab = VARIANTS.get(variant, ("m4", 0))
    params.set("kernel", name)
    params.set("tabulated_kernel", tab)
    return params


def compare_family_kernels(variant: str, ndim: int, device, dtype,
                           repeats: int = 0):
    """K2 and K3 with the smoothing kernel `variant` against their plain
    versions, at `ndim`: on the Sod tube (sod_params(128, 32)) in 1D,
    the small KHI (khi_params(1)) in 2D and the jittered periodic box
    (16^3) in 3D.  In 3D also K4-K7 on that box with self-gravity (not
    with the gaussian: fault F23), and K8, K9 and the group-list K6/K7 on
    the cold block sphere (about 2,000 particles) for every other
    particle.  Returns {kernel: report} as compare_kernels does, under
    the kernels' family names.  In 1D and 2D also K8 and K9 for every
    other particle of the tube's and the KHI's states (block timesteps,
    Nlevels 3)."""
    from .sim.simulation import GradhSphSimulation

    ic = None
    if ndim == 1:
        p = block_sod_params(3, 128, 32)
    elif ndim == 2:
        p = khi_params(1, nlevels=3)
    else:
        grav = 0 if variant.startswith("gaussian") else 1
        p = slice_params(16, self_gravity=grav)
        ic = jittered_box_ic(p, 16)
    sim = GradhSphSimulation(family_params(variant, p), device, dtype)
    sim.SetupSimulation(ic)
    out = compare_kernels(sim, sim.state, repeats)
    if ndim < 3:
        every_other = torch.arange(0, sim.state.N, 2, dtype=torch.int32,
                                   device=sim.state.r.device)
        out.update(compare_active_kernels(sim, sim.state, every_other,
                                          repeats))
        return out
    if sim.self_gravity:
        out.update(compare_tree_kernels(sim, sim.state, repeats))
    p = family_params(variant, sphere_block_params(
        2000, self_gravity=int(sim.self_gravity)))
    sim = GradhSphSimulation(p, device, dtype)
    sim.SetupSimulation()
    idx = torch.arange(0, sim.state.N, 2, dtype=torch.int32,
                       device=sim.state.r.device)
    out.update(compare_active_kernels(sim, sim.state, idx, repeats))
    return out


def _near_grid(x, step, dtype) -> int:
    """Elements of x within 4 ulps (of `dtype`) of a multiple of step:
    those whose table index a rounding difference can move."""
    q = x.double() / step
    eps = float(torch.finfo(dtype).eps)
    return int((torch.abs(q - torch.round(q))
                <= 4.0 * eps * torch.clamp_min(q, 1.0)).sum())


def _table_report(rep2, rep3, kern, spec, r_d, fill, h_d):
    """Add to K2's and K3's reports of a tabulated kernel the pairs in
    support and those near a table point (an upper bound on the pairs
    whose index the kernel and its plain version can disagree on): on
    the s^2 grid at each particle's finished h for K2, on the s grid at
    both particles' h for K3."""
    rng, res = kern.kernrange, kern.table_res
    h = h_d.reshape(-1)
    cut2 = (rng * float(torch.max(torch.where(fill.reshape(-1), h, 0.0)))
            ) ** 2 * (1.0 + 1e-6)
    row, col, _, d2 = g27._pair_list(spec, r_d, fill, cut2, True)
    ssqd = d2 / (h[row] * h[row])
    sup = ssqd < rng * rng
    rep2["table"] = {"pairs": int(sup.sum()), "near_grid": _near_grid(
        ssqd[sup], rng * rng / res, r_d.dtype)}
    d = torch.sqrt(d2)
    s = torch.cat([d / h[row], d / h[col]])
    sup = s < rng
    rep3["table"] = {"pairs": int(sup.sum()), "near_grid": _near_grid(
        s[sup], rng / res, r_d.dtype)}


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
    """Largest error over filled slots relative to the largest |ref| (0
    where both are 0: the gaussian's zeta, du/dt of a fluid at rest)."""
    err = float(torch.abs(x - ref)[fill].max())
    return err / max(float(torch.abs(ref)[fill].max()), 1e-300)


def kernel_name(name: str, spec, kern=None) -> str:
    """The report and LAUNCHES key of grid kernel `name` (K1-K3, K8, K9)
    on `spec`'s dims: the name, with the smoothing kernel's variant (K2,
    K3, K8, K9 with `kern` other than the direct M4: _ext.family_count)
    and _1d or _2d appended below 3D."""
    return _ext._grid_count(name, spec, kern)


def compare_kernels(sim, state, repeats: int = 0, quiet: bool = False):
    """Run K1, K2, K3 and their plain versions on the same inputs, from a
    state on a CUDA device, at the grid's ndim; returns {kernel: report}
    keyed by kernel_name.  A report holds the errors, `ok` against this
    module's tolerances, `max_abs_err` of the primary output and, with
    `repeats` > 0, `ms` and `plain_ms`.  `quiet` takes K3's float32
    tolerance for a quiet lattice (TOL_F32_FORCES_QUIET).  Launch counts
    are restored afterwards, so comparisons never count as main-path
    launches."""
    saved = dict(_ext.LAUNCHES)
    spec, kern, visc = sim.gridspec, sim.kern, sim.visc
    f64 = state.r.dtype == torch.float64
    k1 = kernel_name("grid27_bin", spec)
    k2, k3 = (kernel_name(n, spec, kern) for n in
              ("grid27_density", "grid27_forces"))
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
    out[k1] = {
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
    out[k2] = _density_report(dens, s_k, s_p, fill, f64)

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
    out[k3] = _forces_report(f_k, f_p, fill, f64, quiet)
    if kern.table_res:
        _table_report(out[k2], out[k3], kern, spec, r_d, fill, dp.h)

    ids_d = ag.dense_ids(spec, b_p)
    n_i, n_ij = _slot_support_counts(spec, kern, ids_d, state.r, state.h)
    N = state.N
    out[k1]["work"] = _work(
        (state.r,), (b_k.cell_of, b_k.slot_of), FLOPS_PER[k1] * N)
    out[k2]["work"] = _work(
        (r_d, m_d, h_d, fill), s_k, FLOPS_PER[k2] * (n_i + N))
    out[k3]["work"] = _work(
        (r_d, v_d, packed, fill), f_k, FLOPS_PER[k3] * n_ij)

    if repeats > 0:
        timed = {
            k1: (lambda: g27.bin_particles(spec, state.r),
                 lambda: g27.bin_particles_plain(spec, state.r)),
            k2: (lambda: _ext.grid27_density(spec, kern, sim.h_fac,
                                             sim.h_converge, hmax, r_d, m_d,
                                             h_d, fill),
                 lambda: g27.density_sums_plain(*args)),
            k3: (lambda: _ext.grid27_forces(spec, kern, visc, r_d, v_d,
                                            packed, fill),
                 lambda: g27.force_sums_plain(kern, visc, spec, r_d, v_d,
                                              packed, fill)),
        }
        _time_pairs(out, timed, repeats)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def mapping_times(sim, state, repeats: int = 5):
    """K2's and K3's times under each thread mapping (one block per cell,
    or flat over (cell, slot): csrc/grid27.cuh) on the same dense inputs
    of a state on a CUDA device, turns cell, flat, flat, cell, and
    whether the two give the same bits (each thread's arithmetic is the
    same).  Launch counts are restored afterwards."""
    saved = dict(_ext.LAUNCHES)
    spec, kern, visc = sim.gridspec, sim.kern, sim.visc
    b = g27.bin_particles(spec, state.r)
    d = lambda x: g27.to_dense(spec, b, x)  # noqa: E731
    fill = g27.dense_fill_mask(spec, b)
    r_d, v_d, m_d, h_d = d(state.r), d(state.v), d(state.m), d(state.h)
    hmax = g27.hmax_of(spec, kern.kernrange)
    packed = d(torch.stack([getattr(state, k) for k in g27.FORCE_SCALARS],
                           dim=-1))

    def dens(mapping):
        return _ext.grid27_density(spec, kern, sim.h_fac, sim.h_converge,
                                   hmax, r_d, m_d, h_d, fill,
                                   mapping=mapping)

    def forces(mapping):
        return _ext.grid27_forces(spec, kern, visc, r_d, v_d, packed, fill,
                                  mapping=mapping)

    flat = spec.ndim < 3 or spec.k_cell < 32
    out = {"k_cell": spec.k_cell, "auto": "flat" if flat else "cell"}
    for name, fn in (("grid27_density", dens), ("grid27_forces", forces)):
        same = all(torch.equal(x, y) for x, y in zip(fn("cell"), fn("flat")))
        c1 = _time_ms(lambda: fn("cell"), repeats)
        f1 = _time_ms(lambda: fn("flat"), repeats)
        f2 = _time_ms(lambda: fn("flat"), repeats)
        c2 = _time_ms(lambda: fn("cell"), repeats)
        out[kernel_name(name, spec)] = {
            "cell_ms": 0.5 * (c1 + c2), "flat_ms": 0.5 * (f1 + f2),
            "same_bits": same}
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def _density_report(dens, s_k, s_p, rows, f64):
    """K2's report over the slots `rows`: the finished fields' errors
    and the converged flags."""
    errs = {f: (_scaled if f == "zeta" else _rel)(
        getattr(dens["kernel"], f), getattr(dens["plain"], f), rows)
        for f in ("h", "rho", "invomega", "zeta")}
    same_done = bool(torch.equal(s_k[3][rows], s_p[3][rows]))
    rep = {"rel_err": errs, "same_converged": same_done,
           "max_abs_err": float(torch.abs(dens["kernel"].rho
                                          - dens["plain"].rho)[rows].max())}
    if f64:
        rep["ok"] = same_done and max(errs.values()) <= TOL_F64
    else:
        rel = torch.abs(dens["kernel"].rho / dens["plain"].rho - 1.0)[rows]
        frac = float((rel > TOL_F32_DENSITY_TYPICAL).float().mean())
        rep["fraction_beyond_typical"] = frac
        rep["ok"] = (max(errs.values()) <= TOL_F32_DENSITY_MAX
                     and frac <= TOL_F32_DENSITY_FRACTION)
    return rep


def _forces_report(f_k, f_p, rows, f64, quiet=False):
    """K3's report over the slots `rows`."""
    rows_v = rows[..., None].expand(f_k[0].shape)
    errs = {name: _scaled(xk, xp, fl) for name, xk, xp, fl in
            zip(("a", "dudt", "div_v"), f_k, f_p, (rows_v, rows, rows))}
    return {"scaled_err": errs,
            "max_abs_err": float(torch.abs(f_k[0] - f_p[0])[rows_v].max()),
            "ok": max(errs.values()) <= (
                TOL_F64 if f64 else TOL_F32_FORCES_QUIET if quiet
                else TOL_F32_FORCES)}


def compare_mirror_kernels(sim, state, repeats: int = 0):
    """The mirror path's kernels against their plain versions on the
    same inputs, from a state on a CUDA device: K19 (exactly), K1 with
    its discard mask (cell ids exactly, slots over the kept: JAX ranks
    the discarded among themselves, K1 gives them slot 0), K2 over the
    extended set with the parents iterating (compared over the parents),
    and K3 with every image slot holding its parent's fields (compared
    over the parents).  Returns {kernel: report} keyed grid27_mirror and
    kernel_name's grid27_bin, grid27_density and grid27_forces with
    _discard, _mirror and _mirror appended; K19's report has its work
    and, with `repeats` > 0, its times.  Launch counts are restored
    afterwards."""
    saved = dict(_ext.LAUNCHES)
    spec, kern, visc, box = sim.gridspec, sim.kern, sim.visc, sim.box
    f64 = state.r.dtype == torch.float64
    N = state.N
    walls = g27.mirror_planes(box, spec)
    out = {}
    m_k = _ext.grid27_mirror(walls, state.r, state.v)
    m_p = g27.grid_mirror_extend_plain(walls, state.r, state.v)
    same = all(torch.equal(x, y) for x, y in zip(m_k, m_p))
    out["grid27_mirror"] = {
        "walls": len(walls), "exact": same,
        "kept_images": int(m_p[2][N:].sum()),
        "max_abs_err": float(max(torch.abs(x.double() - y.double()).max()
                                 for x, y in zip(m_k, m_p))),
        "ok": same,
        "work": _work((state.r, state.v), m_k,
                      FLOPS_PER["grid27_mirror"] * N * len(walls))}
    r_ext, v_ext, keep = m_p
    b_k = g27.bin_particles(spec, r_ext, ~keep)
    b_p = g27.bin_particles_plain(spec, r_ext, ~keep)
    mism = (int((b_k.cell_of != b_p.cell_of).sum())
            + int((b_k.slot_of != b_p.slot_of)[keep].sum()))
    k1 = kernel_name("grid27_bin", spec) + "_discard"
    out[k1] = {"mismatches": mism, "discarded": int((~keep).sum()),
               "overflow": [bool(b_k.overflow), bool(b_p.overflow)],
               "max_abs_err": float(
                   (b_k.slot_of - b_p.slot_of)[keep].abs().max()),
               "ok": mism == 0 and not bool(b_k.overflow)
               and not bool(b_p.overflow)}

    n_img = r_ext.shape[0] // N

    def tile(x):
        return x.repeat((n_img,) + (1,) * (x.dim() - 1))

    d = lambda x: g27.to_dense(spec, b_p, x)  # noqa: E731
    fill = g27.dense_fill_mask(spec, b_p)
    parent = d(keep & (torch.arange(r_ext.shape[0], device=keep.device)
                       < N))
    r_d, m_d, h_d = d(r_ext), d(tile(state.m)), d(tile(state.h))
    hmax = g27.hmax_of(spec, kern.kernrange)
    s_k = _ext.grid27_density(spec, kern, sim.h_fac, sim.h_converge, hmax,
                              r_d, m_d, h_d, fill, parent)
    s_p = g27.density_sums_plain(kern, spec, sim.h_fac, sim.h_converge,
                                 hmax, r_d, m_d, h_d, fill, parent)
    dens = {tag: g27.density_finish(spec, sim.h_fac, hmax, m_d, fill, *x,
                                    count_fill=parent)
            for tag, x in (("kernel", s_k), ("plain", s_p))}
    k2 = kernel_name("grid27_density", spec) + "_mirror"
    out[k2] = _density_report(dens, s_k, s_p, parent, f64)
    # every image slot takes its parent's fields, as the pass does
    pb = g27.GridBinning(b_p.cell_of[:N], b_p.slot_of[:N], b_p.overflow)
    dp = dens["plain"]

    def back(x_d):
        return g27.from_dense(spec, pb, x_d)

    rho = back(dp.rho)
    u, press, sound = sim.eos.thermal_update(torch.clamp_min(rho, 1e-30),
                                             state.u)
    fields = {"m": state.m, "h": back(dp.h), "rho": rho, "u": u,
              "pressure": press, "sound": sound,
              "invomega": back(dp.invomega), "hfactor": back(dp.hfactor),
              "alpha": state.alpha}
    packed = d(tile(torch.stack([fields[k] for k in g27.FORCE_SCALARS],
                                dim=-1)))
    v_d = d(v_ext)
    f_k = _ext.grid27_forces(spec, kern, visc, r_d, v_d, packed, fill)
    f_p = g27.force_sums_plain(kern, visc, spec, r_d, v_d, packed, fill)
    k3 = kernel_name("grid27_forces", spec) + "_mirror"
    out[k3] = _forces_report(f_k, f_p, parent, f64)
    if repeats > 0:
        timed = {"grid27_mirror": (
            lambda: _ext.grid27_mirror(walls, state.r, state.v),
            lambda: g27.grid_mirror_extend_plain(walls, state.r, state.v))}
        _time_pairs(out, timed, repeats)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def gravity_inputs(sim, state):
    """The arguments of tree_gravity_grouped after gmap, as the
    simulation's gravity pass builds them: r, m, h, kern, zh and the
    periodic extent."""
    return (state.r, sim._gravity_mass(state), state.h, sim.kern,
            state.zeta * state.hfactor, sim._periodic_extent())


def walk_options(sim, state, spec=None):
    """The walk's options as the simulation's gravity pass passes them:
    (gfac, ewald), the accuracy MAC's per-group factor (None with the
    geometric MAC) and the (EwaldTable, periodic extent) pair (None
    without the Ewald sum)."""
    spec = spec or sim.treespec
    ptab, alive = tr.gather_to_buckets_plain(
        spec, state.bucket_map, state.r, state.m,
        alive=sim.alive_mask(state))
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


def _tree_build_errors(spec, ctab, ref, ndim=3):
    """Per level and field, error relative to the level's scale of the
    field (K5 tolerance above); returns the largest.  Positions (com,
    centre) are compared on the scale of the particle set's extent, at
    least the root's half-width: the root of a sphere centred on the
    origin has a COM near 0, far below the rounding of its sum."""
    worst = 0.0
    lay = tr.layout(ndim)
    fields = {"m": slice(tr.C_M, tr.C_M + 1),
              "com": slice(lay.c_com, lay.c_com + ndim),
              "half": slice(lay.c_half, lay.c_half + ndim),
              "q": slice(lay.c_q, lay.c_q + lay.nq),
              "centre": slice(lay.c_cen, lay.c_cen + ndim)}
    extent = float(ref[0, fields["half"]].abs().max())
    for ell in range(spec.depth + 1):
        x = tr.level_rows(spec, ctab, ell)
        y = tr.level_rows(spec, ref, ell)
        live = y[:, tr.C_M] > 0.0
        if not bool(live.any()):
            continue
        for name, cols in fields.items():
            err = torch.abs(x[:, cols] - y[:, cols])[live].max()
            if name == "q":
                half = y[:, fields["half"]]
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
    nd = r.shape[1]
    wname, nname = _ext.launch_names(spec, ewald is not None, mfv=mfv,
                                     kern=kern, ndim=nd)
    lname = _ext.tree_count(_ext.family_count("tree_near_list", kern), nd)
    gname, bname, wlname = (_ext.tree_count(n, nd) for n in
                            ("tree_gather", "tree_build", "tree_walk_list"))
    f64 = r.dtype == torch.float64
    G, L = spec.n_leaves, spec.leaf_size
    alive = sim.alive_mask(state)
    out = {}

    # K4: exact (the unwrap's arithmetic is written to match)
    pk, ak = _ext.tree_gather(spec, gmap, r, m, h, zh, pext, alive)
    pp, ap = tr.gather_to_buckets_plain(spec, gmap, r, m, h, zh, pext,
                                        alive)
    same = bool(torch.equal(ak, ap)) and bool(torch.equal(pk, pp))
    out[gname] = {
        "equal": same, "max_abs_err": float(torch.abs(pk - pp).max()),
        "alive_input": alive is not None,
        "dead": 0 if alive is None else int((~alive).sum()), "ok": same}

    # K5 on the plain slot table
    ck = _ext.tree_build(spec, pp, ap)
    cp = tr.build_tree_plain(spec, pp, ap)
    worst, same_empty = _tree_build_errors(spec, ck, cp, nd)
    out[bname] = {
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
    out[wname]["ndim"] = nd
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

    out[gname]["work"] = _work(
        (gmap, r, m, h, zh, alive), (pk, ak),
        tree_flops("tree_gather", nd) * G * L)
    out[bname]["work"] = _work(
        (pp, ap), (ck,), tree_flops("tree_build_slot", nd) * G * L
        + tree_flops("tree_build_cell", nd) * ck.shape[0])
    out[wname]["work"] = _work(
        (cp, pp, ap, gfac), [x for x in wk if x is not None],
        _walk_flops(spec, ewald, wstats, nd))
    if near:
        n_pairs = _near_pairs(spec, ap, wp[2])
        near_flops = (tree_flops("tree_near", nd)
                      + (FLOPS_PER["ewald_pair"] if ewald else 0)) * n_pairs
        if spec.fast:
            near_flops += tree_flops("tree_near_fast", nd) * int(ap.sum())
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
        gname: (
            lambda: _ext.tree_gather(spec, gmap, r, m, h, zh, pext, alive),
            lambda: tr.gather_to_buckets_plain(spec, gmap, r, m, h, zh,
                                               pext, alive)),
        bname: (lambda: _ext.tree_build(spec, pp, ap),
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
        out[wlname] = _walk_report(spec, lk, lp, ap, f64, rows)
        largs = (spec, kern, cp, pp, ap, lp[2], lp[0], lp[1], gmap, N,
                 group_ids)
        lnk = _ext.tree_near(*largs)
        lnp = tr.tree_near_plain(*largs)
        errs = {"a": _scaled_all(lnk[0], lnp[0], every),
                "gpot": _scaled_all(lnk[1], lnp[1], every)}
        same_ovf = bool(lnk[2]) == bool(lnp[2])
        out[lname] = {
            "scaled_err": errs, "same_overflow": same_ovf,
            "max_abs_err": float(torch.abs(lnk[0] - lnp[0]).max()),
            "ok": (same_ovf and not bool(lnp[2]) and max(errs.values())
                   <= (TOL_F64 if f64 else TOL_F32_TREE_NEAR))}
        out[wlname]["work"] = _work(
            (cp, pp, ap, group_ids), [x for x in lk if x is not None],
            _walk_flops(spec, None, lstats, nd))
        out[lname]["work"] = _work(
            [x for x in (cp, pp, ap, lp[2], lp[0], lp[1], gmap, group_ids)
             if x is not None], lnk[:2],
            tree_flops("tree_near", nd)
            * _near_pairs(spec, ap, lp[2], group_ids))
        timed[wlname] = (
            lambda: _ext.tree_walk(spec, cp, pp, ap, group_ids, lfac),
            lambda: tr.tree_walk_plain(spec, cp, pp, ap, group_ids,
                                       gfac=lfac))
        timed[lname] = (lambda: _ext.tree_near(*largs),
                        lambda: tr.tree_near_plain(*largs))

    if repeats > 0:
        _time_pairs(out, timed, repeats)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


# the walk options of compare_tree_kernels_dims: parameter overrides of
# disc_params (the quintic through check.family_params, MFV's zeta mode
# through sim = mfvmuscl)
TREE_DIMS_OPTIONS = {
    "quadrupole": {}, "gadget2": {"gravity_mac": "gadget2"},
    "eigenmac": {"gravity_mac": "eigenmac"},
    "fast_quadrupole": {"multipole": "fast_quadrupole"},
    "quintic": {"kernel": "quintic"}, "mfv": {"sim": "mfvmuscl"},
}


def compare_tree_kernels_dims(ndim: int, device, dtype, n_target: int = 4096,
                              repeats: int = 0, options=None):
    """K4-K7 at `ndim` 1 or 2 against their plain versions: for each of
    TREE_DIMS_OPTIONS (the geometric quadrupole walk, gadget2, eigenmac,
    the fast quadrupole, the quintic kernel, the MFV zeta mode), the
    disc (disc_params(n_target, ndim)) set up and stepped twice (so that
    the accuracy MACs' inputs are set), then compare_tree_kernels with
    the group-list launches (but in MFV's mode, which walks all groups).
    Returns {kernel: report}; a name met again (K4 and K5 of every
    option, the forced overflow) is keyed `name@option`."""
    from .sim.simulation import SimulationBase

    out = {}
    for opt in options or TREE_DIMS_OPTIONS:
        over = dict(TREE_DIMS_OPTIONS[opt])
        p = disc_params(n_target, ndim, sim=over.pop("sim", "gradhsph"))
        if over.get("kernel") == "quintic":
            p = family_params(over.pop("kernel"), p)
        for k, v in over.items():
            p.set(k, v)
        sim = SimulationBase.factory(p, device, dtype)
        sim.SetupSimulation()
        sim.main_loop_steps(2)
        rep = compare_tree_kernels(sim, sim.state, repeats,
                                   listed=opt != "mfv")
        for k, r in rep.items():
            r["option"] = opt
            r["dtype"] = str(dtype)
            out[k if k not in out else f"{k}@{opt}"] = r
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


def _walk_flops(spec, ewald, wstats, ndim=3) -> int:
    """K6's operations from the plain walk's counts (FLOPS_PER) in
    `ndim` dims."""
    per_test = tree_flops("tree_walk_mac", ndim)
    if spec.mac != "geometric":
        per_test += tree_flops(f"mac_{spec.mac}", ndim)
    if ewald is not None:
        per_test += FLOPS_PER["mac_ewald"]
    extra = FLOPS_PER["ewald_pair"] if ewald is not None else 0
    if spec.fast:
        far = ((tree_flops("tree_walk_fast", ndim) + extra)
               * wstats["fast_terms"])
    else:
        far = ((tree_flops("tree_walk_far", ndim) + extra)
               * wstats["far_terms"])
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
    gravity pass would give it.  With dead particles the walk masks them
    and the sample is drawn from the alive ones; with sinks both sides
    add the star-gas pull (K16 on the walk's side, its plain version in
    float64 on the oracle's).  Returns rms|da| / rms|a| and the walk's
    overflow.  Launch counts are restored afterwards."""
    saved = dict(_ext.LAUNCHES)
    s = sim.state
    r, m, h, kern, zh, pext = gravity_inputs(sim, s)
    spec = spec or sim.treespec
    gmap = s.bucket_map
    alive = sim.alive_mask(s)
    if among is None:
        a_tree, _, overflow = tr.tree_gravity_grouped(
            spec, gmap, r, m, h, kern, zh, pext, alive=alive,
            **_mac_kwargs(sim, s, spec))
        pool = (np.arange(r.shape[0]) if alive is None
                else torch.nonzero(alive).flatten().cpu().numpy())
    else:
        a_tree, _, overflow = tr.tree_gravity_active(
            spec, gmap, r, m, h, kern, zh, sim._active_groups(among), pext)
        pool = among.cpu().numpy()
    ptab, slot_alive = tr.gather_to_buckets(spec, gmap, r, m, h, zh, pext,
                                            alive)
    r_unw = r.double().clone()
    r_unw[gmap.reshape(-1).long()[slot_alive]] = \
        ptab[slot_alive, :r.shape[1]].double()
    idx = np.random.default_rng(seed).choice(
        pool, size=min(n_sample, len(pool)), replace=False)
    t = torch.as_tensor(np.sort(idx), device=r.device)
    a_ref, _ = direct_sph_gravity(kern, r_unw, m.double(), h.double(),
                                  s.zeta.double(), s.hfactor.double(),
                                  targets=t)
    a_t = a_tree[t].double()
    if getattr(sim, "has_sinks", False):
        st = s.sinks
        m_star = torch.where(st.active, st.m, 0.0)
        args = (r[t], m[t], h[t], st.r, m_star, st.h, st.active)
        a_t = a_t + sg.star_gas_forces(kern, *args)[0].double()
        a_ref = a_ref + sg.star_gas_forces_plain(
            kern, *[x.double() if x.is_floating_point() else x
                    for x in args])[0]
    da = a_t - a_ref
    err = torch.sqrt(torch.sum(da * da) / torch.sum(a_ref * a_ref))
    _ext.LAUNCHES.update(saved)
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
    device: K8 and K9 for the particles idx (n,) int32 in the state's
    dims (reported under kernel_name's keys: active_density_2d, ...),
    K6 and K7 for the buckets of idx (skipped without self-gravity).  K9
    and K7 take the plain K8's and K6's outputs.  Returns {kernel: report} as
    compare_kernels does, with the tolerances of K2, K3, K6 and K7 and
    levelneib exactly equal.  Launch counts are restored afterwards.
    `idx` must not be empty."""
    saved = dict(_ext.LAUNCHES)
    spec, kern, visc = sim.gridspec, sim.kern, sim.visc
    f64 = state.r.dtype == torch.float64
    il = idx.long()
    out = {}
    k8, k9 = (kernel_name(n, spec, kern) for n in
              ("active_density", "active_forces"))
    nd = spec.ndim
    k7l = _ext.tree_count(_ext.family_count("tree_near_list", kern), nd)
    k6l = _ext.tree_count("tree_walk_list", nd)

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
    dens = {tag: finish_h(spec.ndim, sim.h_fac, m_a, *sums)
            for tag, sums in (("kernel", s_k), ("plain", s_p))}
    every = torch.ones_like(m_a, dtype=torch.bool)
    errs = {f: (_scaled if f == "zeta" else _rel)(
        getattr(dens["kernel"], f), getattr(dens["plain"], f), every)
        for f in ("h", "rho", "invomega", "zeta")}
    same_done = bool(torch.equal(s_k[3], s_p[3]))
    rep = {"n": int(il.numel()), "rel_err": errs,
           "same_converged": same_done, "dtype": str(state.r.dtype),
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
    out[k8] = rep

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
    out[k9] = {
        "n": int(il.numel()), "scaled_err": errs,
        "same_levelneib": same_lneib, "dtype": str(state.r.dtype),
        "levelneib_raised": int((f_p[3] != s2.levelneib).sum()),
        "max_abs_err": float(torch.abs(f_k[0] - f_p[0]).max()),
        "ok": same_lneib and max(errs.values())
        <= (TOL_F64 if f64 else TOL_F32_FORCES)}

    rows = torch.zeros((state.N,), dtype=torch.bool, device=state.r.device)
    rows[il] = True
    n_i, n_ij = _slot_support_counts(spec, kern, ids_d, s2.r, s2.h, rows)
    out[k8]["work"] = _work(
        kargs[5:], s_k, FLOPS_PER[k8] * (n_i + il.numel()))
    out[k9]["work"] = _work(fargs[1:9], f_k, FLOPS_PER[k9] * n_ij)
    timed = {
        k8: (lambda: _ext.active_density(*kargs),
             lambda: ag.active_density_plain(*pargs)),
        k9: (
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

        # K6 over the list: listed rows and near lists, zeros in the
        # unlisted groups (a walked group's every slot takes the far
        # field, a dead or empty one too: K7 writes the mapped ones)
        wk = _ext.tree_walk(tspec, cp, pp, ap, group_ids)
        wstats = {}
        wp = tr.tree_walk_plain(tspec, cp, pp, ap, group_ids, stats=wstats)
        differ = (wk[2] != wp[2]).any(1)
        n_differ = int(differ.sum())
        same_rows = ~differ.repeat_interleave(L) & rows
        errs = ({"a": _scaled_all(wk[0], wp[0], same_rows),
                 "pot": _scaled_all(wk[1], wp[1], same_rows)}
                if bool(same_rows.any()) else {})
        unlisted = ~listed.repeat_interleave(L)
        zero_elsewhere = (not bool(wk[0][unlisted].any())
                          and not bool(wk[1][unlisted].any()))
        same_ovf = bool(wk[3]) == bool(wp[3])
        tol = TOL_F64 if f64 else TOL_F32_TREE_FAR
        out[k6l] = {
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
        out[k7l] = {
            "scaled_err": errs, "same_overflow": same_ovf,
            "zero_elsewhere": zero_elsewhere,
            "max_abs_err": float(torch.abs(nk[0] - np_[0]).max()),
            "ok": (same_ovf and not bool(np_[2]) and zero_elsewhere
                   and max(errs.values(), default=0.0) <= tol)}
        out[k6l]["work"] = _work(
            (cp, pp, ap, group_ids), wk,
            tree_flops("tree_walk_mac", nd) * wstats["mac_tests"]
            + tree_flops("tree_walk_far", nd) * wstats["far_terms"])
        out[k7l]["work"] = _work(
            (cp, pp, ap, wp[2], wp[0], wp[1], gmap, group_ids), nk[:2],
            tree_flops("tree_near", nd) * _near_pairs(tspec, ap, wp[2],
                                                      group_ids))
        timed[k6l] = (
            lambda: _ext.tree_walk(tspec, cp, pp, ap, group_ids),
            lambda: tr.tree_walk_plain(tspec, cp, pp, ap, group_ids))
        timed[k7l] = (lambda: _ext.tree_near(*nargs),
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


def compare_mfv_kernels(sim, state, repeats: int = 0, flux_cfgs=None,
                        sweeps=None):
    """Run K10, K11, K31, K12 and (with self-gravity) K7 in its MFV zeta
    mode and their plain versions on the same inputs, from an MfvState
    on a CUDA device at the grid's ndim; returns {kernel: report} as
    compare_kernels does, keyed by their LAUNCHES names (mfv_density,
    mfv_gradients, mfv_limiter_<limiter>, ops.mfv_grid27.flux_count's
    name of each K12 mode, tree_near_mfv; _1d or _2d below 3D).  K12
    runs in the modes of `flux_cfgs` (MfvConfigs; the simulation's by
    default) and K31 for the limiters `sweeps` (the simulation's, if it
    sweeps), both on the plain K11's outputs.  Launch counts are restored
    afterwards."""
    saved = dict(_ext.LAUNCHES)
    spec, kern = sim.gridspec, sim.kern
    nd = spec.ndim
    nvar = nd + 2
    f64 = state.r.dtype == torch.float64
    tol = TOL_F64 if f64 else None
    N = state.N
    every = torch.ones((N,), dtype=torch.bool, device=state.r.device)
    cfg0 = sim.mfv_cfg
    if flux_cfgs is None:
        flux_cfgs = [cfg0]
    if sweeps is None:
        sweeps = ([cfg0.slope_limiter]
                  if cfg0.slope_limiter in mfv_ops.SWEEP_LIMITERS else [])
    name = lambda k: kernel_name(k, spec)  # noqa: E731
    out, timed = {}, {}

    # K10 on the plain binning's slot map; the finish is shared torch code
    b = g27.bin_particles_plain(spec, state.r)
    ids_d = ag.dense_ids(spec, b)
    hmax = g27.hmax_of(spec, kern.kernrange)
    dargs = (sim.h_fac, sim.h_converge, hmax, ids_d, state.r, state.m,
             state.h)
    s_k = _ext.mfv_density(spec, kern, *dargs)
    s_p = mg.density_sums_plain(kern, spec, *dargs)
    dens = {tag: mg.density_finish(sim.h_fac, hmax, state.m, *sums,
                                   ndim=nd)
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
    k10 = name("mfv_density")
    out[k10] = rep

    # K11 on the state's fields, with the extrema K31 reads
    gpk = torch.cat([state.h[:, None], state.ndens[:, None], state.Wprim,
                     state.sound[:, None]], -1).contiguous()
    g_out = _ext.mfv_gradients(spec, kern, ids_d, state.r, gpk,
                               extrema=True)
    g_k = mfv_ops.GradientResult(*g_out[:5])
    g_p, ext_p = mg.gradients_plain(kern, spec, ids_d, state.r, gpk)
    # a flag within rounding of the guard may flip in float32: compare the
    # other outputs where both took the same branch.  A variable's alpha
    # is compared where its gradient is above rounding (TOL_MFV_NOISE_GRAD
    # of that variable's largest): of a gradient that is 0 by symmetry
    # the two versions sum 0 or noise, and its alpha is then 1 or any
    # value in [0, 1] (ROADMAP fault F25); the limited gradient alpha *
    # grad, what K12 reads, is compared on every such row.  float32: a
    # particle with a pair within rounding of kernrange h_i may take it
    # into its extrema on one side only; such edge rows, where dWmax or
    # dWmin differ beyond TOL_F32_MFV_GRADIENTS, are counted, and their
    # alphas follow their extrema (TOL_F32_MFV_LIMITER's notes)
    same = g_k.bad == g_p.bad
    edge = torch.zeros((N,), dtype=torch.bool, device=state.r.device)
    if not f64:
        for x, ref in ((g_out[5], ext_p.dWmax), (g_out[6], ext_p.dWmin)):
            scale = max(float(torch.abs(ref).max()), 1e-300)
            edge |= (torch.abs(x - ref)
                     > TOL_F32_MFV_GRADIENTS * scale).any(1)
    rows3 = same[:, None, None]
    held = same & ~edge
    gmag = torch.linalg.vector_norm(g_p.grad, dim=-1)
    noise = TOL_MFV_NOISE_GRAD[f64] * gmag.amax(0, keepdim=True)
    live = held[:, None] & (gmag > noise)
    lim_k = g_k.alpha_slope[..., None] * g_k.grad
    lim_p = g_p.alpha_slope[..., None] * g_p.grad
    errs = {"B": _scaled_all(g_k.B, g_p.B, rows3.expand_as(g_p.B)),
            "grad": _scaled_all(g_k.grad, g_p.grad,
                                rows3.expand_as(g_p.grad)),
            "alpha_slope": float(torch.abs(g_k.alpha_slope
                                           - g_p.alpha_slope)[live].max())
            if bool(live.any()) else 0.0,
            "limited_grad": _scaled_all(
                lim_k, lim_p, held[:, None, None].expand_as(lim_p)),
            "vsig_max": _scaled_all(g_k.vsig_max, g_p.vsig_max, every),
            "dWmax": _scaled_all(g_out[5], ext_p.dWmax,
                                 every[:, None].expand_as(ext_p.dWmax)),
            "dWmin": _scaled_all(g_out[6], ext_p.dWmin,
                                 every[:, None].expand_as(ext_p.dWmin))}
    n_bad_differ = int((~same).sum())
    if f64:
        ok = n_bad_differ == 0 and max(errs.values()) <= TOL_F64
    else:
        ok = (n_bad_differ <= TOL_F32_MFV_BAD_FRACTION * N
              and max(errs[k] for k in ("B", "grad", "alpha_slope",
                                        "limited_grad", "vsig_max"))
              <= TOL_F32_MFV_GRADIENTS
              and int(edge.sum()) <= TOL_F32_MFV_LIMITER_FRACTION * N)
    k11 = name("mfv_gradients")
    out[k11] = {
        "scaled_err": errs, "bad_flags_differ": n_bad_differ,
        "bad": int(g_p.bad.sum()), "edge_rows": int(edge.sum()),
        "noise_gradients": int((held[:, None] & ~live).sum()),
        "max_abs_err": float(torch.abs(g_k.grad - g_p.grad).max()),
        "ok": ok}

    n_i, n_ij = _slot_support_counts(spec, kern, ids_d, state.r,
                                     dens["plain"].h)
    out[k10]["work"] = _work(
        (ids_d, state.r, state.m, state.h), s_k,
        FLOPS_PER[k10] * (n_i + N))
    out[k11]["work"] = _work(
        (ids_d, state.r, gpk), g_out, FLOPS_PER[k11] * n_i)
    timed[k10] = (lambda: _ext.mfv_density(spec, kern, *dargs),
                  lambda: mg.density_sums_plain(kern, spec, *dargs))
    timed[k11] = (lambda: _ext.mfv_gradients(spec, kern, ids_d, state.r,
                                             gpk, extrema=bool(sweeps)),
                  lambda: mg.gradients_plain(kern, spec, ids_d, state.r,
                                             gpk))

    # K31 on the plain K11's gradients and extrema
    for lim in sweeps:
        largs = (lim, ids_d, state.r, gpk, g_p.grad, ext_p.dWmax,
                 ext_p.dWmin)
        a_k = _ext.mfv_limiter(spec, kern, *largs)
        a_p = mg.limiter_sweep_plain(kern, spec, lim, ids_d, state.r, gpk,
                                     g_p.grad, ext_p)
        err = torch.abs(a_k - a_p)
        rep = {"max_abs_err": float(err.max()),
               "alpha_below_1": float((a_p < 1.0).float().mean()),
               "dtype": str(state.r.dtype)}
        if f64:
            rep["ok"] = rep["max_abs_err"] <= TOL_F64
        else:
            frac = float((err > TOL_F32_MFV_LIMITER).any(1).float().mean())
            rep["fraction_beyond"] = frac
            rep["ok"] = frac <= TOL_F32_MFV_LIMITER_FRACTION
        key = name(f"mfv_limiter_{lim}")
        rep["work"] = _work((ids_d, state.r, gpk, g_p.grad, ext_p.dWmax,
                             ext_p.dWmin), (a_k,),
                            FLOPS_PER[name("mfv_limiter")] * n_i)
        out[key] = rep
        timed[key] = (
            lambda la=largs: _ext.mfv_limiter(spec, kern, *la),
            lambda lim=lim: mg.limiter_sweep_plain(
                kern, spec, lim, ids_d, state.r, gpk, g_p.grad, ext_p))

    # K12 on the plain K11's outputs and the state's a0 and dt
    fpk = mg.pack_flux_fields(state.h, state.ndens, state.Wprim,
                              state.sound, state.a0, g_p.B, g_p.grad,
                              g_p.alpha_slope, g_p.bad)
    dt_t = state.dt
    for cfg in flux_cfgs:
        f_k = mg.fluxes_kernel(kern, cfg, spec, dt_t, ids_d, state.r, fpk)
        f_p = mg.fluxes_plain(kern, cfg, spec, dt_t, ids_d, state.r, fpk)
        errs = {"dQdt": _scaled_all(f_k[0], f_p.dQdt, every[:, None]
                                    .expand_as(f_p.dQdt)),
                "rdmdt_dot": _scaled_all(f_k[1], f_p.rdmdt_dot,
                                         every[:, None]
                                         .expand_as(f_p.rdmdt_dot))}
        key = mg.flux_count(spec, cfg)
        out[key] = {
            "scaled_err": errs,
            "max_abs_err": float(torch.abs(f_k[0] - f_p.dQdt).max()),
            "ok": max(errs.values()) <= (tol or TOL_F32_MFV_FLUXES),
            "work": _work((ids_d, state.r, fpk, dt_t), f_k,
                          mfv_flux_flops(nd, cfg) * n_ij)}
        timed[key] = (
            lambda c=cfg: mg.fluxes_kernel(kern, c, spec, dt_t, ids_d,
                                           state.r, fpk),
            lambda c=cfg: mg.fluxes_plain(kern, c, spec, dt_t, ids_d,
                                          state.r, fpk))

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
        k7m = _ext.tree_count("tree_near_mfv", r.shape[1])
        out[k7m] = {
            "scaled_err": errs, "same_overflow": same_ovf,
            "max_abs_err": float(torch.abs(nk[0] - np_[0]).max()),
            "ok": same_ovf and not bool(np_[2]) and max(errs.values())
            <= (TOL_F64 if f64 else TOL_F32_TREE_NEAR)}
        out[k7m]["work"] = _work(
            nargs[2:9], nk[:2],
            tree_flops("tree_near", r.shape[1])
            * _near_pairs(tspec, ap, wp[2]))
        timed[k7m] = (
            lambda: _ext.tree_near(*nargs, zeta_scaling="mfv"),
            lambda: tr.tree_near_plain(*nargs, zeta_scaling="mfv"))

    for r in out.values():
        r["dtype"] = str(state.r.dtype)
    if repeats > 0:
        _time_pairs(out, timed, repeats)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def _far_pairs(spec, occ):
    """K33's work on this grid's data: (target, occupied source) pairs,
    and those of them outside the target's stencil."""
    C = spec.total_cells
    n_occ = int(occ.sum())
    nb, _, ok = g27._neighbour_table(spec, occ.device)
    near = 0
    for c in range(0, C, 1 << 16):
        rows = nb[c:c + (1 << 16)]
        # a dim of fewer than 3 cells repeats a neighbour: count it once
        uniq = torch.where(ok[c:c + (1 << 16)], rows, -1).sort(1).values
        first = torch.ones_like(uniq, dtype=torch.bool)
        first[:, 1:] = uniq[:, 1:] != uniq[:, :-1]
        keep = first & (uniq >= 0)
        near += int((occ[torch.clamp_min(uniq, 0)] & keep).sum())
    return C * n_occ, C * n_occ - near


def compare_mfv_block_kernels(sim, state=None, sched=None, repeats: int = 0):
    """Run K12 in its block mode, K22, K32 and K33 and their plain
    versions on the same inputs, from a block MFV simulation's state and
    schedule (its own by default) on a CUDA device at the grid's ndim;
    returns {kernel: report} as compare_mfv_kernels does, keyed by their
    LAUNCHES names (ops.mfv_grid27.flux_count's block name, levelneib,
    mfv_vsig_near, mfv_vsig_far; _1d or _2d below 3D).  float64 within
    TOL_F64 (K22 exact); float32: K12 within TOL_F32_MFV_FLUXES, K32 and
    K33 within TOL_F32_MFV_VSIG of their largest values, K22 exact.
    Launch counts are restored afterwards."""
    saved = dict(_ext.LAUNCHES)
    state = sim.state if state is None else state
    sched = sim._blocksched if sched is None else sched
    spec, kern, cfg = sim.gridspec, sim.kern, sim.mfv_cfg
    nd = spec.ndim
    f64 = state.r.dtype == torch.float64
    N = state.N
    every = torch.ones((N,), dtype=torch.bool, device=state.r.device)
    name = lambda k: kernel_name(k, spec)  # noqa: E731
    b = g27.bin_particles_plain(spec, state.r)
    ids_d = ag.dense_ids(spec, b)
    out, timed = {}, {}
    n_i, n_ij = _slot_support_counts(spec, kern, ids_d, state.r, state.h)

    # K12's block mode on the state's gradients, a0 and the schedule's
    # steps: each particle's own step and its start flag (n == nlast)
    start = (sched.n == state.nlast) & state.alive
    packed = mg.pack_flux_fields(
        state.h, state.ndens, state.Wprim, state.sound, state.a0, state.B,
        state.grad, state.alpha_slope, state.bad_grad,
        dt_own=sched.dt_base * sched.nstep_part.to(state.m.dtype),
        start=start)
    dt_t = sched.dt_base
    f_k = mg.fluxes_kernel(kern, cfg, spec, dt_t, ids_d, state.r, packed,
                           block=True)
    f_p = mg.fluxes_plain(kern, cfg, spec, dt_t, ids_d, state.r, packed,
                          block=True)
    errs = {f: _scaled_all(getattr(f_k, f), getattr(f_p, f),
                           every[:, None].expand_as(getattr(f_p, f)))
            for f in ("dQdt", "rdmdt_dot", "dQ", "rdmdt")}
    key = mg.flux_count(spec, cfg, block=True)
    out[key] = {
        "scaled_err": errs, "starting": int(start.sum()),
        "max_abs_err": float(torch.abs(f_k.dQ - f_p.dQ).max()),
        "ok": max(errs.values()) <= (TOL_F64 if f64
                                     else TOL_F32_MFV_FLUXES),
        "work": _work((ids_d, state.r, packed, dt_t), f_k,
                      mfv_flux_flops(nd, cfg, block=True) * n_ij)}
    timed[key] = (
        lambda: mg.fluxes_kernel(kern, cfg, spec, dt_t, ids_d, state.r,
                                 packed, block=True),
        lambda: mg.fluxes_plain(kern, cfg, spec, dt_t, ids_d, state.r,
                                packed, block=True))

    # K22 on the slot map (no particle is dead in MFV)
    largs = (spec, kern, ids_d, state.r, state.h, state.level)
    plain = (kern, spec, b.cell_of, ids_d, state.r, state.h, state.level,
             state.alive)
    got = _ext.levelneib(*largs)
    want = ag.levelneib_plain(*plain)
    mismatch = int((got != want).sum())
    key = name("levelneib")
    out[key] = {"mismatches": mismatch,
                "levels": torch.bincount(want).tolist(),
                "max_abs_err": float((got - want).abs().max()),
                "ok": mismatch == 0,
                "work": _work((ids_d, state.r, state.h, state.level), (got,),
                              FLOPS_PER[key] * (n_ij + N))}
    timed[key] = (lambda: _ext.levelneib(*largs),
                  lambda: ag.levelneib_plain(*plain))

    # K32: every slot of each particle's stencil
    vargs = (spec, ids_d, state.r, state.v, state.sound, state.h)
    pargs = (spec, ids_d, b.cell_of, *vargs[2:])
    near_k = _ext.mfv_vsig_near(*vargs)
    near_p = mg.vsig_near_plain(*pargs)
    err = _scaled_all(near_k, near_p, every)
    cand = _stencil_candidates(spec, ids_d)
    key = name("mfv_vsig_near")
    out[key] = {"scaled_err": err,
                "max_abs_err": float(torch.abs(near_k - near_p).max()),
                "candidates": cand,
                "ok": err <= (TOL_F64 if f64 else TOL_F32_MFV_VSIG),
                "work": _work((ids_d, state.r, state.v, state.sound,
                               state.h), (near_k,),
                              FLOPS_PER[key] * cand)}
    timed[key] = (lambda: _ext.mfv_vsig_near(*vargs),
                  lambda: mg.vsig_near_plain(*pargs))

    # K33: the per-cell aggregates and the cell-pair bound
    lo, csize, reach = mg.far_geometry(spec)
    fargs = (spec, ids_d, state.v, state.sound)
    A_k, B_k = _ext.mfv_vsig_far(*fargs, lo, csize, reach)
    A_p, B_p = mg.vsig_far_plain(*fargs)
    some = B_p > -1e29
    same_empty = bool(torch.equal(B_k > -1e29, some))
    errs = {"A": _scaled_all(A_k, A_p, torch.ones_like(some)),
            "Bc": _scaled_all(B_k, B_p, some) if bool(some.any()) else 0.0}
    occ = (ids_d.reshape(spec.total_cells, -1) >= 0).any(1)
    pairs, valid = _far_pairs(spec, occ)
    key = name("mfv_vsig_far")
    out[key] = {"scaled_err": errs, "same_far_sets": same_empty,
                "cells": spec.total_cells, "occupied": int(occ.sum()),
                "far_pairs": valid,
                "max_abs_err": float(torch.abs(A_k - A_p).max()),
                "ok": same_empty and max(errs.values())
                <= (TOL_F64 if f64 else TOL_F32_MFV_VSIG),
                "work": _work((ids_d, state.v, state.sound), (A_k, B_k),
                              (FLOPS_PER["mfv_vsig_far_pair_dim"] * nd
                               + FLOPS_PER["mfv_vsig_far_wrap"]
                               * sum(map(bool, spec.periodic))) * pairs
                              + (FLOPS_PER["mfv_vsig_far_valid"]
                                 + FLOPS_PER["mfv_vsig_far_valid_dim"] * nd)
                              * valid)}
    timed[key] = (lambda: _ext.mfv_vsig_far(*fargs, lo, csize, reach),
                  lambda: mg.vsig_far_plain(*fargs))

    for r in out.values():
        r["dtype"] = str(state.r.dtype)
    if repeats > 0:
        _time_pairs(out, timed, repeats)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def _stencil_candidates(spec, ids_d) -> int:
    """Slots of the 3^ndim cells around each particle's cell, summed over
    the particles (K32's candidates, each particle itself included)."""
    C, K = spec.total_cells, spec.k_cell
    count = (ids_d.reshape(C, K) >= 0).sum(1)
    nb, _, ok = g27._neighbour_table(spec, ids_d.device)
    per_cell = torch.where(ok, count[nb], 0).sum(1)
    return int((per_cell * count).sum())


def mfv_mapping_times(sim, state, repeats: int = 5):
    """K10, K11, K31 (the simulation's sweep limiter, else tvdscalar) and
    K12 (the simulation's modes) under each thread mapping, turns cell,
    flat, flat, cell, on the inputs compare_mfv_kernels gives them, and
    whether the two mappings give the same bits.  Launch counts are
    restored afterwards."""
    saved = dict(_ext.LAUNCHES)
    spec, kern, cfg = sim.gridspec, sim.kern, sim.mfv_cfg
    lim = cfg.slope_limiter if cfg.slope_limiter in mfv_ops.SWEEP_LIMITERS \
        else "tvdscalar"
    b = g27.bin_particles(spec, state.r)
    ids_d = ag.dense_ids(spec, b)
    hmax = g27.hmax_of(spec, kern.kernrange)
    gpk = torch.cat([state.h[:, None], state.ndens[:, None], state.Wprim,
                     state.sound[:, None]], -1).contiguous()
    fpk = mg.pack_flux_fields(state.h, state.ndens, state.Wprim,
                              state.sound, state.a0, state.B, state.grad,
                              state.alpha_slope, state.bad_grad)
    ext = _ext.mfv_gradients(spec, kern, ids_d, state.r, gpk,
                             extrema=True)[5:]
    fns = {
        "mfv_density": lambda m: _ext.mfv_density(
            spec, kern, sim.h_fac, sim.h_converge, hmax, ids_d, state.r,
            state.m, state.h, mapping=m),
        "mfv_gradients": lambda m: _ext.mfv_gradients(
            spec, kern, ids_d, state.r, gpk, mapping=m),
        f"mfv_limiter_{lim}": lambda m: (_ext.mfv_limiter(
            spec, kern, lim, ids_d, state.r, gpk, state.grad, *ext,
            mapping=m),),
        "mfv_fluxes": lambda m: mg.fluxes_kernel(
            kern, cfg, spec, state.dt, ids_d, state.r, fpk, mapping=m),
    }
    flat = spec.ndim < 3 or spec.k_cell < 32
    out = {"k_cell": spec.k_cell, "auto": "flat" if flat else "cell"}
    for key, fn in fns.items():
        # K12's result leaves its block-mode fields None at a global dt
        same = all(torch.equal(x, y)
                   for x, y in zip(fn("cell"), fn("flat"))
                   if x is not None)
        c1 = _time_ms(lambda: fn("cell"), repeats)
        f1 = _time_ms(lambda: fn("flat"), repeats)
        f2 = _time_ms(lambda: fn("flat"), repeats)
        c2 = _time_ms(lambda: fn("cell"), repeats)
        label = mg.flux_count(spec, cfg) if key == "mfv_fluxes" \
            else kernel_name(key, spec)
        out[label] = {"cell_ms": 0.5 * (c1 + c2), "flat_ms": 0.5 * (f1 + f2),
                      "same_bits": same}
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
    r_unw[gmap.reshape(-1).long()[alive]] = ptab[alive, :r.shape[1]].double()
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


# ---------------------------------------------------------------------------
# Sinks: K16-K18, the per-step ledger
# ---------------------------------------------------------------------------

def sink_kernel_inputs(n_gas: int, n_slots: int, device, dtype,
                       seed: int = 0):
    """Synthetic inputs of K16-K18 (a dict: cfg, r, v, m, h, rho, alive,
    sinks) with their edge cases: gas in the unit cube with 5% dead; the
    last eighth of the slots empty (r = 0, h = 1, m = 0), the others
    stars of h 2^-8 scattered in the cube; gas 0 on star 0 and gas 5 on
    the empty slots' position; gas 2 exactly at star 1's accretion radius
    and gas 4 at equal distance from stars 2 and 3 (dyadic positions, so
    both are exact in float32 too); the two densest alive particles (3
    and 7) tied, with a denser dead one (1).  rho_sink is the median
    density and sink_radius 2."""
    rng = np.random.default_rng(seed)
    r = rng.random((n_gas, 3))
    v = rng.standard_normal((n_gas, 3))
    m = np.full(n_gas, 1.0 / n_gas)
    h = 0.02 * (1.0 + rng.random(n_gas)) * (4096.0 / n_gas) ** (1.0 / 3.0)
    rho = rng.lognormal(0.0, 0.5, n_gas)
    alive = rng.random(n_gas) > 0.05
    n_act = n_slots - n_slots // 8
    sr = rng.random((n_act, 3))
    sh = np.full(n_act, 2.0 ** -8)
    sr[1], sh[1] = (0.5, 0.5, 0.5), 2.0 ** -7
    sr[2], sr[3] = (0.25, 0.25, 0.25), (0.28125, 0.25, 0.25)
    sh[2] = sh[3] = 2.0 ** -6
    r[0] = sr[0]
    r[2] = (0.515625, 0.5, 0.5)
    r[4] = (0.265625, 0.25, 0.25)
    r[5] = 0.0
    alive[[0, 2, 3, 4, 7]] = True
    alive[1] = False
    rho[[3, 7]] = rho.max() * 1.5
    rho[1] = rho[3] * 2.0
    m = np.where(alive, m, 0.0)
    sinks = sk_ops.make_sinks(sr, rng.standard_normal((n_act, 3)),
                              np.full(n_act, 1.0 / n_slots), sh,
                              n_extra=n_slots - n_act, device=device,
                              dtype=dtype)
    kw = dict(device=device, dtype=dtype)
    out = {k: torch.as_tensor(x, **kw) for k, x in
           (("r", r), ("v", v), ("m", m), ("h", h), ("rho", rho))}
    out["alive"] = torch.as_tensor(alive, device=device)
    out["sinks"] = sinks
    out["cfg"] = sk_ops.SinkConfig(rho_sink=float(np.median(rho)),
                                   sink_radius=2.0, create=True,
                                   accrete=True)
    return out


def smooth_accretion_inputs(n_gas: int, n_slots: int, device, dtype,
                            seed: int = 0):
    """Synthetic inputs of K20: sink_kernel_inputs's gas and slots (its
    edge cases: dead gas, empty slots, gas 0 on star 0, gas 2 on star 1's
    accretion radius, gas 4 at equal distance from stars 2 and 3) with
    the other stars' h raised to 0.04 so that each claims some gas, star
    0 made light (1e-6) and wide (h 0.1) so that its orbit is slow and
    its gas goes whole (dt < smooth_accrete_dt t_orbit), and sound
    speeds in [0.5, 1.5); dt = 0.01 (a 0-d tensor), mmean = 1 / n_gas,
    alpha_ss = 0.1, smooth_accrete_frac and smooth_accrete_dt 0.01."""
    out = sink_kernel_inputs(n_gas, n_slots, device, dtype, seed)
    st = out["sinks"]
    idx = torch.arange(st.N, device=st.h.device)
    h = torch.where(st.active & (idx >= 4), 0.04, st.h)
    h = torch.where(idx == 0, 0.1, h)
    out["sinks"] = st.replace(h=h, m=torch.where(idx == 0, 1e-6, st.m))
    rng = np.random.default_rng(seed + 1)
    out["sound"] = torch.as_tensor(0.5 + rng.random(n_gas), device=device,
                                   dtype=dtype)
    out["dt"] = torch.tensor(0.01, device=device, dtype=dtype)
    out["mmean"] = 1.0 / n_gas
    out["alpha_ss"] = 0.1
    return out


def smooth_args(kern, inputs):
    """smooth_accretion_sums's positional arguments from a dict of
    smooth_accretion_inputs or sim_sink_inputs."""
    return (inputs["cfg"], inputs["sinks"], inputs["r"], inputs["v"],
            inputs["m"], inputs["rho"], inputs["sound"], inputs["alive"],
            inputs["dt"], kern, inputs["mmean"], inputs["alpha_ss"])


def sim_sink_inputs(sim):
    """The inputs of K16-K18 as a sink simulation's step gives them, from
    its current state (a dict as sink_kernel_inputs returns)."""
    s = sim.state
    return {"cfg": sim.sink_cfg, "r": s.r, "v": s.v, "m": s.m, "h": s.h,
            "rho": s.rho, "alive": s.alive, "sinks": s.sinks}


# float32, K20: each sink's sums over its claimed gas (tens of terms)
# rounded at 6e-8 and summed in another order, then exp, log and pow of
# them; the claims are exact (the distance in the same rounded steps).
# 1e-4 of each output's largest value.
TOL_F32_SMOOTH = 1e-4
# float32, K21: rr, dvw and daw over ~60 pairs each, rounded at 6e-8 and
# summed in another order (with fused multiply-adds on the card), then
# an inverse and ddivdt = tr(da/dx) - dv/dx : dv/dx^T, a difference of
# terms that cancel where the flow is smooth; alpha (in [alpha_min,
# alpha_visc]) and dalpha/dt within 1e-3 of their largest values.  The
# bad flag and the min/max clips may flip where their test lies within
# rounding of its threshold: at most 1e-3 of the particles beyond that.
TOL_F32_CD = 1e-3
TOL_F32_CD_FRACTION = 1e-3


def _smooth_both(kern, inputs, plain: bool):
    """K20's two launches (or their plain versions) on `inputs`."""
    sums_fn = (sk_ops.smooth_accretion_sums_plain if plain
               else sk_ops.smooth_accretion_sums)
    apply_fn = (sk_ops.apply_smooth_accretion_plain if plain
                else sk_ops.apply_smooth_accretion)
    dm, sums = sums_fn(*smooth_args(kern, inputs))
    new, m_gas, alive = apply_fn(inputs["sinks"], inputs["r"], inputs["v"],
                                 inputs["m"], dm, sums["claim"],
                                 inputs["alive"])
    return dm, sums, new, m_gas, alive


def _compare_smooth(kern, inputs):
    f64 = inputs["r"].dtype == torch.float64
    dm, sums, new, m_gas, alive = _smooth_both(kern, inputs, False)
    dm_p, sums_p, new_p, m_gas_p, alive_p = _smooth_both(kern, inputs,
                                                         True)
    every = slice(None)
    same_claim = bool(torch.equal(sums["claim"], sums_p["claim"]))
    errs = {"dm": _scaled_all(dm, dm_p, every),
            "m_gas": _scaled_all(m_gas, m_gas_p, every)}
    for k in ("menc", "macc", "taccrete"):
        errs[k] = _scaled_all(sums[k], sums_p[k], every)
    for f in ("r", "v", "m", "angmom"):
        errs[f"sink_{f}"] = _scaled_all(getattr(new, f), getattr(new_p, f),
                                        every)
    same_alive = bool(torch.equal(alive, alive_p))
    hit = sums_p["claim"] >= 0
    n_claim = int(hit.sum())
    st, m = inputs["sinks"], inputs["m"]
    rep = {
        "N": m.shape[0], "Ns": st.N, "claimed": n_claim,
        "whole": int((hit & (dm_p == m) & (m > 0)).sum()),
        "partial": int((hit & (dm_p > 0) & (dm_p < m)).sum()),
        "same_claims": same_claim, "same_alive": same_alive,
        "scaled_err": errs, "dtype": str(m.dtype),
        "max_abs_err": float(torch.abs(dm - dm_p).max()),
        "ok": same_claim and same_alive and max(errs.values()) <= (
            TOL_F64 if f64 else TOL_F32_SMOOTH),
        "work": _work(
            (inputs["r"], inputs["v"], m, inputs["rho"], inputs["sound"],
             inputs["alive"], st.r, st.v, st.m, st.h, st.active),
            (dm, sums["claim"], sums["menc"], sums["macc"],
             sums["taccrete"], new.r, new.v, new.r0, new.v0, new.m,
             new.angmom, m_gas, alive),
            FLOPS_PER["smooth_accretion"] * n_claim)}
    timed = {"smooth_accretion": (
        lambda: _smooth_both(kern, inputs, False),
        lambda: _smooth_both(kern, inputs, True))}
    return rep, timed


def _alive_slot_map(sim, state):
    """K1's slot map of the alive particles (the dead binned out) and
    the binning."""
    b = g27.bin_particles(sim.gridspec, state.r, discard=~state.alive)
    return ag.dense_ids(sim.gridspec, b), b


def _slot_pairs_within(spec, kern, ids_d, r, h):
    """Pairs of the slot map's particles within kernrange h_i and within
    kernrange max(h_i, h_j) (each particle with itself included in the
    latter), over the slotted particles' h."""
    ids = ids_d.reshape(-1).long()
    slotted = torch.zeros((r.shape[0],), dtype=torch.bool, device=r.device)
    slotted[ids[ids >= 0]] = True
    h_big = float(torch.max(torch.where(slotted, h, 0.0)))
    cut2 = (kern.kernrange * h_big) ** 2 * (1.0 + 1e-6)
    row, col, _, d2 = mg.slot_pairs(spec, ids_d, r, cut2, True)
    n_i, n_ij = _support_counts(row, col, d2, h, kern.kernrange)
    return n_i, n_ij + int(slotted.sum())


def _compare_cd(sim, state):
    spec, kern, visc = sim.gridspec, sim.kern, sim.visc
    f64 = state.r.dtype == torch.float64
    ids_d, _ = _alive_slot_map(sim, state)
    packed = fo.cd_packed(state.v, state.a, state.m, state.h, state.rho,
                          state.hfactor, state.alpha, state.sound)
    args = (kern, visc, spec, ids_d, state.r, packed)
    got = _ext.cullen_dehnen(spec, kern, visc, ids_d, state.r, packed)
    want = fo.cullen_dehnen_sums_plain(*args)
    rows = state.alive
    n = max(int(rows.sum()), 1)
    errs = {k: _scaled_all(x, y, rows) for k, x, y in
            zip(("alpha_new", "dalphadt"), got[:2], want[:2])}
    flips = int((got[2] != want[2])[rows].sum())
    if f64:
        ok = max(errs.values()) <= TOL_F64 and flips == 0
    else:
        off = torch.zeros_like(rows)
        for x, y in zip(got[:2], want[:2]):
            scale = max(float(torch.abs(y)[rows].max()), 1e-300)
            off |= torch.abs(x - y) > TOL_F32_CD * scale
        beyond = int((off & rows).sum())
        errs["fraction_beyond_tol"] = beyond / n
        ok = beyond <= TOL_F32_CD_FRACTION * n \
            and flips <= TOL_F32_CD_FRACTION * n
    n_i, _ = _slot_pairs_within(spec, kern, ids_d, state.r,
                                torch.clamp_min(state.h, 1e-30))
    name = kernel_name("cullen_dehnen", spec)
    rep = {"N": state.N, "ndim": spec.ndim, "k_cell": spec.k_cell,
           "ncells": list(spec.ncells), "bad": int(want[2][rows].sum()),
           "bad_flips": flips, "scaled_err": errs,
           "dtype": str(state.r.dtype),
           "max_abs_err": float(torch.abs(got[0] - want[0])[rows].max()),
           "ok": ok,
           "work": _work((ids_d, state.r, packed), got,
                         FLOPS_PER[name] * n_i)}
    timed = {name: (
        lambda: _ext.cullen_dehnen(spec, kern, visc, ids_d, state.r,
                                   packed),
        lambda: fo.cullen_dehnen_sums_plain(*args))}
    return name, rep, timed


def _compare_levelneib(sim, state):
    spec, kern = sim.gridspec, sim.kern
    ids_d, b = _alive_slot_map(sim, state)
    args = (spec, kern, ids_d, state.r, state.h, state.level)
    plain = (kern, spec, b.cell_of, ids_d, state.r, state.h, state.level,
             state.alive)
    got = _ext.levelneib(*args)
    want = ag.levelneib_plain(*plain)
    mismatch = int((got != want).sum())
    _, n_ij = _slot_pairs_within(spec, kern, ids_d, state.r, state.h)
    rep = {"N": state.N, "k_cell": spec.k_cell, "mismatches": mismatch,
           "levels": torch.bincount(want).tolist(),
           "max_abs_err": float((got - want).abs().max()),
           "dtype": str(state.r.dtype), "ok": mismatch == 0,
           "work": _work((ids_d, state.r, state.h, state.level), (got,),
                         FLOPS_PER["levelneib"] * n_ij)}
    timed = {"levelneib": (lambda: _ext.levelneib(*args),
                           lambda: ag.levelneib_plain(*plain))}
    return rep, timed


def compare_td_sink_kernels(kern=None, smooth_inputs=None, sim=None,
                            state=None, repeats: int = 0):
    """Run K20 (on `smooth_inputs`, a dict from smooth_accretion_inputs
    or sim_smooth_inputs), K21 (on the state of a simulation that runs
    it, time_dependent_avisc = cd2010, at its grid's ndim) and K22 (on a
    3D grid without mirror layers) and
    their plain versions on the same CUDA tensors; returns {kernel:
    report} as compare_kernels does.  K20: equal claims and alive masks
    and its outputs within 1e-10 of each one's largest value in float64
    (TOL_F32_SMOOTH); K21: alpha_new and dalphadt within 1e-10 and equal
    bad flags in float64 (TOL_F32_CD, TOL_F32_CD_FRACTION beyond it);
    K22: equal levels.  K20's report and time cover both its launches,
    the sums and the sink update.  library_ms is null for all three: no
    one PyTorch call computes any of them.  Launch counts are restored
    afterwards."""
    saved = dict(_ext.LAUNCHES)
    out, timed = {}, {}
    if smooth_inputs is not None:
        out["smooth_accretion"], t = _compare_smooth(kern, smooth_inputs)
        timed.update(t)
    if sim is not None:
        if sim.td_avisc_type == "cd2010":
            name, out_cd, t = _compare_cd(sim, state)
            out[name] = out_cd
            timed.update(t)
        if sim.ndim == 3 and not sim.gridspec.mirror:
            out["levelneib"], t = _compare_levelneib(sim, state)
            timed.update(t)
    if repeats > 0:
        _time_pairs(out, timed, repeats)
    for r in out.values():
        r["library_ms"] = None
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def sim_smooth_inputs(sim):
    """K20's inputs as a smooth-accretion simulation's step gives them,
    from its current state (creation not run first): dt is the
    schedule's dt_base under block timesteps, else the state's dt."""
    out = sim_sink_inputs(sim)
    s = sim.state
    out.update(sound=s.sound, mmean=sim.mmean,
               alpha_ss=sim.params.floatparams["alpha_ss"],
               dt=sim._blocksched.dt_base if sim.use_block else s.dt)
    return out


def compare_sink_kernels(kern, inputs, repeats: int = 0):
    """Run K16, K17 and K18 and their plain versions on the same CUDA
    tensors (a dict from sink_kernel_inputs or sim_sink_inputs); returns
    {kernel: report} as compare_kernels does.  K16's four outputs within
    1e-10 of each one's largest value in float64 (TOL_F32_STAR_GAS in
    float32); K17's index and row exactly, also with no particle eligible
    (index 0, score -inf); K18's eaten mask exactly and its sums within
    1e-10 (TOL_F32_ACCRETION).  A report holds `work`, the `dtype` and,
    with `repeats` > 0, `ms` and `plain_ms`; K17's also `library_ms`, one
    torch.argmax over the masked score (the mask built outside the
    timer).  Launch counts are restored afterwards."""
    saved = dict(_ext.LAUNCHES)
    cfg, st = inputs["cfg"], inputs["sinks"]
    r, v, m, h = (inputs[k] for k in ("r", "v", "m", "h"))
    rho, alive = inputs["rho"], inputs["alive"]
    f64 = r.dtype == torch.float64
    N, Ns = r.shape[0], st.N
    out = {}

    def scaled(x, ref):
        return _scaled_all(x, ref, torch.ones(x.shape[0], dtype=torch.bool,
                                              device=x.device))

    m_live = torch.where(alive, m, 0.0)
    m_star = torch.where(st.active, st.m, 0.0)
    sg_args = (r, m_live, h, st.r, m_star, st.h, st.active)
    got = sg.star_gas_forces(kern, *sg_args)
    want = sg.star_gas_forces_plain(kern, *sg_args)
    errs = {k: scaled(x, y) for k, x, y in zip(
        ("a_gas", "gpot_gas", "a_star", "gpot_star"), got, want)}
    out["star_gas_forces"] = {
        "N": N, "Ns": Ns, "scaled_err": errs, "dtype": str(r.dtype),
        "max_abs_err": float(torch.abs(got[0] - want[0]).max()),
        "ok": max(errs.values()) <= (TOL_F64 if f64 else TOL_F32_STAR_GAS),
        "work": _work(sg_args, got, _star_gas_work(r, h, st.r, st.h))}

    c_args = (cfg, r, v, m, h, rho, alive)
    cand, gi = sk_ops.sink_candidate(*c_args)
    cand_p, gi_p = sk_ops.sink_candidate_plain(*c_args)
    none = dataclasses.replace(cfg, rho_sink=float("inf"))
    cand_n, gi_n = sk_ops.sink_candidate(none, *c_args[1:])
    same = int(gi) == int(gi_p) and bool(torch.equal(cand, cand_p))
    empty = int(gi_n) == 0 and float(cand_n[-1]) == float("-inf")
    eligible = alive & (rho > cfg.rho_sink)
    top = torch.topk(torch.where(eligible, rho, -math.inf).double(),
                     min(2, N)).values
    out["sink_candidate"] = {
        "N": N, "gi": int(gi), "score": float(cand[-1]),
        "top_two_margin": float((top[0] - top[-1]) / top[0])
        if bool(torch.isfinite(top).all()) else None,
        "same_index_and_row": same, "none_eligible_gives_0_and_-inf": empty,
        "dtype": str(r.dtype),
        "max_abs_err": float(torch.abs(cand - cand_p).max())
        if bool(torch.isfinite(cand[-1])) else 0.0,
        "ok": same and empty,
        "work": _work((rho, alive, cand[:-1]), (cand, gi),
                      FLOPS_PER["sink_candidate"] * N)}

    a_args = (cfg, st, r, v, m, alive)
    got = sk_ops.accretion_sums(*a_args)
    want = sk_ops.accretion_sums_plain(*a_args)
    errs = {k: scaled(x, y) for k, x, y in zip(("dm", "dmom", "dmr"),
                                               got[:3], want[:3])}
    same = bool(torch.equal(got[3], want[3]))
    # v and m are read for the eaten gas only
    n_eat = int(got[3].sum())
    eaten_bytes = n_eat * (v.shape[1] + 1) * v.element_size()
    out["accretion_sums"] = {
        "N": N, "Ns": Ns, "eaten": n_eat, "scaled_err": errs,
        "same_eaten": same, "dtype": str(r.dtype),
        "max_abs_err": float(torch.abs(got[0] - want[0]).max()),
        "ok": same and max(errs.values()) <= (TOL_F64 if f64
                                              else TOL_F32_ACCRETION),
        "work": {"bytes": _nbytes(r, alive, st.r, st.h, st.active, *got)
                 + eaten_bytes,
                 "flops": FLOPS_PER["accretion_sums"] * N * Ns}}

    if repeats > 0:
        score = torch.where(eligible, rho, -math.inf)
        timed = {
            "star_gas_forces": (
                lambda: sg.star_gas_forces(kern, *sg_args),
                lambda: sg.star_gas_forces_plain(kern, *sg_args)),
            "sink_candidate": (
                lambda: sk_ops.sink_candidate(*c_args),
                lambda: sk_ops.sink_candidate_plain(*c_args)),
            "accretion_sums": (
                lambda: sk_ops.accretion_sums(*a_args),
                lambda: sk_ops.accretion_sums_plain(*a_args)),
        }
        _time_pairs(out, timed, repeats)
        out["sink_candidate"]["library_ms"] = _time_ms(
            lambda: torch.argmax(score), repeats)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def dust_kernel_fields(n: int, ndim: int, seed: int = 3, walls=None):
    """Numpy fields of K23's and K24's synthetic inputs, after
    tests/test_dense_kernels.py:_random_state(dust=True), in `ndim` dims
    of the unit box: alternately gas and dust, positions uniform (clipped
    to [1e-4, 1 - 1e-4] along the dims of the mirror sides `walls`,
    (dim, lhs, rhs) triples), v ~ N(0, 0.1), a and a0 ~ N(0, 0.05), rho
    in [0.5, 1.5], sound in [0.8, 1.2], h uniform in [0.06, 0.10] scaled
    to keep about the same neighbour count at any n and ndim, a
    coincident gas-dust pair (particles 0 and 1), 5% dead particles and
    per-row steps dt log-uniform over [1e-4, 0.3], so that tau = dt / t_s
    lies on both sides of 1e-3."""
    from .state import DUST_TYPE, FLAG_DEAD, GAS_TYPE

    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 1, (n, ndim))
    for (k, _, _) in walls or ():
        r[:, k] = np.clip(r[:, k], 1e-4, 1.0 - 1e-4)
    r[1] = r[0]
    scale = (400.0 / n) ** (1.0 / ndim) * {1: 0.02, 2: 0.3, 3: 1.0}[ndim]
    f = {"r": r, "v": rng.normal(0, 0.1, (n, ndim)),
         "rho": rng.uniform(0.5, 1.5, n), "sound": rng.uniform(0.8, 1.2, n),
         "a": rng.normal(0, 0.05, (n, ndim)),
         "a0": rng.normal(0, 0.05, (n, ndim)),
         "h": scale * rng.uniform(0.06, 0.10, n),
         "ptype": np.where(np.arange(n) % 2 == 0, GAS_TYPE, DUST_TYPE),
         "dt": np.exp(rng.uniform(np.log(1e-4), np.log(0.3), n))}
    dead = rng.random(n) < 0.05
    dead[:2] = False
    f["flags"] = np.where(dead, FLAG_DEAD, 0).astype(np.int32)
    return f


def dust_kernel_inputs(n: int, ndim: int, device, dtype, seed: int = 3,
                       walls=None):
    """dust_kernel_fields as a state on `device` in `dtype`, in the
    periodic unit box or, with `walls`, in mirror_params' box.  Returns
    (state, box, grid plan, dt)."""
    from .state import PERIODIC, make_sph_state

    f = dust_kernel_fields(n, ndim, seed, walls)
    if walls:
        box = DomainBox.from_params(mirror_params(8, ndim, walls))
    else:
        box = DomainBox(ndim, (0.0,) * ndim, (1.0,) * ndim,
                        (PERIODIC,) * ndim, (PERIODIC,) * ndim)
    s = make_sph_state(f["r"], f["v"], np.full(n, 1.0 / n), f["h"],
                       np.ones(n), device=device, dtype=dtype)
    T = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    I = lambda x: torch.as_tensor(x, dtype=torch.int32, device=device)
    s = s.replace(rho=T(f["rho"]), sound=T(f["sound"]), a=T(f["a"]),
                  a0=T(f["a0"]), ptype=I(f["ptype"]), flags=I(f["flags"]))
    spec = g27.plan_grid27(box, f["r"], float(f["h"].max()) * 1.1, 2.0)
    return s, box, spec, T(f["dt"])


def _dust_work(spec, kern, di, n_targets):
    """(K23's, K24's) operations on DragInputs di from this data: K23's
    cross-type candidates and pairs inside the drag kernel's support,
    K24's dust candidates of gas targets and their pairs inside the
    support (the gas side's h), counted over chunks of targets."""
    from .ops import dust as du
    from .state import DUST_TYPE, GAS_TYPE

    nd = spec.ndim
    p_all, cell_all = du._targets(spec, di.ids_d, n_targets)
    table = g27._neighbour_table(spec, di.r.device)
    starts, step = du._chunks(spec, p_all.numel(), di.r.device)
    h, pt = di.sc[:, 1], di.ptype
    n_cross = n_in = n_dep = n_dep_in = 0
    for c0 in starts:
        p, cell = p_all[c0:c0 + step], cell_all[c0:c0 + step]
        row, q, dr = du._candidate_pairs(spec, table, di.ids_d, di.r, p,
                                         cell)
        pi = p[row]
        gas_i = pt[pi] == GAS_TYPE
        d2 = torch.sum(dr * dr, -1)
        cross = ((gas_i & (pt[q] == DUST_TYPE))
                 | ((pt[pi] == DUST_TYPE) & (pt[q] == GAS_TYPE))) & (d2 > 0)
        h_gas = torch.where(gas_i, h[pi], h[q])
        inside = cross & (d2 < (kern.kernrange * h_gas) ** 2)
        n_cross += int(cross.sum())
        n_in += int(inside.sum())
        dep = gas_i & (pt[q] == DUST_TYPE) & (d2 > 0)
        n_dep += int(dep.sum())
        n_dep_in += int((dep & inside).sum())
    ops_sums = (n_cross * (FLOPS_PER["dust_drag_cross"]
                           + FLOPS_PER["dust_drag_cross_dim"] * nd)
                + n_in * (FLOPS_PER["dust_drag_pair"]
                          + FLOPS_PER["dust_drag_pair_dim"] * nd))
    ops_dep = (n_dep * (FLOPS_PER["dust_drag_deposit_cand"] + 3 * nd)
               + n_dep_in * FLOPS_PER["dust_drag_deposit_pair"])
    return ops_sums, ops_dep, {"cross_candidates": n_cross,
                               "pairs_in_support": n_in,
                               "deposit_candidates": n_dep,
                               "deposit_pairs": n_dep_in}


def compare_dust_kernels(kern, law, test_particle, state, box, spec, dt,
                         repeats: int = 0):
    """Run K23 and K24 and their plain versions on the same CUDA tensors
    (the inputs drag_pass_grid gives them for `state`, with its mirror
    images when the plan has mirror layers); returns {kernel: report}
    as compare_kernels does.  Each output of K23 over the alive
    particles, and K24's du/dt (fed the payload and dEk of the plain
    K23, so that both see the same inputs), within 1e-10 of its largest
    |value| in float64 (TOL_F32_DRAG in float32).  K24 runs when the law
    has its energy term and the drag is two-fluid.  library_ms is null:
    no one PyTorch call computes either function.  Launch counts are
    restored afterwards."""
    from .ops import dust as du

    saved = dict(_ext.LAUNCHES)
    N = state.N
    f64 = state.r.dtype == torch.float64
    tol = TOL_F64 if f64 else TOL_F32_DRAG
    rows = state.alive
    di = du.drag_inputs(spec, box, dt, state, state.alive)
    args = (spec, kern, law, test_particle, di.ids_d, N, di.r, di.vec,
            di.sc, di.ptype, di.dt)
    plain_args = (kern, law, spec, di.ids_d, N, di.r, di.vec, di.sc,
                  di.ptype, di.dt, test_particle)
    got = _ext.dust_drag_sums(*args)
    want = du.drag_sums_plain(*plain_args)
    names = ("a_drag", "norm", "sound", "div_v")
    errs = {k: _scaled_all(x, y, rows) for k, x, y in zip(names, got, want)}
    ops_sums, ops_dep, counts = _dust_work(spec, kern, di, N)
    dt_live = di.dt[rows]
    out = {"dust_drag_sums": {
        "N": N, "ndim": spec.ndim, "k_cell": spec.k_cell,
        "ncells": list(spec.ncells), "law": law.law,
        "test_particle": bool(test_particle), "mirror": bool(spec.mirror),
        "scaled_err": errs, "dtype": str(state.r.dtype),
        "max_abs_err": float(torch.abs(got[0] - want[0])[rows].max()),
        "ok": max(errs.values()) <= tol, **counts,
        "dt_range": [float(dt_live.min()), float(dt_live.max())],
        "work": _work((di.ids_d, di.r, di.vec, di.sc, di.ptype, di.dt), got,
                      ops_sums)}}
    timed = {"dust_drag_sums": (lambda: _ext.dust_drag_sums(*args),
                                lambda: du.drag_sums_plain(*plain_args))}
    if law.use_energy_term and not test_particle:
        dek, payload = du.drag_energy(state, di.dt, want[0], want[1])
        payload = payload.repeat(di.n_rep)
        d_args = (spec, kern, di.ids_d, N, di.r, di.sc, di.ptype, payload,
                  dek)
        dp_args = (kern, spec, di.ids_d, N, di.r, di.sc, di.ptype, payload,
                   dek)
        got_d = _ext.dust_drag_deposit(*d_args)
        want_d = du.drag_deposit_plain(*dp_args)
        err = _scaled_all(got_d, want_d, rows)
        out["dust_drag_deposit"] = {
            "N": N, "ndim": spec.ndim, "k_cell": spec.k_cell,
            "law": law.law, "mirror": bool(spec.mirror),
            "scaled_err": {"dudt": err}, "dtype": str(state.r.dtype),
            "max_abs_err": float(torch.abs(got_d - want_d)[rows].max()),
            "ok": err <= tol,
            "work": _work((di.ids_d, di.r, di.sc[:, 1:3], di.ptype, payload,
                           dek), (got_d,), ops_dep)}
        timed["dust_drag_deposit"] = (
            lambda: _ext.dust_drag_deposit(*d_args),
            lambda: du.drag_deposit_plain(*dp_args))
    if repeats > 0:
        _time_pairs(out, timed, repeats)
    for r in out.values():
        r["library_ms"] = None
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def dust_kernel_dt(sim):
    """Each particle's step (N,) as the simulation's next drag pass takes
    it from its state: the global dt, or nstep_part dt_base under block
    timesteps."""
    s = sim.state
    if sim.use_block:
        B = sim._blocksched
        return B.nstep_part.to(s.m.dtype) * B.dt_base
    return s.dt.expand(s.N).contiguous()


def dust_energy(sim) -> float:
    """Kinetic plus thermal plus potential energy of a dust run, summed
    in float64 on the host: sum m (v^2/2 + u) - sum m_grav gpot / 2 with
    the gravitating masses (the dust's in two-fluid runs); the drag's
    heating is in u."""
    s = sim.state
    m = s.m.double()
    e = (0.5 * m * (s.v.double() ** 2).sum(-1) + m * s.u.double()).sum()
    if sim.self_gravity:
        e = e - 0.5 * (sim._gravity_mass(s).double() * s.gpot.double()).sum()
    return float(e)


def sink_ledger(sim):
    """Keep, at each call of sim._sink_create_accrete from now on, what
    ledger_errors needs: the sink slots before and after the call, and
    the gas's mass before and after it and its velocity.  The step
    builds new tensors and never writes its inputs, so these references
    hold each call's values; the wrapper launches nothing and reads
    nothing back, so a window timed with it installed times the program.
    Returns the list the records go to."""
    rows = []
    inner = sim._sink_create_accrete

    def recorded(s, dt):
        out = inner(s, dt)
        rows.append((s.sinks, out.sinks, s.m, out.m, s.v))
        return out

    sim._sink_create_accrete = recorded
    return rows


def _ledger_row(sk0, sk1, m0, m1, v):
    """(9,) float64: the sinks' gain in mass and momentum (4), the mass
    and momentum the gas gave up (4: m_before - m_after over all gas,
    whether it died or kept part of its mass, and that times v) and
    its sum of (m_before - m_after) |v|."""
    def totals(st):
        w = torch.where(st.active, st.m, 0.0).double()
        return torch.cat([w.sum()[None],
                          (w[:, None] * st.v.double()).sum(0)])

    w = m0.double() - m1.double()
    v = v.double()
    return torch.cat([totals(sk1) - totals(sk0), w.sum()[None],
                      (w[:, None] * v).sum(0),
                      (w * torch.sqrt((v * v).sum(-1))).sum()[None]])


def ledger_errors(rows):
    """Per call: |dM_sink - dM_gas| / dM_gas and |dP_sink - dP_gas| /
    sum dm |v| of the mass the gas gave up (absolute where it gave up
    nothing), and the call's mass given up, from sink_ledger's
    records."""
    if not rows:
        return [], [], []
    x = torch.stack([_ledger_row(*r) for r in rows]).cpu().numpy()
    md, mv = x[:, 4], x[:, 8]
    em = np.where(md > 0, np.abs(x[:, 0] - md) / np.maximum(md, 1e-300),
                  np.abs(x[:, 0]))
    ep = np.where(mv > 0, np.linalg.norm(x[:, 1:4] - x[:, 5:8], axis=1)
                  / np.maximum(mv, 1e-300),
                  np.linalg.norm(x[:, 1:4], axis=1))
    return em.tolist(), ep.tolist(), md.tolist()


def total_mass(sim) -> float:
    """Gas plus sink mass, summed in float64 on the host."""
    s = sim.state
    mass = s.m.cpu().double().sum().item()
    if getattr(sim, "has_sinks", False):
        st = s.sinks
        mass += torch.where(st.active, st.m, 0.0).cpu().double().sum().item()
    return mass


# ---------------------------------------------------------------------------
# Saitoh & Makino (2012) SPH: K25 and K26
# ---------------------------------------------------------------------------

def sm2012_params(params: Parameters) -> Parameters:
    """`params` run through SM2012SphSimulation (sim = sm2012sph)."""
    p = params.copy()
    p.set("sim", "sm2012sph")
    return p


def contact_params(sim: str = "sm2012sph", tend: float = 0.5) -> Parameters:
    """The static contact discontinuity of tests/test_sm2012.py:67-97 on
    the grid path (neib_search = kdtree): 1D, box [-1, 1] periodic, 32 +
    128 lattice particles at rho 1 | 4 and p 1, energy_eqn gamma 1.4,
    mon97 (alpha 1, beta 2), to `tend`, through `sim`."""
    p = Parameters()
    for k, v in {
            "run_id": "", "ndim": 1, "sim": sim, "ic": "cdiscontinuity",
            "dimensionless": 1, "rhofluid1": 1.0, "rhofluid2": 4.0,
            "press1": 1.0, "Nlattice1[0]": 32, "Nlattice2[0]": 128,
            "boxmin[0]": -1.0, "boxmax[0]": 1.0,
            "boundary_lhs[0]": "periodic", "boundary_rhs[0]": "periodic",
            "gas_eos": "energy_eqn", "gamma_eos": 1.4, "hydro_forces": 1,
            "neib_search": "kdtree", "avisc": "mon97", "alpha_visc": 1.0,
            "beta_visc": 2.0, "tend": tend, "tsnapfirst": 1.0e30,
            "dt_snap": 1.0e30}.items():
        p.set(k, v)
    return p


def sm2012_kernel_inputs(n_side: int, ndim: int, device, dtype,
                         seed: int = 5):
    """A synthetic state for K25 and K26 in the periodic unit box of
    `ndim` dims: an n_side^ndim lattice jittered by 0.3 spacings N(0, 1)
    (0.1 in 1D) with a coincident pair (particles 0 and 1; in 2 and 3
    dims only: in 1D, where h_fac 1.2 leaves a particle about 2.4
    neighbours, such a pair's h-rho fixed point collapses to h = 0, and
    the smaller jitter keeps float32 from rounding neighbours onto each
    other), v ~ N(0, 0.1), m = 1/N
    with 5% of the particles dead (FLAG_DEAD, zero mass), u uniform in
    [0.5, 1.5] and twice that where x_0 < 0.5 (a jump like the KHI's
    interface), alpha in [0.1, 1], h within [0.7, 1.4] of 1.2 times the
    spacing, so that the iteration moves it.  The plan is for 1.3 times
    the largest h, as the controllers plan it, and its K is the fullest
    cell's occupancy, so that some cell is full and its sweep meets no
    empty slot.  Returns (state, grid plan)."""
    from .state import FLAG_DEAD, PERIODIC, make_sph_state

    rng = np.random.default_rng(seed)
    n = n_side ** ndim
    dx = 1.0 / n_side
    grid = np.stack(np.meshgrid(*[(np.arange(n_side) + 0.5) * dx] * ndim,
                                indexing="ij"), -1).reshape(n, ndim)
    jitter = 0.3 if ndim > 1 else 0.1
    r = np.mod(grid + jitter * dx * rng.standard_normal((n, ndim)), 1.0)
    if ndim > 1:
        r[1] = r[0]
    u = rng.uniform(0.5, 1.5, n) * np.where(r[:, 0] < 0.5, 2.0, 1.0)
    h = 1.2 * dx * rng.uniform(0.7, 1.4, n)
    dead = rng.random(n) < 0.05
    dead[:2] = False
    m = np.where(dead, 0.0, 1.0 / n)
    s = make_sph_state(r, rng.normal(0, 0.1, (n, ndim)), m, h, u,
                       device=device, dtype=dtype)
    s = s.replace(
        alpha=torch.as_tensor(rng.uniform(0.1, 1.0, n), dtype=dtype,
                              device=device),
        flags=torch.as_tensor(np.where(dead, FLAG_DEAD, 0),
                              dtype=torch.int32, device=device))
    box = DomainBox(ndim, (0.0,) * ndim, (1.0,) * ndim, (PERIODIC,) * ndim,
                    (PERIODIC,) * ndim)
    spec = g27.plan_grid27(box, r[~dead], 1.3 * float(h.max()), 2.0)
    b = g27.bin_particles_plain(spec, torch.as_tensor(r[~dead]))
    k_full = int(torch.bincount(b.cell_of.long()).max())
    return s, dataclasses.replace(spec, k_cell=k_full)


def _sm2012_work(spec, kern, ids_d, r, v, h):
    """(K25's, K26's) operations on this data, and the counts behind
    them: the candidates each slotted particle visits (the filled slots
    of its 3^ndim cells, itself included), its pairs within kernrange h_i
    (itself included) and within kernrange max(h_i, h_j) (d^2 > 0), and
    those of the latter that approach."""
    nd, K = spec.ndim, spec.k_cell
    nb, _, ok = g27._neighbour_table(spec, r.device)
    filled = (ids_d.reshape(-1, K) >= 0).sum(1)
    n_cand = int((filled * (filled[nb] * ok).sum(1)).sum())
    ids = ids_d.reshape(-1).long()
    ids = ids[ids >= 0]
    cut2 = (kern.kernrange * float(h[ids].max())) ** 2 * (1.0 + 1e-6)
    row, col, dx, d2 = mg.slot_pairs(spec, ids_d, r, cut2, True)
    n_i, n_ij = _support_counts(row, col, d2, h, kern.kernrange)
    rad = kern.kernrange * torch.maximum(h[row], h[col])
    dvdr = torch.sum((v[col] - v[row]) * dx, dim=-1)
    n_app = int(((d2 < rad * rad) & (dvdr < 0.0)).sum())
    f = FLOPS_PER
    ops25 = (2 * n_cand * (f["sm2012_density_cand"]
                           + f["sm2012_density_cand_dim"] * nd)
             + (n_i + ids.numel()) * f["sm2012_density_pair"])
    ops26 = (n_cand * (f["sm2012_forces_cand"]
                       + f["sm2012_forces_cand_dim"] * nd)
             + n_ij * (f["sm2012_forces_pair"]
                       + f["sm2012_forces_pair_dim"] * nd)
             + n_app * f["sm2012_forces_approach"])
    return ops25, ops26, {"candidates": n_cand,
                          "pairs_within_h_i": n_i + ids.numel(),
                          "pairs_within_max_h": n_ij,
                          "approaching_pairs": n_app}


def compare_sm2012_kernels(kern, visc, gamma, h_fac, h_converge, spec,
                           state, repeats: int = 0):
    """Run K25 and K26 and their plain versions on the same CUDA tensors:
    K1's slot map of the alive particles of `state` (the dead binned
    out), K25 from the state's h, and K26 on the packed fields that the
    plain K25's outputs give (so that both see the same inputs).  Returns
    {kernel: report} keyed by kernel_name.  float64: h, rho, q and
    hfactor each within 1e-10 relative with the same converged flags, and
    a, du/dt and div v within 1e-10 of their largest value; float32:
    TOL_F32_DENSITY_* and TOL_F32_SM2012_FORCES.  With `repeats`, both
    kernels are timed plain, kernel, kernel, plain; library_ms is null
    (no one PyTorch call computes either).  Launch counts are restored
    afterwards."""
    from .ops import sm2012 as sm

    saved = dict(_ext.LAUNCHES)
    f64 = state.r.dtype == torch.float64
    k25, k26 = (kernel_name(n, spec) for n in ("sm2012_density",
                                                "sm2012_forces"))
    s, alive = state, state.alive
    ids_d = ag.dense_ids(spec, g27.bin_particles(spec, s.r,
                                                 discard=~alive))
    flat = ids_d.reshape(-1)
    rows = torch.zeros_like(alive)
    rows[flat[flat >= 0].long()] = True
    hmax = g27.hmax_of(spec, kern.kernrange)
    d_args = (spec, kern, h_fac, h_converge, hmax, ids_d, s.r, s.m, s.u,
              s.h)
    dp_args = (kern, spec, h_fac, h_converge, hmax, ids_d, s.r, s.m, s.u,
               s.h)
    got = _ext.sm2012_density(*d_args)
    want = sm.sm2012_density_plain(*dp_args)
    errs = {k: _rel(x, y, rows) for k, x, y in
            zip(("h", "rho", "q", "hfactor"), got, want)}
    same_done = bool(torch.equal(got[4][rows], want[4][rows]))
    rep = {"N": s.N, "ndim": spec.ndim, "k_cell": spec.k_cell,
           "ncells": list(spec.ncells), "dtype": str(s.r.dtype),
           "rel_err": errs, "same_converged": same_done,
           "converged": bool(want[4][rows].all()),
           "max_abs_err": float(torch.abs(got[1] - want[1])[rows].max())}
    if f64:
        rep["ok"] = same_done and max(errs.values()) <= TOL_F64
    else:
        beyond = max(float((torch.abs(x / y - 1.0)[rows]
                            > TOL_F32_DENSITY_TYPICAL).float().mean())
                     for x, y in zip(got[1:3], want[1:3]))
        rep["fraction_beyond_typical"] = beyond
        rep["ok"] = (max(errs.values()) <= TOL_F32_DENSITY_MAX
                     and beyond <= TOL_F32_DENSITY_FRACTION)
    h, rho, q, hfac, _ = want

    def live(x, d):
        return torch.where(alive, x, d)

    sound = torch.sqrt(gamma * (gamma - 1.0) * torch.clamp_min(s.u, 1e-30))
    packed = torch.stack([s.m, s.u, live(h, 1.0), live(rho, 1.0),
                          live(q, 1.0), live(hfac, 0.0), live(sound, 0.0),
                          s.alpha], dim=-1)
    f_args = (spec, kern, visc, gamma, ids_d, s.r, s.v, packed)
    fp_args = (kern, visc, gamma, spec, ids_d, s.r, s.v, packed)
    got_f = _ext.sm2012_forces(*f_args)
    want_f = sm.sm2012_forces_plain(*fp_args)
    errs_f = {k: _scaled_all(x, y, rows if x.dim() == 1
                             else rows[:, None].expand_as(x))
              for k, x, y in zip(("a", "dudt", "div_v"), got_f, want_f)}
    out = {k25: rep, k26: {
        "N": s.N, "ndim": spec.ndim, "k_cell": spec.k_cell,
        "dtype": str(s.r.dtype), "scaled_err": errs_f,
        "max_abs_err": float(torch.abs(got_f[0] - want_f[0])[rows].max()),
        "ok": max(errs_f.values()) <= (TOL_F64 if f64
                                       else TOL_F32_SM2012_FORCES)}}
    ops25, ops26, counts = _sm2012_work(spec, kern, ids_d, s.r, s.v,
                                        live(h, 1.0))
    rep.update(counts)
    rep["work"] = _work((ids_d, s.r, s.m, s.u, s.h), got, ops25)
    out[k26]["work"] = _work((ids_d, s.r, s.v, packed), got_f, ops26)
    if repeats > 0:
        _time_pairs(out, {
            k25: (lambda: _ext.sm2012_density(*d_args),
                  lambda: sm.sm2012_density_plain(*dp_args)),
            k26: (lambda: _ext.sm2012_forces(*f_args),
                  lambda: sm.sm2012_forces_plain(*fp_args))}, repeats)
    for r in out.values():
        r["library_ms"] = None
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


# ---------------------------------------------------------------------------
# RadWS and radiative feedback: K27-K30
# ---------------------------------------------------------------------------

# K27-K29 against their plain versions, on the elements whose table
# indices agree.  float64: both evaluate the same formulas in the same
# rounded steps; log10 and pow may differ by an ulp between the card's
# kernel and torch's, which moves a value by far less than 1e-12 and an
# index only where its argument lies within an ulp of a midpoint between
# grid points: none is expected, so the gate asks for equal indices.
# float32: the same ulps of log10f and powf (6e-8 relative) flip an
# index where the argument lies within them of a midpoint, and a flip
# moves a value by a whole table step (5/127 dex of T on the synthetic
# table) and, inside a bisection, the rest of its path.  A flip is
# counted, not hidden: at most TOL_RADWS_FLIP_FRACTION of the elements,
# as TOL_TREE_FLIP_FRACTION allows MAC flips; every other element within
# TOL_F32_RADWS relative, the rounding of the few operations after the
# last gather.  K30: the slot sum of positive terms in slot order on
# the card and in torch.sum's order on the host; each term rounded at
# 6e-8 in float32, the sum at up to sqrt(Ns) 6e-8 relative (4e-6 at
# 4,096 slots), the fourth root a quarter of that: TOL_F32_AMBIENT; in
# float64 TOL_F64_RADWS.
TOL_F64_RADWS = 1e-12
TOL_F32_RADWS = 1e-5
TOL_RADWS_FLIP_FRACTION = 1e-4
TOL_F32_AMBIENT = 1e-5
# The meshless finite-volume kernels below 3D and in every mode, counted
# as above.  K10 per pair within kernrange h_i drops a dim's share of the
# separation (4), as K2 does.  K11 per such pair: the separation and d^2
# (3 a dim), the two kernels and their norms (~25), E (3 NDIM^2), and
# grad_tmp and grad_sph (3 nvar NDIM each), nvar = NDIM + 2: 120 in 3D
# (mfv_gradients' count), 70 in 2D, 40 in 1D.  K31 per pair within
# kernrange h_i: the separation and d^2 (3 a dim), the two tests, and
# per variable the dot product (2 NDIM), the 0.51 product, the live
# test, the division, the clip or select and the min (6): 71, 48 and 29
# in 3D, 2D and 1D.  K12 per pair within kernrange max(h_i, h_j):
# mfv_fluxes counts MUSCL with the Gizmo limiter and HLLC (450 in 3D, its
# count above; 300 in 2D, 190 in 1D), of which an HLLC solve is
# about 100; an exact solve is about 670 (Toro's guess 30, 10 Newton
# steps of two pressure functions at 30 each with their pow or square
# root, the sample at x/t = 0 with its pow 40); RK2 solves twice and
# adds the full-step states (4 nvar); the cell limiters skip the Gizmo
# clamp (10 a variable a side), zeroslope the reconstruction and the
# time derivative too (2 NDIM + 10 a variable a side, 2 NDIM a variable
# for the derivative).
FLOPS_PER.update({
    # K12's block mode per pair within kernrange max(h_i, h_j): the pair's
    # step (a min) and its start test; mfv_flux_flops adds the committed
    # exchange (nvar products and sums, ndim for the moment)
    "mfv_block_pair": 2,
    # K22 below 3D: d^2 (2 ndim - 1), the radius, its square and the
    # compare, with the max: 12 in 3D, 9 in 2D, 6 in 1D
    "levelneib_2d": 9, "levelneib_1d": 6,
    # K32 per candidate (every filled slot of the stencil): the
    # separation and d^2 (3 a dim), the test, the square root, dv.dr (3 a
    # dim) and its division, c_i + c_j - dvdr (2), the scale (a max and a
    # division), the product and the max: 8 + 6 ndim
    "mfv_vsig_near": 26, "mfv_vsig_near_2d": 20, "mfv_vsig_near_1d": 14,
    # K33 per (target cell, occupied source cell) pair and dim: dr, |dr|,
    # the gap (a difference and a max) and the reach test (5), and on a
    # periodic dim the wrap (a division, rint, a product and a
    # difference: 4); per pair outside the stencil: the gap's square and
    # sum, the edge velocity's difference, the signed product and sum (5
    # a dim), the square root, three divisions, the difference and two
    # maxima (8)
    "mfv_vsig_far_pair_dim": 5, "mfv_vsig_far_wrap": 4,
    "mfv_vsig_far_valid": 8, "mfv_vsig_far_valid_dim": 5,
    "mfv_density_2d": 36, "mfv_density_1d": 32,
    "mfv_gradients_2d": 70, "mfv_gradients_1d": 40,
    "mfv_limiter": 71, "mfv_limiter_2d": 48, "mfv_limiter_1d": 29,
    "mfv_fluxes_2d": 300, "mfv_fluxes_1d": 190,
    "mfv_hllc_solve": 100, "mfv_exact_solve": 670,
})


def mfv_flux_flops(ndim: int, cfg, block: bool = False) -> int:
    """K12's operations per pair within kernrange max(h_i, h_j) in `cfg`'s
    modes, in block mode with `block` (FLOPS_PER's notes)."""
    nvar = ndim + 2
    base = FLOPS_PER["mfv_fluxes" + ("" if ndim == 3 else f"_{ndim}d")]
    solve = FLOPS_PER["mfv_exact_solve" if cfg.riemann == "exact"
                      else "mfv_hllc_solve"]
    ops = base - FLOPS_PER["mfv_hllc_solve"] + solve
    if cfg.time_scheme == "rk2":
        ops += solve + 4 * nvar
    lim = mg.FLUX_LIMITER_CLASS[cfg.slope_limiter]
    if lim >= 1:
        ops -= 2 * nvar * 10
    if lim == 2:
        ops -= 2 * nvar * (2 * ndim) + 2 * nvar * (2 * ndim)
    if block:
        ops += FLOPS_PER["mfv_block_pair"] + 2 * nvar + ndim
    return ops


# Operations of K27-K30, counted as FLOPS_PER counts the others: a log10
# or a pow counts 20 ("radws_transcendental"), a step of a binary search
# 3 and the nearer-neighbour pick 4, an entry of the u -> T row count 2;
# the energy balance 12 (T^4, the difference, the products, the
# reciprocal, the sum, the division and the difference), K29's u(T) and
# g 5 more, a bisection step's midpoint and selects 4, K27's P and c 6,
# K28's col2, T_amb^4 and dt_therm 12, K29's col2, T_amb^4 and edge
# selects 8.  K30 per (particle, slot) pair with the slot in the sum 13
# (separation, d^2, the floor, the division, the product and the sum),
# per pair outside it 1 (the mask test), per (particle, central slot)
# pair of the disc term 28 with its pow, per particle 22 (T_inf^4's sum
# and the fourth root).
FLOPS_PER.update({
    "radws_transcendental": 20, "radws_search_step": 3, "radws_pick": 4,
    "radws_count": 2, "radws_ebalance": 12, "radws_implicit_g": 5,
    "radws_bisect_step": 4, "radws_eos_tail": 6, "radws_find_tail": 12,
    "radws_implicit_tail": 8, "ambient_pair": 13, "ambient_skip": 1,
    "ambient_disc": 28, "ambient_particle": 22,
})


def radws_params(params: Parameters, press1: float = 66.67,
                 temp_ambient: float = 10.0) -> Parameters:
    """`params` on the radws thermodynamics of tests/test_radws.py's hot
    box (:18-37): gas_eos = energy_integration = radws, gamma 5/3,
    mu_bar 1, press1 (None keeps the configuration's) and temp_ambient
    as given; radws_table stays the default eos.bell.cc.dat, which the
    repository does not hold, so both packages take the synthetic
    ideal-gas, constant-opacity table."""
    p = params.copy()
    for k, v in {"gas_eos": "radws", "energy_integration": "radws",
                 "gamma_eos": 5.0 / 3.0, "mu_bar": 1.0,
                 "temp_ambient": temp_ambient}.items():
        p.set(k, v)
    if press1 is not None:
        p.set("press1", press1)
    return p


def radfb_params(params: Parameters, disc_heating: int = 1,
                 sink_heating: int = 1, ambient_heating: int = 1,
                 temp_ambient: float = 1.0,
                 r_source: float = 0.01) -> Parameters:
    """`params` (a configuration with sinks or stars) on radws with
    radiative feedback: rad_fb = 1 with the sink, ambient and disc
    heating flags given, and, as tests/test_radws.py's dimensionless
    feedback runs take them, temp_ambient 1 and every class's source
    radius `r_source` (r_star, r_bdwarf and r_planet are solar radii
    only in physical units)."""
    p = radws_params(params, press1=None, temp_ambient=temp_ambient)
    for k, v in {"rad_fb": 1, "sink_heating": sink_heating,
                 "ambient_heating": ambient_heating,
                 "disc_heating": disc_heating, "r_star": r_source,
                 "r_bdwarf": r_source, "r_planet": r_source}.items():
        p.set(k, v)
    return p


def nonideal_table(device, dtype, nd: int = 12, nt: int = 128):
    """An opacity table built in code whose every column varies: log rho
    in [-10, 2], log T in [0.5, 5]; mu falls from 2.35 to 0.6 and gamma
    from 5/3 through 1.4 to 1.1 with T (and with rho), u = T/((gamma-1)
    mu) with a ripple, kappa and kappa_p power laws in rho and T with a
    break, and density row 3's energies 60-63 reversed, so that row is
    not monotone (the u -> T count and a binary search disagree there).
    rad_const 1, temp_min 3, temp_ambient 10, fcol2 4 pi."""
    from .ops.radws import OpacityTable

    ld = np.linspace(-10.0, 2.0, nd)
    lt = np.linspace(0.5, 5.0, nt)
    LD, LT = np.meshgrid(ld, lt, indexing="ij")
    T = 10.0 ** LT
    x = np.tanh((LT - 3.3 - 0.05 * LD) / 0.4)
    mu = 1.475 - 0.875 * x
    gamma = np.where(LT < 2.5, 5.0 / 3.0 - 0.27 * (LT / 2.5) ** 2,
                     1.4 - 0.3 * (LT - 2.5) / 2.5)
    energy = T / ((gamma - 1.0) * mu) * (1.0 + 0.05 * np.sin(3.0 * LT))
    energy[3, 60:64] = energy[3, 60:64][::-1].copy()
    kappa = 10.0 ** (0.3 * LD + np.where(LT < 2.0, 2.0 * (LT - 2.0),
                                         -1.5 * (LT - 2.0)))
    kappap = 2.0 * kappa
    kw = dict(dtype=dtype, device=device)
    return OpacityTable(
        log_dens=torch.as_tensor(ld, **kw), log_temp=torch.as_tensor(lt, **kw),
        **{k: torch.as_tensor(v, **kw).contiguous() for k, v in
           (("energy", energy), ("mu", mu), ("kappa", kappa),
            ("kappap", kappap), ("gamma", gamma))},
        fcol2=4.0 * math.pi, rad_const=1.0, temp_min=3.0, temp_ambient=10.0)


def radws_kernel_inputs(n: int, device, dtype, table: str = "ideal",
                        seed: int = 11):
    """Synthetic inputs of K27-K29 (a dict: table, rho, u, dudt, gpot,
    temp_amb (N,), dt (N,)) on the synthetic ideal table
    (make_ideal_table) or nonideal_table(): rho log-uniform over a decade
    beyond each end of the density grid, u log-uniform from below the
    lowest tabulated energy to above the highest, du/dt N(0, 1) u with
    3% at -1e6 (net cooling at T_min: the clamp to T_min) and 3% at +1e22
    (net heating at the table's top: the clamp to the top), gpot uniform
    in [-1, 5] (negative ones give col2 = 0), T_amb log-uniform in [0.5,
    1e4], and dt log-uniform in [1e-6, 1]."""
    from .ops.radws import make_ideal_table

    tab = (make_ideal_table(device=device, dtype=dtype) if table == "ideal"
           else nonideal_table(device, dtype))
    rng = np.random.default_rng(seed)
    ld = tab.log_dens.double().cpu().numpy()
    e = tab.energy.double().cpu().numpy()
    rho = 10.0 ** rng.uniform(ld[0] - 1.0, ld[-1] + 1.0, n)
    u = 10.0 ** rng.uniform(np.log10(e.min()) - 0.5,
                            np.log10(e.max()) + 0.5, n)
    dudt = rng.standard_normal(n) * u
    pick = rng.random(n)
    dudt[pick < 0.03] = -1e6
    dudt[pick > 0.97] = 1e22
    out = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in (
        ("rho", rho), ("u", u), ("dudt", dudt),
        ("gpot", rng.uniform(-1.0, 5.0, n)),
        ("temp_amb", 10.0 ** rng.uniform(np.log10(0.5), 4.0, n)),
        ("dt", 10.0 ** rng.uniform(-6.0, 0.0, n)))}
    out["table"] = tab
    return out


def _radws_ops(table, kind: str) -> int:
    """Operations per element of K27 ("eos"), K28 ("find") or K29
    ("implicit") on `table` (FLOPS_PER's radws_* counts)."""
    F = FLOPS_PER
    nd, nt = table.log_dens.shape[0], table.log_temp.shape[0]

    def lookup(n):          # log10, the search and the pick
        return (F["radws_transcendental"] + F["radws_pick"]
                + (math.ceil(math.log2(n)) + 1) * F["radws_search_step"])

    t_of_u = nt * F["radws_count"] + F["radws_pick"] \
        + F["radws_transcendental"]
    if kind == "eos":
        return lookup(nd) + t_of_u + lookup(nt) + F["radws_eos_tail"]
    f_eval = lookup(nt) + F["radws_ebalance"]
    step = F["radws_bisect_step"] + F["radws_transcendental"] + f_eval
    edges = 3 * F["radws_transcendental"]       # the top's pow, two logs
    if kind == "find":
        return (lookup(nd) + t_of_u + edges + 2 * f_eval + 30 * step
                + F["radws_transcendental"] + 2 * lookup(nt)
                + F["radws_ebalance"] + F["radws_find_tail"])
    g_eval = f_eval + F["radws_implicit_g"]
    step = F["radws_bisect_step"] + F["radws_transcendental"] + g_eval
    return (lookup(nd) + edges + 2 * g_eval + 40 * step
            + F["radws_transcendental"] + g_eval + F["radws_implicit_tail"])


def _rel_errs(x, y):
    """Elementwise |x - y| / |y| (|x - y| where y = 0; 0 where x == y,
    infinities included)."""
    d = torch.abs(x - y)
    d = torch.where(x == y, torch.zeros_like(d), d)
    return torch.where(y != 0, d / torch.abs(y), d)


def _flip_report(name, got, want, idx_k, idx_p, f64, extra):
    """A report of K27-K29: flips (index differs), the largest relative
    error of each output over the other elements, ok."""
    flip = idx_k != idx_p
    keep = ~flip
    n = idx_k.numel()
    n_flip = int(flip.sum())
    errs = {k: float(_rel_errs(x, y)[keep].max()) if n_flip < n else 0.0
            for k, x, y in zip(name, got, want)}
    prim = torch.abs(got[0] - want[0])[keep]
    rep = {"N": n, "flips": n_flip, "flip_share": n_flip / max(n, 1),
           "rel_err": errs,
           "max_abs_err": float(prim.max()) if prim.numel() else 0.0,
           **extra}
    if f64:
        rep["ok"] = n_flip == 0 and max(errs.values()) <= TOL_F64_RADWS
    else:
        rep["ok"] = (n_flip / max(n, 1) <= TOL_RADWS_FLIP_FRACTION
                     and max(errs.values()) <= TOL_F32_RADWS)
    return rep


def _branches(index, dtype):
    """The dtype and how many elements K28's or K29's plain index puts
    at T_min (branch 1) and at the table's top (branch 2)."""
    branch = index % 3
    return {"dtype": str(dtype), "at_t_min": int((branch == 1).sum()),
            "at_top": int((branch == 2).sum())}


def compare_radws_kernels(inputs, repeats: int = 0, dense_shape=None,
                          dense=None):
    """Run K27, K28 and K29 and their plain versions on the same CUDA
    tensors (a dict from radws_kernel_inputs, or a simulation's fields
    with its table), each with its index output; returns {case: report}
    for K27 on the flat inputs (and, with `dense_shape` (cells, K), on
    the first prod(dense_shape) elements in that shape with every fifth
    slot empty: rho 1e-30 and u 0), K28 with the table's scalar T_amb
    and with the per-element field, K29 with a scalar dt and per-element
    dt and T_amb.  `dense`, a grid pass's own (rho_d, u_d) from
    radws_dense_inputs, makes K27's first case "radws_eos" and the flat
    one "radws_eos_flat".  A report holds the flips, the errors over the
    other elements, `ok`, `work`, the dtype and, with `repeats`, ms and
    plain_ms (the first case of each kernel, which chip_smoke.py keys by
    the kernel's name); library_ms null.  Launch counts are restored
    afterwards."""
    from .ops import radws as rw

    saved = dict(_ext.LAUNCHES)
    tab = inputs["table"]
    rho, u, dudt, gpot = (inputs[k] for k in ("rho", "u", "dudt", "gpot"))
    tamb, dt = inputs["temp_amb"], inputs["dt"]
    f64 = rho.dtype == torch.float64
    tb = _nbytes(*(getattr(tab, k) for k in rw.OpacityTable.ARRAYS))
    out, timed = {}, {}
    eos_cases = {"radws_eos": (rho, u)} if dense is None else {
        "radws_eos": dense, "radws_eos_flat": (rho, u)}
    if dense_shape is not None:
        k = int(np.prod(dense_shape))
        empty = torch.arange(k, device=rho.device) % 5 == 4
        rho_d = torch.where(empty, 1e-30, rho[:k]).reshape(dense_shape)
        u_d = torch.where(empty, 0.0, u[:k]).reshape(dense_shape)
        eos_cases["radws_eos_dense"] = (rho_d, u_d)
    for name, (r_, u_) in eos_cases.items():
        got = rw.radws_eos(tab, r_, u_, index=True)
        want = rw.radws_eos_plain(tab, r_, u_, index=True)
        out[name] = _flip_report(("P", "c"), got[:2], want[:2], got[2],
                                 want[2], f64, {"dtype": str(rho.dtype),
                                                "shape": list(r_.shape)})
        out[name]["work"] = {"bytes": _nbytes(r_, u_, *got[:2]) + tb,
                             "flops": r_.numel() * _radws_ops(tab, "eos")}
        timed.setdefault("radws_eos", (
            lambda a=r_, b=u_: rw.radws_eos(tab, a, b),
            lambda a=r_, b=u_: rw.radws_eos_plain(tab, a, b)))
    amb0 = torch.tensor(tab.temp_ambient, dtype=rho.dtype, device=rho.device)
    for name, ta in (("radws_equilibrium", amb0),
                     ("radws_equilibrium_field", tamb)):
        got = rw.energy_find_equi(tab, rho, u, dudt, gpot, ta, index=True)
        want = rw.energy_find_equi_plain(tab, rho, u, dudt, gpot, ta,
                                         index=True)
        out[name] = _flip_report(("ueq", "dt_therm"), got[:2], want[:2],
                                 got[2], want[2], f64,
                                 _branches(want[2], rho.dtype))
        out[name]["work"] = {
            "bytes": _nbytes(rho, u, dudt, gpot, ta, *got[:2]) + tb,
            "flops": rho.numel() * _radws_ops(tab, "find")}
    timed["radws_equilibrium"] = (
        lambda: rw.energy_find_equi(tab, rho, u, dudt, gpot, amb0),
        lambda: rw.energy_find_equi_plain(tab, rho, u, dudt, gpot, amb0))
    dt0 = dt[:1].reshape(())
    for name, d_, ta in (("radws_implicit_heating", dt0, amb0),
                         ("radws_implicit_heating_field", dt, tamb)):
        got = rw.radws_implicit_heating(tab, rho, u, dudt, gpot, d_, ta,
                                        index=True)
        want = rw.radws_implicit_heating_plain(tab, rho, u, dudt, gpot, d_,
                                               ta, index=True)
        out[name] = _flip_report(("heat",), got[:1], want[:1], got[1],
                                 want[1], f64, _branches(want[1], rho.dtype))
        out[name]["work"] = {
            "bytes": _nbytes(rho, u, dudt, gpot, d_, ta, got[0]) + tb,
            "flops": rho.numel() * _radws_ops(tab, "implicit")}
    timed["radws_implicit_heating"] = (
        lambda: rw.radws_implicit_heating(tab, rho, u, dudt, gpot, dt0, amb0),
        lambda: rw.radws_implicit_heating_plain(tab, rho, u, dudt, gpot, dt0,
                                                amb0))
    if repeats > 0:
        _time_pairs(out, timed, repeats)
    for r in out.values():
        r["library_ms"] = None
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def ambient_kernel_inputs(n: int, n_slots: int, device, dtype,
                          seed: int = 13):
    """Synthetic inputs of K30 (a dict: r (N, 3), the slots' r, m, mdot,
    rad (sink radius) and active, and the SinkHeatingConfig): particles
    in the unit cube; slot masses cycling through the three classes
    (planet 5 M_J, brown dwarf 40 M_J, star 0.25 msun, M_J = 9.546e-4
    msun) with mdot log-uniform, the last eighth of the slots inactive
    and empty; particle 0 on active slot 1's position (d = 0, the 1e-30
    floor) and particle 1 on an inactive slot's."""
    from .ops.radiative_fb import SinkHeatingConfig

    rng = np.random.default_rng(seed)
    r = rng.random((n, 3))
    n_act = n_slots - n_slots // 8
    rs = rng.random((n_slots, 3))
    mj = 9.546e-4
    m = np.array([5.0 * mj, 40.0 * mj, 0.25])[np.arange(n_slots) % 3]
    mdot = 10.0 ** rng.uniform(-4.0, 0.0, n_slots)
    rad = np.full(n_slots, 0.02)
    active = np.arange(n_slots) < n_act
    m[~active], mdot[~active] = 0.0, 0.0
    r[0] = rs[min(1, n_slots - 1)]
    r[1] = rs[-1]
    kw = dict(dtype=dtype, device=device)
    return {"r": torch.as_tensor(r, **kw), "rs": torch.as_tensor(rs, **kw),
            "m": torch.as_tensor(m, **kw), "mdot": torch.as_tensor(mdot, **kw),
            "rad": torch.as_tensor(rad, **kw),
            "active": torch.as_tensor(active, device=device),
            "cfg": SinkHeatingConfig(temp_inf=5.0, r_star=0.01,
                                     r_bdwarf=0.005, r_planet=0.002)}


def _disc(n_central):
    from .ops.radiative_fb import DiscHeatingConfig

    return DiscHeatingConfig(temp_au=250.0, temp_q=0.75, rsmooth=0.01,
                             n_central=n_central)


# (name, sink_heating, DiscHeatingConfig or None) of compare_ambient_kernels
AMBIENT_CASES = (("sinks", 1, None), ("disc_1", 1, _disc(1)),
                 ("disc_2", 1, _disc(2)), ("sink_heating_off", 0, _disc(1)))


def compare_ambient_kernels(inputs, repeats: int = 0, cases=AMBIENT_CASES):
    """Run K30 and its plain version on the same CUDA tensors (a dict
    from ambient_kernel_inputs, or a simulation's particles and slots
    with its SinkHeatingConfig): per case (name, sink_heating, n_central
    config or None) the per-slot factors are computed once (the O(Ns)
    torch pass) and both versions take them; the sink sum's mask is the
    active slots (none with sink_heating off) past the central ones.  Each
    report holds the largest relative error (TOL_F64_RADWS,
    TOL_F32_AMBIENT), `ok`, `work` and, with `repeats`, ms and plain_ms
    for the first case; library_ms null.  Launch counts are restored."""
    from .ops import radiative_fb as fb

    saved = dict(_ext.LAUNCHES)
    r, rs = inputs["r"], inputs["rs"]
    f64 = r.dtype == torch.float64
    cfg = inputs["cfg"]
    q, ts4 = fb._sink_terms(cfg, inputs["m"], inputs["mdot"], inputs["rad"])
    N, Ns = r.shape[0], rs.shape[0]
    out, timed = {}, {}
    for name, heating, disc in cases:
        active = inputs["active"] if heating \
            else torch.zeros_like(inputs["active"])
        act = active if disc is None else active & (
            torch.arange(Ns, device=r.device) >= disc.n_central)
        args = (r, rs, q, ts4, act, active, cfg.temp_inf, disc)
        got = _ext.ambient_temperature(*args)
        want = fb.combined_ambient_temperature_plain(cfg, disc, r, rs, q, ts4,
                                                     act, active)
        err = float(_rel_errs(got, want).max())
        n_sum = int(act.sum())
        n_disc = 0 if disc is None else int(active[:disc.n_central].sum())
        flops = N * (n_sum * FLOPS_PER["ambient_pair"]
                     + (Ns - n_sum) * FLOPS_PER["ambient_skip"]
                     + n_disc * FLOPS_PER["ambient_disc"]
                     + FLOPS_PER["ambient_particle"])
        out[f"ambient_temperature_{name}"] = {
            "N": N, "Ns": Ns, "slots_in_sum": n_sum, "disc_slots": n_disc,
            "dtype": str(r.dtype), "rel_err": err,
            "max_abs_err": float(torch.abs(got - want).max()),
            "ok": err <= (TOL_F64_RADWS if f64 else TOL_F32_AMBIENT),
            "work": _work((r, rs, q, ts4, act, active), (got,), flops)}
        if not timed:
            timed[f"ambient_temperature_{name}"] = (
                lambda a=args: _ext.ambient_temperature(*a),
                lambda d=disc, a=act, b=active:
                    fb.combined_ambient_temperature_plain(cfg, d, r, rs, q,
                                                          ts4, a, b))
    if repeats > 0:
        _time_pairs(out, timed, repeats)
    for rep in out.values():
        rep["library_ms"] = None
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def radws_dense_inputs(sim):
    """K27's inputs in a grid pass of a simulation's state (no mirror
    planes): the (*ncells, K) slots of its binning, rho clamped to 1e-30
    (empty and dead slots rho 1 from the density finish) and u (0 in
    empty slots), as hydro_pass_grid27 gives them to the EOS."""
    s, spec = sim.state, sim.gridspec
    b = g27.bin_particles_plain(spec, s.r)
    fill = g27.dense_fill_mask(spec, b)
    alive = getattr(s, "alive", None)
    if alive is not None:
        fill = fill & g27.to_dense(spec, b, alive)
    rho_d = torch.where(fill, g27.to_dense(spec, b, s.rho), 1.0)
    return torch.clamp_min(rho_d, 1e-30), g27.to_dense(spec, b, s.u)


def radws_sim_inputs(sim):
    """K27-K29's inputs at a simulation's state (its alive particles; an
    MFV state's all, with du/dt 0 as its cooling takes it): its table,
    rho, u, du/dt, gpot, the table's T_amb as a field and its dt per
    particle."""
    s = sim.state
    alive = getattr(s, "alive", None)
    if alive is None:
        alive = torch.ones_like(s.rho, dtype=torch.bool)
    dudt = getattr(s, "dudt", None)
    if dudt is None:
        dudt = torch.zeros_like(s.u)
    n = int(alive.sum())
    return {"table": sim.eos.table, "rho": s.rho[alive].contiguous(),
            "u": s.u[alive].contiguous(), "dudt": dudt[alive].contiguous(),
            "gpot": s.gpot[alive].contiguous(),
            "temp_amb": torch.full((n,), sim.eos.table.temp_ambient,
                                   dtype=s.rho.dtype, device=s.rho.device),
            "dt": s.dt.expand(n).contiguous()}


# ---------------------------------------------------------------------------
# radiation: K34-K37
# ---------------------------------------------------------------------------

# K34-K37's operations, counted by hand from csrc/radiation.cu: K34 per
# particle in a slot (its weight m / max(rho, 1e-30), the two products
# and sums, n_H and its square: 8) and per cell (the two divisions by
# V_cell); K35 per sample (t, L t, the position, 2 a dim, the cell index,
# 3 a dim, the bounds and flat index, 6, the sum: 25) and per ray (the
# last product and division); K36 per step a packet takes inside the
# domain (the midpoint, 2 a dim; the cell, 5 a dim; tau, the exp counted
# 20, absorb, the Lucy path's test and division, the two sums, w and the
# next position, 2 a dim: 55); K37 per (source, particle) the distance
# (9) once, per round the flux weight (6) and per radix pass the key's
# prefix test, its digit and the histogram add (4).
FLOPS_PER.update({
    "cell_field": 8, "cell_field_cell": 2, "ray_march_sample": 25,
    "ray_march_ray": 2, "packet_step": 55, "stromgren_dist": 9,
    "stromgren_weight": 6, "stromgren_pass": 4,
})
# K34's and K35's sums run in another order than the plain versions'
# torch.sum (relative rounding ~ K eps); K36 sums in float64 against the
# float32 plain version's atomics, so it is held against the plain version
# in float64 on the same inputs (scaled by the field's largest value)
TOL_F32_RADIATION = 1e-5
TOL_F64_RADIATION = 1e-12
# K37's flags may differ only where the plain version's cumulative sum at
# the particle lies within this fraction of Ndot (the two sum in other
# orders), and in at most TOL_FLAG_FRACTION of the particles
STROMGREN_BAND = 1e-4
TOL_FLAG_FRACTION = 1e-3
# K37's rounds after the independent solution (the JAX default)
STROMGREN_ROUNDS = 8
# the Monte-Carlo cross-section of the Spitzer runs on the card (code
# length units): about 50 optical depths a cell of the 262,144-particle
# grid in the neutral gas, so the front is optically thick
SPITZER_MC_ACROSS = 3000.0
# its Monte-Carlo iterations (Nraditerations), as tests/test_mcrt.py:105
# runs them: from xHI = 1e-3 the under-relaxed balance closes in on the
# front from outside, ~35% beyond Rs after the default 4, ~9% after 10
SPITZER_MC_ITERATIONS = 10
_SPITZER_IC = {}


def spitzer_sim(n_hydro: int, radiation: str, device="cuda",
                dtype=torch.float32, **over):
    """The Spitzer HII region through GradhSphSimulation, set up: the
    lattice sphere (cached per n_hydro) with spitzer_star, the flat
    spitzer_table at the scheme's spitzer_ndot and, for monoionisation,
    SPITZER_MC_ACROSS and SPITZER_MC_ITERATIONS unless `over` sets
    Nraditerations."""
    from .sim.ic import spitzer_ic
    from .sim.simulation import GradhSphSimulation

    if radiation == "monoionisation":
        over.setdefault("Nraditerations", SPITZER_MC_ITERATIONS)
    params = spitzer_params(n_hydro, radiation, **over)
    if n_hydro not in _SPITZER_IC:
        _SPITZER_IC[n_hydro] = spitzer_ic(params, None)
    ic = dict(_SPITZER_IC[n_hydro], star=spitzer_star())
    sim = GradhSphSimulation(params, device=device, dtype=dtype)
    sim.SetupSimulation(ic)
    sim.stellar_table = spitzer_table(spitzer_ndot(radiation))
    if radiation == "monoionisation":
        sim.mc_across = SPITZER_MC_ACROSS
    return sim


def front_radius(sim) -> float:
    """tests/test_spitzer.py's front: the 97th percentile of the ionised
    particles' distance from the origin (0 with none ionised)."""
    s = sim.state
    ion = s.ionfrac > 0.5
    if not bool(ion.any()):
        return 0.0
    d = torch.sqrt(torch.sum(s.r[ion].double() ** 2, dim=-1))
    return float(torch.quantile(d, 0.97))


def ionised_radius(sim) -> float:
    """The radius of a sphere of the ionised particles' volume, sum m /
    rho over them."""
    s = sim.state
    ion = (s.ionfrac > 0.5) & s.alive
    vol = float(torch.sum((s.m / s.rho)[ion].double()))
    return (3.0 * vol / (4.0 * math.pi)) ** (1.0 / 3.0)


def radiation_kernel_inputs(sim, n_packets: int = None, seed: int = 1):
    """K34-K37's inputs at a Spitzer simulation's state as its update
    forms them: K1's binning of the alive particles, m, rho and mu_bar
    (K34); the n_H^2 field and the rays toward the first source, 48
    samples (K35); the first Monte-Carlo iteration's opacity (n_H 1e-3
    sigma) and draws of max(Nphotonratio N, 4096) packets (or
    `n_packets`), 256 steps (K36); the recombination rates and the
    sources (K37)."""
    from .ops import treeray as trr
    from .ops.ionisation import recombination_rate
    from .ops.stellar import stellar_nlyc

    s, spec, cfg = sim.state, sim.gridspec, sim.ion_cfg
    sk = s.sinks
    b = g27.bin_particles(spec, s.r, discard=~s.alive)
    rho_c, nh2_c = trr.cell_field_plain(spec, b, s.m, s.rho, cfg.mu_bar)
    ndot = stellar_nlyc(sim.stellar_table, sk.m)
    dr = sk.r[:1][None, :, :] - s.r[:, None, :]
    d = torch.sqrt(torch.sum(dr * dr, dim=-1))
    if n_packets is None:
        n_packets = max(int(sim.params.floatparams["Nphotonratio"]) * s.N,
                        4096)
    src, pdirs = next(iter(sim._mc_draws(seed, ndot, n_packets, 1)))
    nH = torch.clamp_min(rho_c / cfg.mu_bar, 1e-300)
    return {
        "spec": spec, "b": b, "m": s.m, "rho": s.rho, "mu_bar": cfg.mu_bar,
        "field": nh2_c, "r": s.r,
        "dirs": (dr / torch.clamp_min(d, 1e-30)[..., None]).contiguous(),
        "lengths": d.contiguous(), "n_samples": 48,
        "ndot": ndot, "alphaB": cfg.alphaB,
        "opacity": nH * 1e-3 * getattr(sim, "mc_across", SPITZER_MC_ACROSS),
        "r0": sk.r[src].contiguous(), "pdirs": pdirs.contiguous(),
        "n_steps": 256,
        "rec": recombination_rate(cfg, s.m, s.rho), "r_src": sk.r,
        "on": sk.active & (ndot > cfg.Ndotmin)}


def stromgren_inputs(n: int, device, dtype, seed: int = 4):
    """K37's synthetic case: n particles uniform in [-1.5, 1.5]^3 with
    rho in [0.8, 1.2] and three overlapping sources (one at twice the
    others' Ndot), each reaching about 0.5 alone."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-1.5, 1.5, (n, 3))
    rho = rng.uniform(0.8, 1.2, n)
    m = np.full(n, 27.0 / n)
    ndot = 4.0 * math.pi / 3.0 * 0.5 ** 3 * np.array([1.0, 1.0, 2.0])
    kw = dict(device=device, dtype=dtype)
    rho_t = torch.tensor(rho, **kw)
    return {"r": torch.tensor(r, **kw),
            "rec": torch.tensor(m, **kw) * rho_t,   # alphaB = mu_bar = 1
            "r_src": torch.tensor([[-0.3, 0.0, 0.0], [0.3, 0.0, 0.0],
                                   [0.0, 0.45, 0.2]], **kw),
            "ndot": torch.tensor(ndot, **kw),
            "on": torch.ones(3, dtype=torch.bool, device=device)}


def _packet_steps(spec, r0, dirs, n_steps, ds) -> int:
    """The steps K36's packets take inside the domain (each until its
    first midpoint outside an open dim), as the plain march finds them."""
    from .ops.treeray import cell_indexer

    index = cell_indexer(spec, r0.dtype, r0.device)
    pos, live, steps = r0, torch.ones(r0.shape[0], dtype=torch.bool,
                                      device=r0.device), 0
    for _ in range(n_steps):
        _, inside = index(pos + (0.5 * ds) * dirs)
        live = live & inside
        steps += int(live.sum())
        pos = pos + ds * dirs
    return steps


def compare_stromgren(inp):
    """K37 against its plain version on the same CUDA tensors: the flags
    that differ, those outside STROMGREN_BAND of Ndot (must be none) and
    their fraction (at most TOL_FLAG_FRACTION)."""
    from .ops.ionisation import multi_source_ionisation_plain

    r, rec, rs, ndot, on = (inp[k] for k in ("r", "rec", "r_src", "ndot",
                                             "on"))
    N, S = r.shape[0], rs.shape[0]
    got = _ext.stromgren_prefix(r, rec, rs, ndot, on, STROMGREN_ROUNDS)
    want, cum = multi_source_ionisation_plain(r, rec, rs, ndot, on,
                                              STROMGREN_ROUNDS, cums=True)
    band = torch.any(torch.abs(cum - ndot[:, None])
                     <= STROMGREN_BAND * ndot[:, None], dim=0)
    diff = got != want
    flips = int(diff.sum())
    outside = int((diff & ~band).sum())
    # radix passes: a byte of d's bits each, then of the index's
    n_pass = r.element_size() + max(1, -(-max(N - 1, 1).bit_length() // 8))
    flops = S * N * (FLOPS_PER["stromgren_dist"] + (STROMGREN_ROUNDS + 1) * (
        FLOPS_PER["stromgren_weight"] + n_pass * FLOPS_PER["stromgren_pass"]))
    rep = {"N": N, "S": S, "dtype": str(r.dtype), "flips": flips,
           "flips_outside_band": outside, "in_band": int(band.sum()),
           "ionised": int(want.sum()), "max_abs_err": float(flips),
           "ok": outside == 0 and flips <= TOL_FLAG_FRACTION * N,
           "work": _work((r, rec, rs, ndot, on), (got,), flops),
           "library_ms": None}
    return rep


def compare_radiation_kernels(inp, repeats: int = 0, stromgren=None):
    """K34-K37 against their plain versions on the same CUDA tensors (a
    dict from radiation_kernel_inputs; `stromgren` a second K37 case from
    stromgren_inputs): per kernel the largest error relative to the
    field's largest value (K36's against its plain version in float64),
    the treeray flags the K35 integrals flip, K37's flag report, `ok`,
    `work` and, with `repeats`, ms and plain_ms; K34's library_ms is
    index_add_ of the same terms over K1's cell ids.  Launch counts are
    restored."""
    from .ops import mcrt as mc
    from .ops import treeray as trr
    from .ops.ionisation import multi_source_ionisation_plain

    saved = dict(_ext.LAUNCHES)
    spec, b = inp["spec"], inp["b"]
    m, rho, mu = inp["m"], inp["rho"], inp["mu_bar"]
    f32 = m.dtype == torch.float32
    tol = TOL_F32_RADIATION if f32 else TOL_F64_RADIATION
    C, N = spec.total_cells, m.shape[0]
    vol = trr.cell_volume(spec)
    out, timed = {}, {}

    # K34
    got = _ext.cell_field(spec, b.cell_of, b.slot_of, m, rho, mu, vol)
    want = [x.reshape(-1) for x in trr.cell_field_plain(spec, b, m, rho, mu)]
    n_in = int((b.cell_of < C).sum())
    err = max(_scaled_err(g, w) for g, w in zip(got, want))
    out["cell_field"] = {
        "N": N, "cells": C, "k_cell": spec.k_cell, "dtype": str(m.dtype),
        "max_abs_err": max(float(torch.abs(g - w).max())
                           for g, w in zip(got, want)),
        "rel_err": err, "ok": err <= tol,
        "work": _work((b.cell_of, b.slot_of, m, rho), got,
                      n_in * FLOPS_PER["cell_field"]
                      + C * FLOPS_PER["cell_field_cell"])}
    w_p = m / torch.clamp_min(rho, 1e-30)
    t_rho, t_nh2 = w_p * rho, w_p * (rho / mu) ** 2
    cid = torch.where(b.cell_of < C, b.cell_of, C).long()
    timed["cell_field"] = (
        lambda: _ext.cell_field(spec, b.cell_of, b.slot_of, m, rho, mu, vol),
        lambda: trr.cell_field_plain(spec, b, m, rho, mu))
    library = {"cell_field": lambda: (
        torch.zeros(C + 1, dtype=m.dtype, device=m.device).index_add_(
            0, cid, t_rho),
        torch.zeros(C + 1, dtype=m.dtype, device=m.device).index_add_(
            0, cid, t_nh2))}

    # K35
    field, r, dirs, ln = inp["field"], inp["r"], inp["dirs"], inp["lengths"]
    ns = inp["n_samples"]
    fflat = field.reshape(-1).contiguous()
    got = _ext.ray_march(spec, fflat, r, dirs, ln, ns)
    want = trr.march_plain(spec, field, r, dirs, ln, ns)
    err = _scaled_err(got, want)
    flux = inp["ndot"][:1][None, :] / (4.0 * math.pi
                                       * torch.clamp_min(ln, 1e-30) ** 2)
    flips = int(((flux >= inp["alphaB"] * got)
                 != (flux >= inp["alphaB"] * want)).sum())
    rays = ln.numel()
    out["ray_march"] = {
        "N": N, "rays": rays, "samples": ns, "dtype": str(m.dtype),
        "max_abs_err": float(torch.abs(got - want).max()), "rel_err": err,
        "treeray_flips": flips,
        "ok": err <= tol and flips <= TOL_FLAG_FRACTION * N,
        "work": _work((fflat, r, dirs, ln), (got,),
                      rays * (ns * FLOPS_PER["ray_march_sample"]
                              + FLOPS_PER["ray_march_ray"]))}
    timed["ray_march"] = (
        lambda: _ext.ray_march(spec, fflat, r, dirs, ln, ns),
        lambda: trr.march_plain(spec, field, r, dirs, ln, ns))

    # K36
    op, r0, pd, nst = inp["opacity"], inp["r0"], inp["pdirs"], inp["n_steps"]
    opflat = op.reshape(-1).contiguous()
    ds = 0.5 * min(spec.extents[k] / spec.ncells[k]
                   for k in range(spec.ndim))
    got = _ext.packet_march(spec, opflat, r0, pd, nst, ds)
    want = mc.propagate_packets_plain(spec, op.double(), r0.double(),
                                      pd.double(), nst, ds)
    errs = [_scaled_err(g.double().reshape(-1), w.reshape(-1))
            for g, w in zip(got, want)]
    steps = _packet_steps(spec, r0, pd, nst, ds)
    out["packet_march"] = {
        "packets": r0.shape[0], "steps": nst, "steps_inside": steps,
        "cells": C, "dtype": str(m.dtype),
        "max_abs_err": max(float(torch.abs(g.double().reshape(-1)
                                           - w.reshape(-1)).max())
                           for g, w in zip(got, want)),
        "rel_err": {"path": errs[0], "absorbed": errs[1],
                    "escaped": errs[2]},
        "escaped_fraction": float(got[2]) / r0.shape[0],
        "ok": max(errs) <= tol,
        "work": _work((opflat, r0, pd), got, steps * FLOPS_PER["packet_step"])}
    timed["packet_march"] = (
        lambda: _ext.packet_march(spec, opflat, r0, pd, nst, ds),
        lambda: mc.propagate_packets_plain(spec, op, r0, pd, nst, ds))

    # K37 at the simulation's state, and the synthetic case
    k37 = {"r": r, "rec": inp["rec"], "r_src": inp["r_src"],
           "ndot": inp["ndot"], "on": inp["on"]}
    out["stromgren_prefix"] = compare_stromgren(k37)
    timed["stromgren_prefix"] = (
        lambda: _ext.stromgren_prefix(r, inp["rec"], inp["r_src"],
                                      inp["ndot"], inp["on"],
                                      STROMGREN_ROUNDS),
        lambda: multi_source_ionisation_plain(
            r, inp["rec"], inp["r_src"], inp["ndot"], inp["on"],
            STROMGREN_ROUNDS))
    if stromgren is not None:
        out["stromgren_prefix_3src"] = compare_stromgren(stromgren)
    if repeats > 0:
        _time_pairs(out, timed, repeats)
        for name, fn in library.items():
            out[name]["library_ms"] = _time_ms(fn, repeats)
    for rep in out.values():
        rep.setdefault("library_ms", None)
    torch.cuda.synchronize()
    _ext.LAUNCHES.update(saved)
    return out


def _scaled_err(x, ref) -> float:
    """Largest |x - ref| over the largest |ref| (finite entries of ref)."""
    ok = torch.isfinite(ref)
    if not bool(ok.any()):
        return 0.0
    err = float(torch.abs(x - ref)[ok].max())
    return err / max(float(torch.abs(ref)[ok].max()), 1e-300)
