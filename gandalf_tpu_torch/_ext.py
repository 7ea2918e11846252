"""Build, load and launch the CUDA kernels K1-K37 of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The build goes
into ``_build/`` beside this file at first use and is redone when the
sources change (the library's name carries a hash of them), so a fresh
checkout builds everything on its first kernel call.  Nothing is built or
loaded at import time.

The wrappers below check device, dtype, shape and contiguity, allocate
every output and scratch tensor with ``torch.empty``, launch on PyTorch's
current stream and raise if the launch reports an error.  Each adds one
to its kernel's count in ``LAUNCHES`` when it launches, and nowhere else
(K5's wrapper launches one kernel per tree level and counts one).  K6
and K7 launched over a group list count under ``tree_walk_list`` and
``tree_near_list``; over all groups, with the Ewald sum under
``tree_walk_ewald`` and ``tree_near_ewald``, else with the fast
multipoles under ``tree_walk_fast`` and ``tree_near_fast``, else K6 with
the gadget2 or eigenmac MAC under ``tree_walk_gadget2`` or
``tree_walk_eigenmac`` and K7 in its meshless finite-volume zeta mode
under ``tree_near_mfv``, and otherwise under their own names; K4-K7
on tables of ``ndim`` < 3 count under these names with ``_1d`` or
``_2d`` appended (after any smoothing-kernel variant), and take no
Ewald sum.  The
N-body kernels K13-K15 count under ``direct_nbody``, ``direct_softened``
and ``direct_snap`` (K14 on stars of ``ndim`` < 3, the star-star pull of
a sink run below 3D, under ``direct_softened_2d`` or ``_1d``), the sink
kernels K16-K18 under ``star_gas_forces``, ``sink_candidate`` and
``accretion_sums`` (each wrapper launches two or three kernels, its
stages, and counts one; ``_1d`` or ``_2d`` appended below 3D).  K1-K3 on a grid of
``ndim`` < 3 count under their names with ``_1d`` or ``_2d`` appended,
K19, the mirror images, under ``grid27_mirror``.  K20's two wrappers
(the smooth-accretion sums and the sink update) each count one under
``smooth_accretion`` (``_1d`` or ``_2d`` appended below 3D); K21, the Cullen & Dehnen switch, counts under
``cullen_dehnen`` (``_1d`` or ``_2d`` appended below 3D), K22, the
neighbour-level pass, under ``levelneib`` (``_1d`` or ``_2d`` appended
below 3D), K23 and K24, the gas-dust
drag sums and energy deposit, under ``dust_drag_sums`` and
``dust_drag_deposit`` in every ndim, K8 and K9, the active-subset
density and forces, under ``active_density`` and ``active_forces``
(``_1d`` or ``_2d`` appended below 3D), and K25 and K26, the Saitoh &
Makino (2012) h-rho iteration with its q sum and the pressure-energy
forces, under ``sm2012_density`` and ``sm2012_forces`` (``_1d`` or
``_2d`` appended below 3D).  The RadWS kernels K27-K29, the opacity-table
EOS, the equilibrium finder and the implicit heating rate, count under
``radws_eos``, ``radws_equilibrium`` and ``radws_implicit_heating``, and
K30, the radiative-feedback ambient temperature, under
``ambient_temperature`` (``_1d`` or ``_2d`` appended below 3D).  K2, K3,
K7, K8, K9, K10-K12, K21, K23-K26 and K31 take the quintic, gaussian
(not K7) and tabulated smoothing kernels as well as M4
(``csrc/kernel_family.cuh``, a template parameter; K12, K23 and K24
build one source per family); with any kernel but the direct M4 they
count under their names with the kernel's variant appended before any
``_1d`` or ``_2d`` (``grid27_density_quintic_tab``,
``tree_near_list_quintic``, ``mfv_fluxes_exact_cell_gaussian_2d``,
``cullen_dehnen_gaussian_2d``, ``dust_drag_sums_m4_tab``).  K14, K16
and K20's first launch take M4 and the quintic, direct or tabulated
(``direct_softened_quintic_2d``, ``star_gas_forces_m4_tab``,
``smooth_accretion_quintic_tab_1d``); their softened gravity refuses the
gaussian (``refuse_gaussian_gravity``, fault F23).  K18 and K20's second
launch read no kernel and count under their M4 names.  The meshless
finite-volume kernels count under ``mfv_density``, ``mfv_gradients``,
``mfv_limiter_<limiter>`` and K12 under ``mfv_fluxes`` with its modes
appended (``mfv_fluxes_exact_cell_static``; block timesteps
``_block``), K32 and K33, the conservative limiter's near and far
passes, under ``mfv_vsig_near`` and ``mfv_vsig_far`` (K33's wrapper
launches its three stages and counts one); each with ``_1d`` or ``_2d``
appended below 3D.  The radiation kernels K34-K37, the per-cell fields,
the ray march, the packet march and the Stromgren prefix select, count
under ``cell_field``, ``ray_march``, ``packet_march`` and
``stromgren_prefix`` (``_1d`` or ``_2d`` appended below 3D; K34's wrapper
launches its two stages and K37's its distances, weights and radix
passes of every round, and each counts one).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from .kernels.smoothing import VARIANTS

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"
_UNITS = ("grid27_bin.cu", "grid27_density.cu", "grid27_forces.cu",
          "grid27_mirror.cu",
          "tree_gather.cu", "tree_build.cu", "tree_walk.cu",
          "tree_walk_2d.cu", "tree_walk_1d.cu", "tree_near.cu",
          "tree_near_2d.cu", "tree_near_1d.cu",
          "active_density.cu", "active_forces.cu", "mfv_density.cu",
          "mfv_gradients.cu", "mfv_limiter.cu",
          # K12 per Riemann solver, ndim and kernel family
          *(f"mfv_fluxes_{_s}_{_n}d_{_f}.cu" for _s in ("hllc", "exact")
            for _n in (1, 2, 3) for _f in ("m4", "quintic", "gaussian")),
          "nbody_direct.cu",
          "star_gas.cu", "sinks.cu", "cullen_dehnen.cu",
          "grid27_levelneib.cu",
          # K23 and K24 per kernel family
          *(f"dust_drag_{_f}.cu" for _f in ("m4", "quintic", "gaussian")),
          "sm2012.cu", "radws.cu", "radiative_fb.cu", "mfv_vsig.cu",
          "radiation.cu", "let_far.cu")
# no --use_fast_math: the float64 parity checks need IEEE sqrt and division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel since the last reset_launches()
LAUNCHES = {"grid27_bin": 0, "grid27_density": 0, "grid27_forces": 0,
            "grid27_bin_2d": 0, "grid27_density_2d": 0,
            "grid27_forces_2d": 0, "grid27_bin_1d": 0,
            "grid27_density_1d": 0, "grid27_forces_1d": 0,
            "grid27_mirror": 0,
            "tree_gather": 0, "tree_build": 0, "tree_walk": 0,
            "tree_near": 0, "tree_walk_list": 0, "tree_near_list": 0,
            "tree_near_mfv": 0, "tree_walk_ewald": 0, "tree_near_ewald": 0,
            "tree_walk_gadget2": 0, "tree_walk_eigenmac": 0,
            "tree_walk_fast": 0, "tree_near_fast": 0, "active_density": 0,
            "active_forces": 0, "active_density_2d": 0,
            "active_forces_2d": 0, "active_density_1d": 0,
            "active_forces_1d": 0,
            "direct_nbody": 0, "direct_softened": 0, "direct_snap": 0,
            "star_gas_forces": 0, "sink_candidate": 0, "accretion_sums": 0,
            "smooth_accretion": 0, "cullen_dehnen": 0,
            "cullen_dehnen_2d": 0, "cullen_dehnen_1d": 0, "levelneib": 0,
            "levelneib_2d": 0, "levelneib_1d": 0,
            "dust_drag_sums": 0, "dust_drag_deposit": 0,
            "sm2012_density": 0, "sm2012_density_2d": 0,
            "sm2012_density_1d": 0, "sm2012_forces": 0,
            "sm2012_forces_2d": 0, "sm2012_forces_1d": 0, "radws_eos": 0,
            "radws_equilibrium": 0, "radws_implicit_heating": 0,
            "ambient_temperature": 0, "cell_field": 0, "ray_march": 0,
            "packet_march": 0, "stromgren_prefix": 0,
            "grid27_bin_slab": 0, "grid27_bin_slab_2d": 0,
            "grid27_bin_slab_1d": 0, "let_far_walk": 0,
            "let_far_walk_2d": 0, "let_far_walk_1d": 0}
# K14, the sink kernels K16-K18, K20 and the radiation kernels K30,
# K34-K37 below 3D
for _k in ("direct_softened", "star_gas_forces", "sink_candidate",
           "accretion_sums", "smooth_accretion", "ambient_temperature",
           "cell_field", "ray_march", "packet_march", "stromgren_prefix"):
    for _d in ("_2d", "_1d"):
        LAUNCHES[f"{_k}{_d}"] = 0

# the meshless finite-volume kernels in every dim, K10-K12 and K31 with
# every smoothing kernel (the variant appended before the dim, as
# family_count and _grid_count form it), K12 in every mode
_DIMS = ("", "_2d", "_1d")
# K31's limiters (csrc/mfv_limiter.cu)
MFV_SWEEP = {"tvdscalar": 0, "springel2009": 1}
for _d in _DIMS:
    LAUNCHES[f"mfv_vsig_near{_d}"] = 0
    LAUNCHES[f"mfv_vsig_far{_d}"] = 0
    for _v in ("",) + tuple(f"_{_x}" for _x in VARIANTS):
        LAUNCHES[f"mfv_density{_v}{_d}"] = 0
        LAUNCHES[f"mfv_gradients{_v}{_d}"] = 0
        for _lim in MFV_SWEEP:
            LAUNCHES[f"mfv_limiter_{_lim}{_v}{_d}"] = 0
        for _r in ("", "_exact"):
            # block timesteps run under MUSCL only
            for _t in ("", "_rk2", "_block"):
                for _c in ("", "_cell", "_zeroslope"):
                    for _st in ("", "_static"):
                        LAUNCHES[f"mfv_fluxes{_r}{_t}{_c}{_st}{_v}{_d}"] = 0

# the smoothing-kernel families of csrc/kernel_family.cuh, and the
# kernels that take any of them, direct or tabulated (K2, K3 and K8, K9;
# K21, K25, K26; K23, K24 in every ndim; K10-K12 and K31 above; K7 in
# each mode, K14, K16 and K20's first launch in every ndim, without the
# gaussian: fault F23).  Launches with a kernel other than the direct M4
# count under the kernel's name with the kernel's variant appended
# (grid27_density_quintic_tab_2d).  K18 and K20's second launch read no
# kernel.
FAMILIES = {"m4": 0, "quintic": 1, "gaussian": 2}
GRID_FAMILY_KERNELS = ("grid27_density", "grid27_forces", "cullen_dehnen",
                       "sm2012_density", "sm2012_forces",
                       "grid27_density_slab", "grid27_forces_slab")
# K2 and K3 on a ghosted slab (a row window) in every ndim, M4
for _k in ("grid27_density_slab", "grid27_forces_slab"):
    for _d in ("", "_2d", "_1d"):
        LAUNCHES[f"{_k}{_d}"] = 0
DUST_FAMILY_KERNELS = ("dust_drag_sums", "dust_drag_deposit")
TREE_FAMILY_KERNELS = ("tree_near", "tree_near_list", "tree_near_ewald",
                       "tree_near_fast", "tree_near_mfv")
SINK_FAMILY_KERNELS = ("direct_softened", "star_gas_forces",
                       "smooth_accretion")
ACTIVE_FAMILY_KERNELS = ("active_density", "active_forces")
for _v in VARIANTS:
    for _k in GRID_FAMILY_KERNELS + ACTIVE_FAMILY_KERNELS:
        for _d in ("", "_2d", "_1d"):
            LAUNCHES[f"{_k}_{_v}{_d}"] = 0
    for _k in DUST_FAMILY_KERNELS:
        LAUNCHES[f"{_k}_{_v}"] = 0
    if not _v.startswith("gaussian"):
        for _k in SINK_FAMILY_KERNELS:
            for _d in ("", "_2d", "_1d"):
                LAUNCHES[f"{_k}_{_v}{_d}"] = 0
        for _k in TREE_FAMILY_KERNELS:
            LAUNCHES[f"{_k}_{_v}"] = 0
            if _k != "tree_near_ewald":
                for _d in ("_2d", "_1d"):
                    LAUNCHES[f"{_k}_{_v}{_d}"] = 0
# K4-K7 below 3D: every launch name but the Ewald sum's (3D only)
for _k in ("tree_gather", "tree_build", "tree_walk", "tree_near",
           "tree_walk_list", "tree_near_list", "tree_near_mfv",
           "tree_walk_gadget2", "tree_walk_eigenmac", "tree_walk_fast",
           "tree_near_fast"):
    for _d in ("_2d", "_1d"):
        LAUNCHES[f"{_k}{_d}"] = 0

_lib = None

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_L = ctypes.c_longlong
# the opacity table's arguments of K27-K29: 7 arrays, nd, nt, fcol2,
# 4 rad_const and temp_min
_TABLE = [_P] * 7 + [_I, _I, _D, _D, _D]
_ARGTYPES = {
    # K1 takes zrow_max after k_cell; K2 and K3 qz and the row window
    # (first row, row count) before the mapping
    "grid27_bin": [_P, _P, _I, _I, _I, _I, _I, _D, _D, _D, _D, _D, _D, _I,
                   _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "grid27_density": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _D, _D, _D, _D, _I, _I, _D, _D, _D, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _P],
    "grid27_forces": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _D, _D, _D, _D, _I, _I, _I, _I, _D, _D, _P, _P, _P,
                      _I, _I, _I, _I, _I, _P],
    # K38: pub, n_far, n_cells, ccols, depth, quad, leaf centre, leaf
    # half, targets, live targets, G, L, Wr, theta^2, a, pot, flag
    **{f"let_far_walk_{_n}d": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                               _I, _I, _D, _P, _P, _P, _I, _P]
       for _n in (1, 2, 3)},
    "grid27_mirror": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P],
    # K4-K7 per NDIM (csrc/tree_*.cu)
    **{f"tree_gather_{_n}d": [_P, _I, _P, _P, _P, _P, _P, _I, _D, _D, _D,
                              _P, _P, _I, _P] for _n in (1, 2, 3)},
    **{f"tree_build_{_n}d": [_P, _P, _I, _I, _P, _P, _I, _P]
       for _n in (1, 2, 3)},
    **{f"tree_walk_{_n}d": [_P, _P, _P, _P, _I, _I, _I, _P, _D, _I, _I, _I,
                            _D, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P]
       for _n in (1, 2, 3)},
    **{f"tree_near_{_n}d": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _D, _D, _I, _I, _P, _P, _P, _P, _P,
                            _I, _P] for _n in (1, 2, 3)},
    # K8 and K9: the grid arguments of _grid_args_nd (8 ints, 3 extents)
    "active_density": [_P, _I] + [_P] * 5 + [_I] * 8 + [_D] * 4
    + [_I, _I, _D, _D, _D] + [_P] * 4 + [_I, _P],
    "active_forces": [_P, _I] + [_P] * 6 + [_I] * 8 + [_D] * 4
    + [_I, _I, _D, _I, _I, _I, _D, _D] + [_P] * 4 + [_I, _P],
    # the grid arguments of _grid_args_nd: 8 ints and 3 extents
    # K10 and K11: the grid arguments, then norm, family and table
    # resolution (_family_args)
    "mfv_density": [_P] * 4 + [_I] * 8 + [_D] * 4 + [_I, _I] + [_D] * 4
    + [_I] + [_P] * 4 + [_I, _P],
    "mfv_gradients": [_P] * 3 + [_I] * 8 + [_D] * 4 + [_I] * 3 + [_P] * 7
    + [_I, _P],
    "mfv_limiter": [_P] * 6 + [_I] * 8 + [_D] * 4 + [_I] * 2 + [_P]
    + [_I, _P],
    # K12 per Riemann solver, NDIM and kernel family: the grid arguments
    # without ndim, norm and table resolution
    **{f"mfv_fluxes_{_s}_{_n}d_{_f}": [_P] * 4 + [_I] * 7 + [_D] * 4
       + [_I, _D] + [_I] * 6 + [_P] * 4 + [_I, _P]
       for _s in ("hllc", "exact") for _n in (1, 2, 3)
       for _f in ("m4", "quintic", "gaussian")},
    "mfv_vsig_near": [_P] * 5 + [_I] * 8 + [_D] * 3 + [_P, _I, _P],
    "mfv_vsig_far": [_P] * 3 + [_I] * 8 + [_D] * 12 + [_I] + [_P] * 4
    + [_I, _P],
    "direct_nbody": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    # K14: n, ndim, jerk, then norm, family and table resolution
    "direct_softened": [_P, _P, _P, _P, _I, _I, _I, _D, _I, _I, _P, _P, _P,
                        _I, _P],
    "direct_snap": [_P, _P, _P, _P, _I, _I, _P, _I, _P],
    # K16-K18 and K20 per NDIM (csrc/star_gas.cu, csrc/sinks.cu): the 3D
    # names, and the same with _2d and _1d; K16 and K20's sums take norm,
    # family and table resolution
    **{f"star_gas_forces{_d}": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _D, _I,
                                _I, _P, _P, _P, _P, _P, _I, _P]
       for _d in _DIMS},
    **{f"sink_candidate{_d}": [_P, _P, _I, _D, _P, _P, _P, _P, _P, _P, _P,
                               _P, _I, _P] for _d in _DIMS},
    **{f"accretion_sums{_d}": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _D, _P,
                               _P, _P, _P, _P, _P, _I, _P] for _d in _DIMS},
    **{f"smooth_accretion_sums{_d}": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                                      _P, _P, _I, _D, _P, _D, _I, _I, _D, _D,
                                      _D, _D, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _I, _P] for _d in _DIMS},
    **{f"smooth_accretion_apply{_d}": [_P, _P, _P, _P, _P, _P, _I, _P, _P,
                                       _P, _P, _P, _P, _P, _I, _P, _P, _P,
                                       _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _P] for _d in _DIMS},
    # K21, K25 and K26: the grid arguments, then norm, family and table
    # resolution (_family_args)
    "cullen_dehnen": [_P] * 3 + [_I] * 8 + [_D] * 4 + [_I, _I, _D, _D]
    + [_P] * 3 + [_I, _P],
    "levelneib": [_P] * 5 + [_I] * 8 + [_D] * 4 + [_I, _P],
    # K23 and K24 per kernel family (csrc/dust_drag_<family>.cu): the
    # grid arguments, norm, normdrag and table resolution
    **{f"dust_drag_sums_{_f}": [_P, _I] + [_P] * 5 + [_I] * 8 + [_D] * 5
       + [_I, _I, _D, _D, _I] + [_P] * 4 + [_I, _P] for _f in FAMILIES},
    **{f"dust_drag_deposit_{_f}": [_P, _I] + [_P] * 5 + [_I] * 8
       + [_D] * 5 + [_I, _P, _I, _P] for _f in FAMILIES},
    "sm2012_density": [_P] * 5 + [_I] * 8 + [_D] * 4 + [_I, _I] + [_D] * 3
    + [_P] * 5 + [_I, _P],
    "sm2012_forces": [_P] * 4 + [_I] * 8 + [_D] * 4 + [_I, _I, _D, _I, _D,
                                                        _D] + [_P] * 3
    + [_I, _P],
    "radws_eos": _TABLE + [_P, _P, _L, _P, _P, _P, _I, _P],
    "radws_equilibrium": _TABLE + [_P, _P, _P, _P, _P, _I, _L, _P, _P, _P,
                                   _I, _P],
    "radws_implicit_heating": _TABLE + [_P, _P, _P, _P, _P, _I, _P, _I, _L,
                                        _P, _P, _I, _P],
    "ambient_temperature": [_P, _I, _I, _P, _P, _P, _P, _I, _D, _I, _P, _D,
                            _D, _D, _P, _I, _P],
    "cell_field": [_P, _P, _I, _I, _I, _P, _P, _P, _D, _D, _P, _P, _I, _P],
    # the radiation grid's arguments (_radiation_grid): nd, 3 cells, 3 lo,
    # 3 extents, 3 periodic flags
    "ray_march": [_I] * 4 + [_D] * 6 + [_I] * 3 + [_P, _P, _P, _I, _P, _I,
                                                    _I, _I, _P, _I, _P],
    "packet_march": [_I] * 4 + [_D] * 6 + [_I] * 3 + [_P, _P, _P, _I, _I,
                                                       _D, _P, _P, _P, _P,
                                                       _I, _P],
    "stromgren_prefix": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                         _P, _P, _P, _P, _I, _P],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return _BUILD / f"libgandalf_kernels_{_source_hash()}.so"


def build() -> Path:
    """Compile csrc/ into the shared library unless it is current: one
    nvcc per source, all started together, then one link.  The
    compiler's output (register and spill counts) goes to a .log beside
    the library, and each source's wall time from the common start to
    its compiler's exit to a .times.json (build_times).  Returns the
    library's path."""
    so = library_path()
    if so.exists():
        return so
    _BUILD.mkdir(exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [_BUILD / f"{tag}.{Path(u).stem}.o" for u in _UNITS]
    outs = [o.with_suffix(".out") for o in objs]
    t0 = time.perf_counter()
    procs = []
    for u, o, out in zip(_UNITS, objs, outs):
        with open(out, "w") as f:
            procs.append(subprocess.Popen(
                [_nvcc(), *compile_flags, "-c", "-o", str(o),
                 str(_CSRC / u)], stdout=f, stderr=subprocess.STDOUT))
    times = {}
    while len(times) < len(procs):
        for u, p in zip(_UNITS, procs):
            if u not in times and p.poll() is not None:
                times[u] = time.perf_counter() - t0
        time.sleep(0.05)
    logs = [out.read_text() for out in outs]
    tmp = so.with_name(f"{tag}.tmp")
    link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    times["link"] = time.perf_counter() - t0
    log = "".join(logs) + link.stdout + link.stderr
    so.with_suffix(".log").write_text(log)
    so.with_suffix(".times.json").write_text(json.dumps(times))
    for o in objs + outs:
        o.unlink(missing_ok=True)
    failed = [u for u, p in zip(_UNITS, procs) if p.returncode != 0]
    if failed or link.returncode != 0:
        tmp.unlink(missing_ok=True)
        # the failed units' own output (their errors), else the link's
        why = "".join(lg for p, lg in zip(procs, logs) if p.returncode != 0)
        raise RuntimeError(f"nvcc failed ({failed or 'link'}):\n"
                           + (why or link.stdout + link.stderr)[-6000:])
    os.replace(tmp, so)
    return so


def build_times() -> dict:
    """{source: seconds from the build's start to its compiler's exit,
    "link": to the link's end} of the current library's build ({} if it
    was built elsewhere)."""
    f = library_path().with_suffix(".times.json")
    return json.loads(f.read_text()) if f.exists() else {}


def build_log() -> str:
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def ptxas_report() -> str:
    """ptxas's lines of the build log as it wrote them: each kernel's
    entry function (its mangled name), then its stack frame, spill bytes
    and registers."""
    keep = ("entry function", "Function properties", "stack frame",
            "registers")
    return "\n".join(ln for ln in build_log().splitlines()
                     if any(k in ln for k in keep))


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        dll = ctypes.CDLL(str(build()))
        for name, types in _ARGTYPES.items():
            for sfx in _SUFFIX.values():
                fn = getattr(dll, f"{name}_{sfx}")
                fn.argtypes = types
                fn.restype = ctypes.c_int
        dll.grid27_error_string.argtypes = [ctypes.c_int]
        dll.grid27_error_string.restype = ctypes.c_char_p
        dll.sink_candidate_blocks.argtypes = [ctypes.c_int]
        dll.sink_candidate_blocks.restype = ctypes.c_int
        _lib = dll
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _float_suffix(dtype) -> str:
    if dtype not in _SUFFIX:
        raise TypeError(f"the CUDA kernels take float32 or float64, not "
                        f"{dtype}")
    return _SUFFIX[dtype]


def _grid_args(spec):
    """The grid arguments of K8 and K9 (the active-subset kernels), in
    1-3 dims: _grid_args_nd's; mirror layers are refused."""
    if spec.mirror:
        raise NotImplementedError(
            "the active-subset kernels take no mirror layers (ROADMAP "
            "queue 1, item 8)")
    return _grid_args_nd(spec)


def _grid_args_nd(spec, any_qz: bool = False):
    """ndim, then the grid's cells, K, periodic flags and extents padded
    to three dims (n = 1, open, extent 0 in the dims beyond ndim): the
    arguments of the grid kernels.  Only K2 and K3 (`any_qz`) take the
    distributed planner's z-slab stencil (qz > 1); the others refuse it
    (ROADMAP queue 1, item 13)."""
    if spec.qz != 1 and not any_qz:
        raise NotImplementedError(
            "this grid kernel takes qz = 1; z-slab plans reach K1-K3 only "
            "(ROADMAP queue 1, item 13)")
    pad = 3 - spec.ndim
    return (spec.ndim, *spec.ncells, *(1,) * pad, spec.k_cell,
            *[int(p) for p in spec.periodic], *(0,) * pad,
            *[float(x) for x in spec.extents], *(0.0,) * pad)


def family_count(name: str, kern) -> str:
    """`name` with the variant of smoothing kernel `kern` appended, for
    any kernel but the direct M4 (or None: Newtonian)."""
    if kern is None or kern.variant == "m4":
        return name
    return f"{name}_{kern.variant}"


def _grid_count(name: str, spec, kern=None) -> str:
    """The LAUNCHES key of grid kernel `name` on `spec`'s dims, with
    `kern`'s variant (family_count)."""
    name = family_count(name, kern)
    return name if spec.ndim == 3 else f"{name}_{spec.ndim}d"


def _family_args(kern):
    """(norm, family, table resolution) of smoothing kernel `kern` for a
    kernel of csrc/kernel_family.cuh."""
    return float(kern.kernnorm), FAMILIES[kern.name], int(kern.table_res)


def refuse_gaussian_gravity(kern, what: str) -> None:
    """Refuse the gaussian kernel, direct or tabulated, for `what`, a use
    of its softened gravity: the JAX package's gaussian wgrav and wpot
    are zero (ROADMAP queue 3, fault F23).  None (no kernel) passes."""
    if kern is not None and kern.name == "gaussian":
        raise NotImplementedError(
            "the gaussian kernel has no softened gravity (its wgrav and "
            f"wpot are zero): {what} with it is refused (ROADMAP queue 3, "
            "fault F23)")


def _softened_args(kern, what: str):
    """(norm, family, table resolution) of the softening kernel `kern`
    of K14, K16 or K20 (None: the direct M4, whose wgrav and wpot take no
    norm), the gaussian refused first (refuse_gaussian_gravity)."""
    refuse_gaussian_gravity(kern, what)
    return (0.0, FAMILIES["m4"], 0) if kern is None else _family_args(kern)


def _launch(name: str, dtype, device: torch.device, *args,
            count: str = None) -> None:
    fn = getattr(lib(), f"{name}_{_float_suffix(dtype)}")
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, device.index, stream)
    if rc != 0:
        msg = lib().grid27_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (code {rc})")
    LAUNCHES[count or name] += 1


def _p(t: torch.Tensor) -> int:
    return t.data_ptr()


def grid27_bin(spec, r: torch.Tensor, discard: torch.Tensor = None,
               zrow_max: int = None):
    """K1 on r (N, ndim): (cell_of, slot_of) int32 (N,) and overflow ().
    With `discard` (N,) bool a discarded particle goes to the virtual
    cell C = spec.total_cells with slot 0, takes no slot and raises no
    overflow.  `zrow_max` clamps the dim-0 cell index to at most it (a
    shard's slab; counted as grid27_bin_slab)."""
    N, nd = r.shape[0], spec.ndim
    _check(r, "r", r.dtype, (N, nd))
    if discard is not None:
        _check(discard, "discard", torch.bool, (N,))
    dev = r.device
    C = spec.total_cells
    i32 = dict(dtype=torch.int32, device=dev)
    count = torch.empty((C,), **i32)
    offset = torch.empty((C + 1,), **i32)
    rank_tmp = torch.empty((N,), **i32)
    members = torch.empty((N,), **i32)
    cell_of = torch.empty((N,), **i32)
    slot_of = torch.empty((N,), **i32)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    pad = 3 - nd
    _launch("grid27_bin", r.dtype, dev, _p(r),
            None if discard is None else _p(discard), N, nd, *spec.ncells,
            *(1,) * pad, *[float(x) for x in spec.lo], *(0.0,) * pad,
            *[float(x) for x in spec.extents], *(1.0,) * pad, spec.k_cell,
            spec.ncells[0] - 1 if zrow_max is None else int(zrow_max),
            _p(count), _p(offset), _p(rank_tmp), _p(members), _p(cell_of),
            _p(slot_of), _p(overflow),
            count=_grid_count("grid27_bin" if zrow_max is None
                              else "grid27_bin_slab", spec))
    return cell_of, slot_of, overflow


# K2's and K3's thread mappings: chosen by the grid (one block per cell
# in 3D with K >= 32, else flat over (cell, slot): csrc/grid27.cuh), or
# forced, for timing the two
SLOT_MAPPINGS = {"auto": 0, "cell": 1, "flat": 2}


def _row_window(spec, rows_win):
    """(qz, first row, row count) of K2's and K3's launch: the whole grid,
    or the dim-0 rows [lo, hi) of a ghosted slab."""
    lo, hi = (0, spec.ncells[0]) if rows_win is None else rows_win
    if not 0 <= lo <= hi <= spec.ncells[0]:
        raise ValueError(f"row window {rows_win} outside the grid's "
                         f"{spec.ncells[0]} rows")
    return spec.qz, int(lo), int(hi - lo)


def _windowed(shape, dt, dev, rows_win, fill_value):
    """An output of K2 or K3: empty for the whole grid; with a row window
    `fill_value` outside it, where the kernel writes nothing."""
    if rows_win is None:
        return torch.empty(shape, dtype=dt, device=dev)
    return torch.full(shape, fill_value, dtype=dt, device=dev)


def grid27_density(spec, kern, h_fac, h_converge, hmax, r_d, m_d, h_d,
                   fill, target=None, mapping="auto", rows_win=None):
    """K2 on dense (*ncells, K[, ndim]) tensors: (rho, invom, zeta) sums
    at each slot's final h and its converged flag.  With `target`
    (*ncells, K) bool only the filled target slots iterate; the others
    are neighbours only and come back zero and converged.  With
    `rows_win` (lo, hi) only the dim-0 rows [lo, hi) are targets (a
    ghosted slab, counted as grid27_density_slab); the rows outside come
    back zero and converged.  `mapping` is a key of SLOT_MAPPINGS."""
    shape = tuple(spec.ncells) + (spec.k_cell,)
    dt = r_d.dtype
    _check(r_d, "r_d", dt, shape + (spec.ndim,))
    _check(m_d, "m_d", dt, shape)
    _check(h_d, "h_d", dt, shape)
    _check(fill, "fill", torch.bool, shape)
    if target is not None:
        _check(target, "target", torch.bool, shape)
    dev = r_d.device
    rho, invom, zeta = (_windowed(shape, dt, dev, rows_win, 0.0)
                        for _ in range(3))
    done = _windowed(shape, torch.bool, dev, rows_win, True)
    name = "grid27_density" if rows_win is None else "grid27_density_slab"
    _launch("grid27_density", dt, dev, _p(r_d), _p(m_d), _p(h_d),
            _p(fill), None if target is None else _p(target),
            *_grid_args_nd(spec, True), *_family_args(kern), float(h_fac),
            float(h_converge), float(hmax), _p(rho), _p(invom), _p(zeta),
            _p(done), *_row_window(spec, rows_win), SLOT_MAPPINGS[mapping],
            count=_grid_count(name, spec, kern))
    return rho, invom, zeta, done


def grid27_forces(spec, kern, visc, r_d, v_d, packed, fill,
                  mapping="auto", rows_win=None):
    """K3 on dense tensors: pair sums a (*ncells, K, ndim), dudt and the
    unnormalised div_v (*ncells, K).  `packed` (*ncells, K, 9) holds
    ops.sph_grid27.FORCE_SCALARS; `mapping` is a key of SLOT_MAPPINGS.
    With `rows_win` (lo, hi) only the dim-0 rows [lo, hi) are targets
    (counted as grid27_forces_slab); the others come back zero."""
    shape = tuple(spec.ncells) + (spec.k_cell,)
    dt, nd = r_d.dtype, spec.ndim
    _check(r_d, "r_d", dt, shape + (nd,))
    _check(v_d, "v_d", dt, shape + (nd,))
    _check(packed, "packed", dt, shape + (9,))
    _check(fill, "fill", torch.bool, shape)
    dev = r_d.device
    a = _windowed(shape + (nd,), dt, dev, rows_win, 0.0)
    dudt = _windowed(shape, dt, dev, rows_win, 0.0)
    div_v = _windowed(shape, dt, dev, rows_win, 0.0)
    name = "grid27_forces" if rows_win is None else "grid27_forces_slab"
    _launch("grid27_forces", dt, dev, _p(r_d), _p(v_d), _p(packed),
            _p(fill), *_grid_args_nd(spec, True), *_family_args(kern),
            int(visc.avisc), int(visc.acond), float(visc.alpha_visc),
            float(visc.beta_visc), _p(a), _p(dudt), _p(div_v),
            *_row_window(spec, rows_win), SLOT_MAPPINGS[mapping],
            count=_grid_count(name, spec, kern))
    return a, dudt, div_v


MAX_WALLS = 6


class _MirrorWalls(ctypes.Structure):
    """csrc/grid27_mirror.cu's MirrorWalls."""
    _fields_ = [("n", ctypes.c_int), ("dim", ctypes.c_int * MAX_WALLS),
                ("bound", ctypes.c_double * MAX_WALLS),
                ("rad", ctypes.c_double * MAX_WALLS)]


def grid27_mirror(walls, r, v, alive=None):
    """K19: the (1+W) N extended set of r, v (N, ndim) for the W walls
    ((dim, plane, radius) triples): copy 0 the particles, copy w their
    reflections in wall w (r_k -> 2 plane - r_k, v_k -> -v_k), and keep
    ((1+W) N,) bool, alive (all without `alive`) for copy 0 and alive &
    |r_k - plane| < radius for copy w."""
    N, nd = r.shape
    dt, dev = r.dtype, r.device
    _check(r, "r", dt, (N, nd))
    _check(v, "v", dt, (N, nd))
    if alive is not None:
        _check(alive, "alive", torch.bool, (N,))
    if len(walls) > MAX_WALLS:
        raise ValueError(f"at most {MAX_WALLS} walls, not {len(walls)}")
    w = _MirrorWalls()
    w.n = len(walls)
    for i, (k, plane, rad) in enumerate(walls):
        w.dim[i], w.bound[i], w.rad[i] = int(k), float(plane), float(rad)
    M = (1 + len(walls)) * N
    r_out = torch.empty((M, nd), dtype=dt, device=dev)
    v_out = torch.empty((M, nd), dtype=dt, device=dev)
    keep = torch.empty((M,), dtype=torch.bool, device=dev)
    _launch("grid27_mirror", dt, dev, _p(r), _p(v),
            None if alive is None else _p(alive), N, nd, ctypes.byref(w),
            _p(r_out), _p(v_out), _p(keep))
    return r_out, v_out, keep


# ---------------------------------------------------------------------------
# Tree gravity, K4-K7 (layouts of ops/tree.py)
# ---------------------------------------------------------------------------

_LEAF = 32


def _tree_shapes(spec):
    if spec.leaf_size != _LEAF:
        raise NotImplementedError(f"the tree kernels take buckets of "
                                  f"{_LEAF} slots, not {spec.leaf_size}")
    G = spec.n_leaves
    return G, G * _LEAF, (2 << spec.depth) - 1


def _tree_layout(ptab, ewald=None):
    """ops.tree.layout of a slot table (S, ndim + 3), checked to be a
    CUDA tensor first; an Ewald sum below 3D is refused."""
    from .ops.tree import layout, require_3d_ewald

    if not ptab.is_cuda:
        raise ValueError(f"ptab: expected a CUDA tensor, got {ptab.device}")
    if ptab.dim() != 2 or ptab.shape[1] - 3 not in (1, 2, 3):
        raise ValueError(f"ptab: expected (S, ndim + 3) with ndim 1-3, got "
                         f"{tuple(ptab.shape)}")
    require_3d_ewald(ptab.shape[1] - 3, ewald)
    return layout(ptab.shape[1] - 3)


def tree_count(name: str, ndim: int) -> str:
    """The LAUNCHES key of tree launch `name` in `ndim` dims (_1d or _2d
    appended below 3D, after any smoothing-kernel variant)."""
    return name if ndim == 3 else f"{name}_{ndim}d"


def tree_gather(spec, gmap, r, m, h, zh, periodic_extent, alive=None):
    """K4: slot table (G*32, ndim + 3) and alive (G*32,) bool from
    particle fields, r (N, ndim) with ndim 1-3 (h, zh may be None),
    through gmap (G, 32) int32; with `alive` (N,) bool a slot's flag is
    also its particle's."""
    G, S, _ = _tree_shapes(spec)
    N, dt, dev = r.shape[0], r.dtype, r.device
    _check(gmap, "gmap", torch.int32, (G, _LEAF))
    nd = r.shape[1] if r.dim() == 2 else 0
    if nd not in (1, 2, 3):
        raise ValueError(f"r: expected (N, ndim) with ndim 1-3, got "
                         f"{tuple(r.shape)}")
    _check(r, "r", dt, (N, nd))
    _check(m, "m", dt, (N,))
    for name, x in (("h", h), ("zh", zh)):
        if x is not None:
            _check(x, name, dt, (N,))
    if alive is not None:
        _check(alive, "alive", torch.bool, (N,))
    ext = [0.0] * 3
    if periodic_extent is not None:
        ext[:nd] = [float(e) for e in periodic_extent][:nd]
    ptab = torch.empty((S, nd + 3), dtype=dt, device=dev)
    slot_alive = torch.empty((S,), dtype=torch.bool, device=dev)
    _launch(f"tree_gather_{nd}d", dt, dev, _p(gmap), G, _p(r), _p(m),
            None if h is None else _p(h), None if zh is None else _p(zh),
            None if alive is None else _p(alive),
            int(periodic_extent is not None), *ext, _p(ptab), _p(slot_alive),
            count=tree_count("tree_gather", nd))
    return ptab, slot_alive


def tree_build(spec, ptab, alive):
    """K5: the level-concatenated cell table (2^(D+1) - 1,
    ops.tree.layout(ndim).ccols) of a slot table (S, ndim + 3)."""
    _, S, rows = _tree_shapes(spec)
    lay = _tree_layout(ptab)
    dt, dev = ptab.dtype, ptab.device
    _check(ptab, "ptab", dt, (S, lay.pcols))
    _check(alive, "alive", torch.bool, (S,))
    ctab = torch.empty((rows, lay.ccols), dtype=dt, device=dev)
    box = torch.empty((rows, 2 * lay.ndim), dtype=dt, device=dev)
    _launch(f"tree_build_{lay.ndim}d", dt, dev, _p(ptab), _p(alive),
            spec.depth, int(spec.quadrupole), _p(ctab), _p(box),
            count=tree_count("tree_build", lay.ndim))
    return ctab


def _group_list(spec, group_ids, dev):
    """(pointer, count) of a group list, checked; (None, 2^depth) for
    all groups."""
    if group_ids is None:
        return None, spec.n_leaves
    _check(group_ids, "group_ids", torch.int32, (group_ids.numel(),))
    if group_ids.device != dev:
        raise ValueError("group_ids: expected the tables' device")
    return _p(group_ids), group_ids.numel()


_MACS = {"geometric": 0, "gadget2": 1, "eigenmac": 2}


def _ewald_args(ewald, dt, dev):
    """(table pointer, metadata array) of an (EwaldTable, extent) pair,
    or (None, None); the caller keeps the array alive over the call."""
    if ewald is None:
        return None, None
    table, extent = ewald
    tab = table.tensor(dev, dt)
    return tab, table.meta(extent)


def launch_names(spec, ewald=False, listed=False, mfv=False, kern=None,
                 ndim=3):
    """The LAUNCHES names (K6, K7) of a walk with TreeSpec `spec`, with
    or without the Ewald sum, over a group list or all groups, and (K7)
    in the SPH or the MFV zeta mode, with the smoothing kernel `kern`
    (family_count), in `ndim` dims (tree_count)."""
    if listed:
        walk, near = "tree_walk_list", "tree_near_list"
    elif ewald:
        walk, near = "tree_walk_ewald", "tree_near_ewald"
    elif spec.fast:
        walk, near = "tree_walk_fast", "tree_near_fast"
    else:
        walk = ("tree_walk" if spec.mac == "geometric"
                else f"tree_walk_{spec.mac}")
        near = "tree_near_mfv" if mfv else "tree_near"
    return (tree_count(walk, ndim),
            tree_count(family_count(near, kern), ndim))


def tree_walk(spec, ctab, ptab, alive, group_ids=None, gfac=None,
              ewald=None):
    """K6 on the tables of ndim 1-3 dims: far a (G*32, ndim), far pot
    (G*32,), near list (G, Wn) int32 and overflow () bool; with
    spec.fast the first two are the groups' expansions (G,
    ops.tree.layout(ndim).fast_cols) (a0, pot0, Jacobian) and None.
    `gfac` (G,) is the per-group factor of the gadget2 or eigenmac MAC
    (required with either); `ewald` an (EwaldTable, extent) pair for the
    periodic walk (3D only).  With `group_ids` (G_act,) int32 only the
    listed groups walk: their rows are written, the others hold zeros
    (a, pot) and -1 (near)."""
    G, S, rows = _tree_shapes(spec)
    lay = _tree_layout(ptab, ewald)
    nd = lay.ndim
    dt, dev = ptab.dtype, ptab.device
    _check(ctab, "ctab", dt, (rows, lay.ccols))
    _check(ptab, "ptab", dt, (S, lay.pcols))
    _check(alive, "alive", torch.bool, (S,))
    mac = _MACS[spec.mac]
    if mac:
        if gfac is None:
            raise ValueError(f"the {spec.mac} MAC needs its per-group factor")
        _check(gfac, "gfac", dt, (G,))
    gptr, n_groups = _group_list(spec, group_ids, dev)
    caps = [1] + [spec.level_cap(ell) for ell in range(1, spec.depth + 1)]
    caps_c = (ctypes.c_int * len(caps))(*caps)
    listed = group_ids is not None
    alloc = torch.zeros if listed else torch.empty
    if spec.fast:
        a_far, pot_far = alloc((G, lay.fast_cols), dtype=dt,
                               device=dev), None
    else:
        a_far = alloc((S, nd), dtype=dt, device=dev)
        pot_far = alloc((S,), dtype=dt, device=dev)
    near = (torch.full((G, spec.near_cap), -1, dtype=torch.int32,
                       device=dev) if listed else
            torch.empty((G, spec.near_cap), dtype=torch.int32, device=dev))
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    tab, meta = _ewald_args(ewald, dt, dev)
    count = launch_names(spec, tab is not None, listed, ndim=nd)[0]
    if n_groups:
        _launch(f"tree_walk_{nd}d", dt, dev, _p(ctab), _p(ptab), _p(alive),
                gptr, n_groups, spec.depth, spec.near_cap, ctypes.addressof(caps_c),
                float(spec.theta_sqd), int(spec.quadrupole), int(spec.fast),
                mac, float(spec.macerror), _p(gfac) if mac else None,
                None if tab is None else _p(tab),
                None if meta is None else meta.ctypes.data,
                None if spec.fast else _p(a_far),
                None if spec.fast else _p(pot_far),
                _p(a_far) if spec.fast else None, _p(near), _p(overflow),
                count=count)
    return a_far, pot_far, near, overflow


def tree_near(spec, kern, ctab, ptab, alive, near, a_far, pot_far,
              out_index, n_out, group_ids=None, zeta_scaling="sph",
              ewald=None):
    """K7 on the tables of ndim 1-3 dims: a (n_out, ndim), gpot (n_out,)
    at rows out_index[slot] of the live slots (zero elsewhere), and the
    support overflow () bool.  `kern` None sums Newtonian pairs only.
    With spec.fast, `a_far` is K6's (G, ops.tree.layout(ndim).fast_cols)
    expansions and `pot_far` None.  `ewald` an (EwaldTable, extent) pair
    (3D only) min-images each pair and adds the table's correction.
    With `group_ids` only the listed groups' slots are written.
    `zeta_scaling` "mfv" takes the meshless finite-volume zeta term."""
    mfv = zeta_scaling == "mfv"
    if mfv and group_ids is not None:
        raise NotImplementedError("the MFV zeta mode walks all groups")
    refuse_gaussian_gravity(kern, "self-gravity")
    G, S, rows = _tree_shapes(spec)
    lay = _tree_layout(ptab, ewald)
    nd = lay.ndim
    dt, dev = ptab.dtype, ptab.device
    _check(ctab, "ctab", dt, (rows, lay.ccols))
    _check(ptab, "ptab", dt, (S, lay.pcols))
    _check(alive, "alive", torch.bool, (S,))
    _check(near, "near", torch.int32, (G, spec.near_cap))
    if spec.fast:
        _check(a_far, "a_far", dt, (G, lay.fast_cols))
        if pot_far is not None:
            raise ValueError("pot_far: the fast multipoles take None")
    else:
        _check(a_far, "a_far", dt, (S, nd))
        _check(pot_far, "pot_far", dt, (S,))
    out_index = out_index.reshape(-1)
    _check(out_index, "out_index", torch.int32, (S,))
    gptr, n_groups = _group_list(spec, group_ids, dev)
    a = torch.zeros((n_out, nd), dtype=dt, device=dev)
    gpot = torch.zeros((n_out,), dtype=dt, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    smoothed = kern is not None
    tab, meta = _ewald_args(ewald, dt, dev)
    count = launch_names(spec, tab is not None, group_ids is not None,
                         mfv, kern, nd)[1]
    if n_groups:
        _launch(f"tree_near_{nd}d", dt, dev, _p(ctab), _p(ptab), _p(alive),
                _p(near), None if spec.fast else _p(a_far),
                None if spec.fast else _p(pot_far),
                _p(a_far) if spec.fast else None, _p(out_index), gptr,
                n_groups, spec.depth, spec.near_cap, spec.support_cap,
                int(smoothed), int(mfv),
                float(kern.kernrange) if smoothed else 0.0,
                *(_family_args(kern) if smoothed else (0.0, 0, 0)),
                None if tab is None else _p(tab),
                None if meta is None else meta.ctypes.data, _p(a), _p(gpot),
                _p(overflow), count=count)
    return a, gpot, overflow


def let_far_walk(tabs, leaf_cen, leaf_half, rt, alive, leaf_size, wr,
                 theta_sqd, quadrupole):
    """K38: the far field of the far shards' cell tables tabs (n_far,
    2^(D+1) - 1, ops.tree.layout(ndim).ccols) at the targets rt (G*32,
    ndim), live where alive (G*32,) bool, of G local groups with boxes
    leaf_cen, leaf_half (G, ndim): a (G*32, ndim), pot (G*32,) and the
    per-group flag (G,) bool."""
    from .ops.tree import layout

    if leaf_size != _LEAF:
        raise NotImplementedError(f"the far walk takes buckets of {_LEAF} "
                                  f"slots, not {leaf_size}")
    G, nd = leaf_cen.shape
    lay = layout(nd)
    n_far, rows = tabs.shape[0], tabs.shape[1]
    depth = int(round(math.log2(rows + 1))) - 1
    dt, dev = rt.dtype, rt.device
    _check(tabs, "tabs", dt, (n_far, rows, lay.ccols))
    _check(leaf_cen, "leaf_cen", dt, (G, nd))
    _check(leaf_half, "leaf_half", dt, (G, nd))
    _check(rt, "rt", dt, (G * _LEAF, nd))
    _check(alive, "alive", torch.bool, (G * _LEAF,))
    a = torch.zeros((G * _LEAF, nd), dtype=dt, device=dev)
    pot = torch.zeros((G * _LEAF,), dtype=dt, device=dev)
    flag = torch.zeros((G,), dtype=torch.bool, device=dev)
    if n_far and G:
        _launch(f"let_far_walk_{nd}d", dt, dev, _p(tabs), n_far, rows,
                lay.ccols, depth, int(quadrupole), _p(leaf_cen),
                _p(leaf_half), _p(rt), _p(alive), G, _LEAF, int(wr), float(theta_sqd),
                _p(a), _p(pot), _p(flag),
                count=tree_count("let_far_walk", nd))
    return a, pot, flag


# ---------------------------------------------------------------------------
# Active-subset hydro, K8 and K9 (layouts of ops/active_grid.py)
# ---------------------------------------------------------------------------

def _active_args(spec, idx, cell_of, ids_d, N):
    n = idx.numel()
    _check(idx, "idx", torch.int32, (n,))
    _check(cell_of, "cell_of", torch.int32, (N,))
    _check(ids_d, "ids_d", torch.int32, tuple(spec.ncells) + (spec.k_cell,))
    return n


def active_density(spec, kern, h_fac, h_converge, hmax, idx, cell_of,
                   ids_d, r, m, h):
    """K8: the h-rho iteration of the particles idx (n,) int32 from their
    own h over the 3^ndim cells of K1's slot map ids_d (*ncells, K) int32
    (-1 empty), r (N, ndim): (rho, invom, zeta) sums at the final h and
    the converged flag, each (n,)."""
    N, dt, dev = r.shape[0], r.dtype, r.device
    n = _active_args(spec, idx, cell_of, ids_d, N)
    _check(r, "r", dt, (N, spec.ndim))
    _check(m, "m", dt, (N,))
    _check(h, "h", dt, (N,))
    rho, invom, zeta = (torch.empty((n,), dtype=dt, device=dev)
                        for _ in range(3))
    done = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        _launch("active_density", dt, dev, _p(idx), n, _p(cell_of),
                _p(ids_d), _p(r), _p(m), _p(h), *_grid_args(spec),
                *_family_args(kern), float(h_fac), float(h_converge),
                float(hmax), _p(rho), _p(invom), _p(zeta), _p(done),
                count=_grid_count("active_density", spec, kern))
    return rho, invom, zeta, done


def active_forces(spec, kern, visc, idx, cell_of, ids_d, r, v, packed,
                  level, levelneib, hydro_forces):
    """K9: pair forces of the particles idx (n,) int32 over the 3^ndim
    cells of ids_d, r and v (N, ndim): a (n, ndim), dudt and div_v (n,)
    after the epilogue (zero without hydro forces), and a copy of
    levelneib (N,) int32 raised by the neighbour-level scatter in both
    directions.  `packed` (N, 9) holds ops.sph_grid27.FORCE_SCALARS per
    particle."""
    nd = spec.ndim
    N, dt, dev = r.shape[0], r.dtype, r.device
    n = _active_args(spec, idx, cell_of, ids_d, N)
    _check(r, "r", dt, (N, nd))
    _check(v, "v", dt, (N, nd))
    _check(packed, "packed", dt, (N, 9))
    _check(level, "level", torch.int32, (N,))
    _check(levelneib, "levelneib", torch.int32, (N,))
    a = torch.empty((n, nd), dtype=dt, device=dev)
    dudt = torch.empty((n,), dtype=dt, device=dev)
    div_v = torch.empty((n,), dtype=dt, device=dev)
    lneib = levelneib.clone()
    if n:
        _launch("active_forces", dt, dev, _p(idx), n, _p(cell_of),
                _p(ids_d), _p(r), _p(v), _p(packed), _p(level),
                *_grid_args(spec), *_family_args(kern),
                float(kern.kernrange), int(hydro_forces), int(visc.avisc),
                int(visc.acond), float(visc.alpha_visc),
                float(visc.beta_visc), _p(a), _p(dudt), _p(div_v),
                _p(lneib), count=_grid_count("active_forces", spec, kern))
    return a, dudt, div_v, lneib


# ---------------------------------------------------------------------------
# Meshless finite volume, K10-K12 and K31 (layouts of ops/mfv_grid27.py)
# ---------------------------------------------------------------------------

def _slot_map_args(spec, ids_d, r):
    N = r.shape[0]
    _check(ids_d, "ids_d", torch.int32, tuple(spec.ncells) + (spec.k_cell,))
    _check(r, "r", r.dtype, (N, spec.ndim))
    if spec.mirror:
        raise NotImplementedError(
            "the MFV kernels take no mirror layers (ROADMAP queue 1, items "
            "8 and 10)")
    return N


class FluxModes(NamedTuple):
    """K12's modes as plain numbers: the adiabatic index, the Riemann
    solver (1 exact, 0 HLLC), the limiter class (csrc/mfv.cuh: 0 the
    Gizmo clamp, 1 the cell alphas, 2 none), RK2, static particles, zero
    mass flux and block timesteps (each 0 or 1; block under MUSCL
    only)."""
    gamma: float
    exact: int
    limiter: int
    rk2: int
    static: int
    zmf: int
    block: int = 0


def mfv_flux_count(spec, modes: FluxModes, kern=None) -> str:
    """The LAUNCHES key of K12 in `modes` on `spec`'s dims with the
    smoothing kernel `kern` (its variant after the modes)."""
    name = ("mfv_fluxes" + ("", "_exact")[modes.exact]
            + ("", "_rk2")[modes.rk2] + ("", "_block")[modes.block]
            + ("", "_cell", "_zeroslope")[modes.limiter]
            + ("", "_static")[modes.static])
    return _grid_count(name, spec, kern)


def mfv_density(spec, kern, h_fac, h_converge, hmax, ids_d, r, m, h,
                mapping="auto"):
    """K10 over K1's slot map ids_d (*ncells, K) int32: (ndens, invom,
    zeta) sums at each particle's final h and its converged flag, each
    (N,) in particle order.  A particle without a slot keeps zeros and
    counts as not converged."""
    N = _slot_map_args(spec, ids_d, r)
    dt, dev = r.dtype, r.device
    _check(m, "m", dt, (N,))
    _check(h, "h", dt, (N,))
    ndens, invom, zeta = (torch.zeros((N,), dtype=dt, device=dev)
                          for _ in range(3))
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    _launch("mfv_density", dt, dev, _p(ids_d), _p(r), _p(m), _p(h),
            *_grid_args_nd(spec), *_family_args(kern), float(h_fac),
            float(h_fac ** spec.ndim), float(h_converge), float(hmax),
            SLOT_MAPPINGS[mapping], _p(ndens), _p(invom), _p(zeta), _p(done),
            count=_grid_count("mfv_density", spec, kern))
    return ndens, invom, zeta, done


def mfv_gradients(spec, kern, ids_d, r, packed, extrema=False,
                  mapping="auto"):
    """K11 over the slot map: B (N, ndim, ndim), grad (N, nvar, ndim),
    alpha_slope (N, nvar), vsig_max (N,) and bad (N,) bool, nvar = ndim
    + 2; with `extrema` also K31's inputs dWmax and dWmin (N, nvar).
    `packed` (N, ndim + 5) holds h, ndens, W and sound (the columns of
    ops.mfv_grid27.gradients)."""
    N = _slot_map_args(spec, ids_d, r)
    nd = spec.ndim
    nvar = nd + 2
    dt, dev = r.dtype, r.device
    _check(packed, "packed", dt, (N, nd + 5))
    kw = dict(dtype=dt, device=dev)
    B = torch.zeros((N, nd, nd), **kw)
    grad = torch.zeros((N, nvar, nd), **kw)
    alpha = torch.ones((N, nvar), **kw)
    vsig = torch.zeros((N,), **kw)
    bad = torch.zeros((N,), dtype=torch.bool, device=dev)
    ext = ([torch.zeros((N, nvar), **kw) for _ in range(2)] if extrema
           else [None, None])
    _launch("mfv_gradients", dt, dev, _p(ids_d), _p(r), _p(packed),
            *_grid_args_nd(spec), *_family_args(kern),
            SLOT_MAPPINGS[mapping], _p(B), _p(grad), _p(alpha), _p(vsig),
            _p(bad), *[None if x is None else _p(x) for x in ext],
            count=_grid_count("mfv_gradients", spec, kern))
    out = (B, grad, alpha, vsig, bad)
    return out + tuple(ext) if extrema else out


def mfv_limiter(spec, kern, limiter, ids_d, r, packed, grad, dWmax, dWmin,
                mapping="auto"):
    """K31 over the slot map: the cell alphas (N, nvar) of `limiter`
    (tvdscalar or springel2009), the running min from 1 over the pairs
    within kernrange h_i, from K11's gradients `grad` (N, nvar, ndim) and
    signed extrema dWmax, dWmin (N, nvar).  `packed` as K11's."""
    if limiter not in MFV_SWEEP:
        raise ValueError(f"K31 takes tvdscalar or springel2009, not "
                         f"{limiter!r}")
    N = _slot_map_args(spec, ids_d, r)
    nd = spec.ndim
    nvar = nd + 2
    dt, dev = r.dtype, r.device
    _check(packed, "packed", dt, (N, nd + 5))
    _check(grad, "grad", dt, (N, nvar, nd))
    _check(dWmax, "dWmax", dt, (N, nvar))
    _check(dWmin, "dWmin", dt, (N, nvar))
    alpha = torch.ones((N, nvar), dtype=dt, device=dev)
    _launch("mfv_limiter", dt, dev, _p(ids_d), _p(r), _p(packed), _p(grad),
            _p(dWmax), _p(dWmin), *_grid_args_nd(spec),
            float(kern.kernrange), MFV_SWEEP[limiter],
            SLOT_MAPPINGS[mapping], _p(alpha),
            count=_grid_count(f"mfv_limiter_{limiter}", spec, kern))
    return alpha


def mfv_fluxes(spec, kern, modes: FluxModes, dt_t, ids_d, r, packed,
               mapping="auto"):
    """K12 over the slot map: dQdt (N, nvar) and rdmdt_dot (N, ndim) in
    `modes` (MUSCL or RK2 over dt_t, a 0-d tensor read on the device);
    in block mode also the committed dQ (N, nvar) and rdmdt (N, ndim).
    `packed` (N, 15 / 26 / 41, two more in block mode) holds
    ops.mfv_grid27.flux_cols."""
    if modes.block and modes.rk2:
        raise ValueError("K12's block mode runs under MUSCL only")
    N = _slot_map_args(spec, ids_d, r)
    nd = spec.ndim
    nvar = nd + 2
    dt, dev = r.dtype, r.device
    ncols = 2 * nvar + nd * nd + nvar * nd + nd + 4 + 2 * modes.block
    _check(packed, "packed", dt, (N, ncols))
    _check(dt_t, "dt", dt, ())
    out = [torch.zeros((N, w), dtype=dt, device=dev)
           for w in (nvar, nd) * (2 if modes.block else 1)]
    solver = ("hllc", "exact")[modes.exact]
    ptrs = [_p(x) for x in out] + [None] * (4 - len(out))
    norm, _, res = _family_args(kern)
    _launch(f"mfv_fluxes_{solver}_{nd}d_{kern.name}", dt, dev, _p(ids_d),
            _p(r), _p(packed), _p(dt_t), *_grid_args_nd(spec)[1:], norm,
            res, float(modes.gamma), int(modes.zmf), int(modes.limiter),
            int(modes.rk2), int(modes.static), int(modes.block),
            SLOT_MAPPINGS[mapping], *ptrs,
            count=mfv_flux_count(spec, modes, kern))
    return tuple(out)


def mfv_vsig_near(spec, ids_d, r, v, sound, h):
    """K32 over the slot map: each particle's largest (c_i + c_j -
    dv.dr/|dr|) h_i / max(|dr|, h_i) over every particle of its stencil
    at d^2 > 0 (N,), 0 where there is none."""
    N = _slot_map_args(spec, ids_d, r)
    dt, dev = r.dtype, r.device
    _check(v, "v", dt, (N, spec.ndim))
    _check(sound, "sound", dt, (N,))
    _check(h, "h", dt, (N,))
    out = torch.zeros((N,), dtype=dt, device=dev)
    _launch("mfv_vsig_near", dt, dev, _p(ids_d), _p(r), _p(v), _p(sound),
            _p(h), *_grid_args_nd(spec), _p(out),
            count=_grid_count("mfv_vsig_near", spec))
    return out


def mfv_vsig_far(spec, ids_d, v, sound, lo, csize, reach):
    """K33 over the slot map: the per-cell far-field bound (A, Bc), each
    (C,) in z-major cell order, from the cells' sound and velocity
    aggregates; `lo`, `csize` and `reach` (ndim floats each) are the
    grid's lower corner, cell size and the stencil's reach per dim.  Its
    three stages (aggregates, the cell pairs in source slices, the max
    over the slices) count one launch."""
    N = v.shape[0]
    dt, dev = v.dtype, v.device
    nd = spec.ndim
    _check(ids_d, "ids_d", torch.int32, tuple(spec.ncells) + (spec.k_cell,))
    _check(v, "v", dt, (N, nd))
    _check(sound, "sound", dt, (N,))
    if spec.mirror:
        raise NotImplementedError(
            "the MFV kernels take no mirror layers (ROADMAP queue 1, items "
            "8 and 10)")
    C = spec.total_cells
    # slices of the source cells so that the blocks of 128 target cells
    # fill the card, 16 a multiprocessor, each slice at least 128 sources
    blocks = -(-C // 128)
    fill = 16 * torch.cuda.get_device_properties(dev).multi_processor_count
    slices = max(1, min(-(-fill // blocks), -(-C // 128)))
    agg = torch.empty((C, 3 * nd + 2), dtype=dt, device=dev)
    part = torch.empty((2, slices, C), dtype=dt, device=dev)
    A = torch.empty((C,), dtype=dt, device=dev)
    Bc = torch.empty((C,), dtype=dt, device=dev)
    pad = [0.0] * (3 - nd)
    _launch("mfv_vsig_far", dt, dev, _p(ids_d), _p(v), _p(sound),
            *_grid_args_nd(spec), *[float(x) for x in lo], *pad,
            *[float(x) for x in csize], *pad, *[float(x) for x in reach],
            *pad, slices, _p(agg), _p(part), _p(A), _p(Bc),
            count=_grid_count("mfv_vsig_far", spec))
    return A, Bc


# ---------------------------------------------------------------------------
# Direct-summation N-body gravity, K13-K15 (ops/gravity.py)
# ---------------------------------------------------------------------------

def _stars(r, m, *vectors, ndims=(2, 3)):
    """(N, ndim) of a star set, checked: r and the (N, ndim) `vectors` in
    r's dtype, m (N,); ndim one of `ndims` (K13 and K15 take 2 or 3, K14
    also 1)."""
    N, ndim = r.shape if r.dim() == 2 else (None, None)
    if ndim not in ndims:
        raise ValueError(f"r: expected shape (N, ndim) with ndim in "
                         f"{ndims}, got {tuple(r.shape)}")
    _check(r, "r", r.dtype, (N, ndim))
    _check(m, "m", r.dtype, (N,))
    for name, x in vectors:
        _check(x, name, r.dtype, (N, ndim))
    return N, ndim


def direct_nbody(r, v, m, compute_jerk: bool = True):
    """K13: unsoftened (a, adot, gpot) of every star; adot is zero
    without `compute_jerk`."""
    N, ndim = _stars(r, m, ("v", v))
    a = torch.empty_like(r)
    adot = torch.empty_like(r) if compute_jerk else torch.zeros_like(r)
    gpot = torch.empty_like(m)
    _launch("direct_nbody", r.dtype, r.device, _p(r), _p(v), _p(m), N, ndim,
            int(compute_jerk), _p(a), _p(adot) if compute_jerk else None,
            _p(gpot))
    return a, adot, gpot


def direct_softened(r, v, m, h, compute_jerk: bool = False, *, kern=None):
    """K14: mean-h kernel-softened (a, adot, gpot) of stars in 1-3 dims;
    adot is the Newtonian jerk, zero without `compute_jerk`.  `kern` (the
    caller's smoothing kernel; None: the direct M4) is M4 or the quintic,
    direct or tabulated; the gaussian is refused before any input is read
    (fault F23)."""
    fam = _softened_args(kern, "softened star-star gravity (K14)")
    N, ndim = _stars(r, m, ("v", v), ndims=(1, 2, 3))
    _check(h, "h", r.dtype, (N,))
    a = torch.empty_like(r)
    adot = torch.empty_like(r) if compute_jerk else torch.zeros_like(r)
    gpot = torch.empty_like(m)
    _launch("direct_softened", r.dtype, r.device, _p(r), _p(v), _p(m), _p(h),
            N, ndim, int(compute_jerk), *fam, _p(a),
            _p(adot) if compute_jerk else None, _p(gpot),
            count=tree_count(family_count("direct_softened", kern), ndim))
    return a, adot, gpot


def direct_snap(r, v, a, m):
    """K15: the snap (N, ndim) of every star from r, v and a."""
    N, ndim = _stars(r, m, ("v", v), ("a", a))
    snap = torch.empty_like(r)
    _launch("direct_snap", r.dtype, r.device, _p(r), _p(v), _p(a), _p(m), N,
            ndim, _p(snap))
    return snap


# ---------------------------------------------------------------------------
# Sinks and star-gas gravity, K16-K18 (ops/sph_gravity.py, ops/sinks.py)
# ---------------------------------------------------------------------------

_CHUNK = 256    # gas particles per partial slot sum (K16, K18, K20)
_SMOOTH_TERMS = 6   # K20's terms a gas particle (csrc/sinks.cu:kTerms)


def _gas_ndim(r, name: str) -> int:
    """The ndim of gas positions r (N, ndim), 1-3, else a ValueError."""
    nd = r.shape[1] if r.dim() == 2 else 0
    if nd not in (1, 2, 3):
        raise ValueError(f"{name}: expected (N, ndim) with ndim 1-3, got "
                         f"{tuple(r.shape)}")
    return nd


def _gas_and_slots(r, rs, act):
    """(N, Ns, ndim) of gas r (N, ndim) and slot rs (Ns, ndim) with act
    (Ns,) bool, checked (ndim 1-3, r's dtype and device)."""
    nd = _gas_ndim(r, "r_gas")
    N, Ns = r.shape[0], rs.shape[0]
    _check(r, "r_gas", r.dtype, (N, nd))
    _check(rs, "r_star", r.dtype, (Ns, nd))
    _check(act, "star_active", torch.bool, (Ns,))
    if rs.device != r.device:
        raise ValueError("r_star: expected r_gas's device")
    return N, Ns, nd


def _partials(N, Ns, cols, dt, dev):
    """The per-(gas chunk, slot) partial sums of `cols` values each."""
    chunks = -(-N // _CHUNK)
    if chunks > 65535:
        raise ValueError(f"{N} gas particles: the star-side grid takes at "
                         f"most {65535 * _CHUNK}")
    return torch.empty((chunks, Ns, cols), dtype=dt, device=dev)


def star_gas_forces(r_gas, m_gas, h_gas, r_star, m_star, h_star, act, *,
                    kern=None):
    """K16: (a_gas (N, ndim), gpot_gas (N,), a_star (Ns, ndim), gpot_star
    (Ns,)) of the mean-h kernel-softened star-gas pairs in 1-3 dims;
    `kern` (None: the direct M4) as K14 takes it, the gaussian refused
    before any input is read (fault F23)."""
    fam = _softened_args(kern, "star-gas gravity (K16)")
    N, Ns, nd = _gas_and_slots(r_gas, r_star, act)
    dt, dev = r_gas.dtype, r_gas.device
    for name, x, n in (("m_gas", m_gas, N), ("h_gas", h_gas, N),
                       ("m_star", m_star, Ns), ("h_star", h_star, Ns)):
        _check(x, name, dt, (n,))
    part = _partials(N, Ns, nd + 1, dt, dev)
    a_gas, a_star = (torch.empty((n, nd), dtype=dt, device=dev)
                     for n in (N, Ns))
    gpot_gas, gpot_star = (torch.empty((n,), dtype=dt, device=dev)
                           for n in (N, Ns))
    _launch(tree_count("star_gas_forces", nd), dt, dev, _p(r_gas),
            _p(m_gas), _p(h_gas), N, _p(r_star), _p(m_star), _p(h_star),
            _p(act), Ns, *fam, _p(part), _p(a_gas), _p(gpot_gas),
            _p(a_star), _p(gpot_star),
            count=tree_count(family_count("star_gas_forces", kern), nd))
    return a_gas, gpot_gas, a_star, gpot_star


def sink_candidate(rho, alive, rho_sink, r, v, m, h):
    """K17: the packed row [r, v, m, h, score] (2 ndim + 3,) of the
    densest alive particle with rho > rho_sink (score -inf and index 0
    when none) and its index, a 0-d int64 tensor; r and v (N, ndim) with
    ndim 1-3."""
    N, dt, dev = r.shape[0], r.dtype, r.device
    if N == 0:
        raise ValueError("sink_candidate: no gas particles")
    nd = _gas_ndim(r, "r")
    _check(r, "r", dt, (N, nd))
    _check(v, "v", dt, (N, nd))
    _check(alive, "alive", torch.bool, (N,))
    for name, x in (("rho", rho), ("m", m), ("h", h)):
        _check(x, name, dt, (N,))
    nb = lib().sink_candidate_blocks(N)
    part_s = torch.empty((nb,), dtype=dt, device=dev)
    part_i = torch.empty((nb,), dtype=torch.int32, device=dev)
    cand = torch.empty((2 * nd + 3,), dtype=dt, device=dev)
    gi = torch.empty((), dtype=torch.int64, device=dev)
    _launch(tree_count("sink_candidate", nd), dt, dev, _p(rho), _p(alive),
            N, float(rho_sink), _p(r), _p(v), _p(m), _p(h), _p(part_s),
            _p(part_i), _p(cand), _p(gi))
    return cand, gi


def accretion_sums(r, v, m, alive, r_star, h_star, act, sink_radius):
    """K18: per slot dm (Ns,), dmom and dmr (Ns, ndim) of the gas each
    active slot eats (the nearest one within sink_radius h_star), and the
    eaten mask (N,) bool; ndim 1-3.  It reads no smoothing kernel."""
    N, Ns, nd = _gas_and_slots(r, r_star, act)
    dt, dev = r.dtype, r.device
    _check(v, "v", dt, (N, nd))
    _check(m, "m", dt, (N,))
    _check(alive, "alive", torch.bool, (N,))
    _check(h_star, "h_star", dt, (Ns,))
    slot_of = torch.empty((N,), dtype=torch.int32, device=dev)
    part = _partials(N, Ns, 1 + 2 * nd, dt, dev)
    dm = torch.empty((Ns,), dtype=dt, device=dev)
    dmom, dmr = (torch.empty((Ns, nd), dtype=dt, device=dev)
                 for _ in range(2))
    eaten = torch.empty((N,), dtype=torch.bool, device=dev)
    _launch(tree_count("accretion_sums", nd), dt, dev, _p(r), _p(v), _p(m),
            _p(alive), N, _p(r_star), _p(h_star), _p(act), Ns,
            float(sink_radius), _p(slot_of), _p(part), _p(dm), _p(dmom),
            _p(dmr), _p(eaten))
    return dm, dmom, dmr, eaten


# ---------------------------------------------------------------------------
# Smooth accretion, K20 (ops/sinks.py)
# ---------------------------------------------------------------------------

def smooth_accretion_sums(r, v, m, rho, sound, alive, r_star, v_star,
                          m_star, h_star, act, sink_radius, dt, mmean,
                          alpha_ss, frac, sdt, *, kern):
    """K20, first launch: dm (N,), the claimed slot of each gas particle
    (N,) int32 (-1 for none), and menc, macc and taccrete (Ns,); r, v
    (N, ndim) and the slots' r, v (Ns, ndim) with ndim 1-3.  `dt` is a
    0-d tensor on the device, read there.  `kern`, the run's smoothing
    kernel in that ndim (its norm, W and wpot), is M4 or the quintic,
    direct or tabulated; the gaussian is refused before any input is read
    (fault F23)."""
    fam = _softened_args(kern, "smooth accretion's potential term (K20)")
    N, Ns, nd = _gas_and_slots(r, r_star, act)
    dt_, dev = r.dtype, r.device
    _check(v, "v", dt_, (N, nd))
    _check(v_star, "v_star", dt_, (Ns, nd))
    _check(alive, "alive", torch.bool, (N,))
    for name, x, n in (("m", m, N), ("rho", rho, N), ("sound", sound, N),
                       ("m_star", m_star, Ns), ("h_star", h_star, Ns)):
        _check(x, name, dt_, (n,))
    _check(dt, "dt", dt_, ())
    slot_of = torch.empty((N,), dtype=torch.int32, device=dev)
    vals = torch.empty((N, _SMOOTH_TERMS), dtype=dt_, device=dev)
    part = _partials(N, Ns, _SMOOTH_TERMS, dt_, dev)
    sums = torch.empty((Ns, _SMOOTH_TERMS), dtype=dt_, device=dev)
    slot_scr = torch.empty((Ns, 2), dtype=dt_, device=dev)
    dm = torch.empty((N,), dtype=dt_, device=dev)
    menc, macc, tacc = (torch.empty((Ns,), dtype=dt_, device=dev)
                        for _ in range(3))
    _launch(tree_count("smooth_accretion_sums", nd), dt_, dev, _p(r), _p(v),
            _p(m), _p(rho), _p(sound), _p(alive), N, _p(r_star),
            _p(v_star), _p(m_star), _p(h_star), _p(act), Ns,
            float(sink_radius), _p(dt), *fam, float(mmean),
            float(alpha_ss), float(frac), float(sdt), _p(slot_of), _p(vals),
            _p(part), _p(sums), _p(slot_scr), _p(dm), _p(menc), _p(macc),
            _p(tacc),
            count=tree_count(family_count("smooth_accretion", kern), nd))
    return dm, slot_of, menc, macc, tacc


def smooth_accretion_apply(r, v, m, dm, slot_of, alive, r_star, v_star,
                           r0_star, v0_star, m_star, angmom, act):
    """K20, second launch: the slots' new r, v, r0, v0 (Ns, ndim), m
    (Ns,) and angmom (Ns, 3, at every ndim), the gas's m - dm (N,) and
    its alive mask (N,) with the emptied particles dead; ndim 1-3.  It
    reads no smoothing kernel."""
    N, Ns, nd = _gas_and_slots(r, r_star, act)
    dt_, dev = r.dtype, r.device
    _check(v, "v", dt_, (N, nd))
    for name, x in (("m", m), ("dm", dm)):
        _check(x, name, dt_, (N,))
    _check(slot_of, "claim", torch.int32, (N,))
    _check(alive, "alive", torch.bool, (N,))
    for name, x in (("v_star", v_star), ("r0_star", r0_star),
                    ("v0_star", v0_star)):
        _check(x, name, dt_, (Ns, nd))
    _check(angmom, "angmom", dt_, (Ns, 3))
    _check(m_star, "m_star", dt_, (Ns,))
    # the move table dm, dm r, dm v; its per-particle rows and partials
    # also hold the spin's 3 columns
    cols = 1 + 2 * nd
    vals = torch.empty((N, cols), dtype=dt_, device=dev)
    part = _partials(N, Ns, cols, dt_, dev)
    move = torch.empty((Ns, cols), dtype=dt_, device=dev)
    spin = torch.empty((Ns, 3), dtype=dt_, device=dev)
    com = torch.empty((Ns, cols), dtype=dt_, device=dev)
    outs = [torch.empty((Ns, nd), dtype=dt_, device=dev) for _ in range(4)]
    m_out = torch.empty((Ns,), dtype=dt_, device=dev)
    angmom_out = torch.empty((Ns, 3), dtype=dt_, device=dev)
    m_gas = torch.empty((N,), dtype=dt_, device=dev)
    alive_new = torch.empty((N,), dtype=torch.bool, device=dev)
    _launch(tree_count("smooth_accretion_apply", nd), dt_, dev, _p(r),
            _p(v), _p(m), _p(dm), _p(slot_of), _p(alive), N, _p(r_star),
            _p(v_star), _p(r0_star), _p(v0_star), _p(m_star), _p(angmom),
            _p(act), Ns, _p(vals), _p(part), _p(move), _p(spin), _p(com),
            *map(_p, outs), _p(m_out), _p(angmom_out), _p(m_gas),
            _p(alive_new), count=tree_count("smooth_accretion", nd))
    return (*outs, m_out, angmom_out, m_gas, alive_new)


# ---------------------------------------------------------------------------
# The Cullen & Dehnen switch, K21 (ops/forces.py), and the neighbour-level
# pass, K22 (ops/active_grid.py)
# ---------------------------------------------------------------------------

def cullen_dehnen(spec, kern, visc, ids_d, r, packed):
    """K21 over K1's slot map ids_d (*ncells, K) int32 at the grid's
    ndim: alpha_new, dalphadt (N,) and bad (N,) bool of every particle
    with a slot (the others are left zero).  `packed` (N, 2 ndim + 5)
    holds ops.forces.CD_COLS.  `kern` is any smoothing kernel of
    csrc/kernel_family.cuh."""
    N, nd = r.shape
    dt, dev = r.dtype, r.device
    if nd != spec.ndim:
        raise ValueError(f"r: expected {spec.ndim} dims, got {nd}")
    _check(ids_d, "ids_d", torch.int32, tuple(spec.ncells) + (spec.k_cell,))
    _check(r, "r", dt, (N, nd))
    _check(packed, "packed", dt, (N, 2 * nd + 5))
    alpha = torch.zeros((N,), dtype=dt, device=dev)
    dal = torch.zeros((N,), dtype=dt, device=dev)
    bad = torch.zeros((N,), dtype=torch.bool, device=dev)
    _launch("cullen_dehnen", dt, dev, _p(ids_d), _p(r), _p(packed),
            *_grid_args_nd(spec), *_family_args(kern),
            float(visc.alpha_visc), float(visc.alpha_visc_min), _p(alpha),
            _p(dal), _p(bad),
            count=_grid_count("cullen_dehnen", spec, kern))
    return alpha, dal, bad


def levelneib(spec, kern, ids_d, r, h, level):
    """K22 over K1's slot map ids_d (*ncells, K) int32 of a grid in 1-3
    dims without mirror layers: each particle's largest level among the
    particles of the map within kernrange max(h_i, h_j), itself included
    (N,) int32; 0 for a particle without a slot."""
    N, dt, dev = r.shape[0], r.dtype, r.device
    _check(ids_d, "ids_d", torch.int32, tuple(spec.ncells) + (spec.k_cell,))
    _check(r, "r", dt, (N, spec.ndim))
    _check(h, "h", dt, (N,))
    _check(level, "level", torch.int32, (N,))
    if spec.mirror:
        raise NotImplementedError(
            "the neighbour-level kernel takes no mirror layers (ROADMAP "
            "queue 1, item 8)")
    out = torch.zeros((N,), dtype=torch.int32, device=dev)
    _launch("levelneib", dt, dev, _p(ids_d), _p(r), _p(h), _p(level),
            _p(out), *_grid_args_nd(spec), float(kern.kernrange),
            count=_grid_count("levelneib", spec))
    return out


# ---------------------------------------------------------------------------
# The gas-dust drag, K23 and K24 (ops/dust.py)
# ---------------------------------------------------------------------------

def _dust_checks(spec, ids_d, n_targets, r, sc, ptype):
    M, nd = r.shape
    if nd != spec.ndim:
        raise ValueError(f"r: expected {spec.ndim} dims, got {nd}")
    if not 0 <= n_targets <= M:
        raise ValueError(f"n_targets {n_targets} outside [0, {M}]")
    _check(ids_d, "ids_d", torch.int32, tuple(spec.ncells) + (spec.k_cell,))
    _check(r, "r", r.dtype, (M, nd))
    _check(sc, "sc", r.dtype, (M, 4))
    _check(ptype, "ptype", torch.int32, (M,))
    return M, nd


def dust_drag_sums(spec, kern, law, test_particle, ids_d, n_targets, r, vec,
                   sc, ptype, dt):
    """K23 over K1's slot map ids_d (*ncells, K) int32 of the M particles
    and images r (M, ndim) (vec (M, 3 ndim): v, a, a0; sc (M, 4):
    ops.dust.DRAG_SCALARS; ptype (M,) int32): a_drag (n, ndim), norm,
    sound and div_v (n,) of the targets, ids below n = n_targets, each
    target's step dt (n,); zero for a target without a slot.  `kern` is
    any smoothing kernel of csrc/kernel_family.cuh (its family's
    source)."""
    M, nd = _dust_checks(spec, ids_d, n_targets, r, sc, ptype)
    dt_, dev = r.dtype, r.device
    _check(vec, "vec", dt_, (M, 3 * nd))
    _check(dt, "dt", dt_, (n_targets,))
    # the fixed law's t_s = 1/coeff is the double 1/coeff rounded to the
    # float type, as DragLaw.t_stop has it
    coeff = float(law.coeff)
    inv_coeff = 1.0 / coeff if coeff != 0.0 else math.inf
    a = torch.zeros((n_targets, nd), dtype=dt_, device=dev)
    norm, sound, div_v = (torch.zeros((n_targets,), dtype=dt_, device=dev)
                          for _ in range(3))
    knorm, _, res = _family_args(kern)
    _launch(f"dust_drag_sums_{kern.name}", dt_, dev, _p(ids_d), n_targets,
            _p(r), _p(vec), _p(sc), _p(ptype), _p(dt), *_grid_args_nd(spec),
            knorm, float(kern.kernnormdrag), res, law.code, coeff,
            inv_coeff, int(bool(test_particle)), _p(a), _p(norm), _p(sound),
            _p(div_v), count=family_count("dust_drag_sums", kern))
    return a, norm, sound, div_v


def dust_drag_deposit(spec, kern, ids_d, n_targets, r, sc, ptype, payload,
                      dek):
    """K24 over the slot map of K23: the drag heating du/dt (n,) of the
    gas targets, -dEk_i - sum_j wraw(|r_ij|, h_i) P_j / rho_i over their
    dust candidates (payload P (M,), dek (n,)); zero for dust and for a
    target without a slot."""
    M, nd = _dust_checks(spec, ids_d, n_targets, r, sc, ptype)
    dt_, dev = r.dtype, r.device
    _check(payload, "payload", dt_, (M,))
    _check(dek, "dek", dt_, (n_targets,))
    out = torch.zeros((n_targets,), dtype=dt_, device=dev)
    knorm, _, res = _family_args(kern)
    _launch(f"dust_drag_deposit_{kern.name}", dt_, dev, _p(ids_d),
            n_targets, _p(r), _p(sc), _p(ptype), _p(payload), _p(dek),
            *_grid_args_nd(spec), knorm, float(kern.kernnormdrag), res,
            _p(out), count=family_count("dust_drag_deposit", kern))
    return out


# ---------------------------------------------------------------------------
# Saitoh & Makino (2012) SPH, K25 and K26 (ops/sm2012.py)
# ---------------------------------------------------------------------------

def _slot_map_nd(spec, ids_d, r):
    """(N, ndim) after checking K1's slot map and r on spec's dims."""
    N, nd = r.shape
    if nd != spec.ndim:
        raise ValueError(f"r: expected {spec.ndim} dims, got {nd}")
    _check(ids_d, "ids_d", torch.int32, tuple(spec.ncells) + (spec.k_cell,))
    _check(r, "r", r.dtype, (N, nd))
    return N, nd


def sm2012_density(spec, kern, h_fac, h_converge, hmax, ids_d, r, m, u, h):
    """K25 over K1's slot map ids_d (*ncells, K) int32 (-1 empty): h, rho,
    q, hfactor (N,) and the converged flag (N,) bool of every particle
    with a slot; a particle without one keeps its h and takes rho = q =
    hfactor = 0, converged.  `kern` is any smoothing kernel of
    csrc/kernel_family.cuh."""
    N, _ = _slot_map_nd(spec, ids_d, r)
    dt, dev = r.dtype, r.device
    for name, x in (("m", m), ("u", u), ("h", h)):
        _check(x, name, dt, (N,))
    h_out = h.clone()
    rho, q, hfac = (torch.zeros((N,), dtype=dt, device=dev)
                    for _ in range(3))
    done = torch.ones((N,), dtype=torch.bool, device=dev)
    _launch("sm2012_density", dt, dev, _p(ids_d), _p(r), _p(m), _p(u),
            _p(h), *_grid_args_nd(spec), *_family_args(kern), float(h_fac),
            float(h_converge), float(hmax), _p(h_out), _p(rho), _p(q),
            _p(hfac), _p(done),
            count=_grid_count("sm2012_density", spec, kern))
    return h_out, rho, q, hfac, done


def sm2012_forces(spec, kern, visc, gamma, ids_d, r, v, packed):
    """K26 over K1's slot map ids_d: a (N, ndim), du/dt and div v (N,) of
    every particle with a slot (zero for the others).  `packed` (N, 8)
    holds ops.sm2012.SM_SCALARS per particle."""
    N, nd = _slot_map_nd(spec, ids_d, r)
    dt, dev = r.dtype, r.device
    _check(v, "v", dt, (N, nd))
    _check(packed, "packed", dt, (N, 8))
    a = torch.zeros((N, nd), dtype=dt, device=dev)
    dudt = torch.zeros((N,), dtype=dt, device=dev)
    div_v = torch.zeros((N,), dtype=dt, device=dev)
    _launch("sm2012_forces", dt, dev, _p(ids_d), _p(r), _p(v), _p(packed),
            *_grid_args_nd(spec), *_family_args(kern), float(gamma),
            int(visc.avisc), float(visc.alpha_visc), float(visc.beta_visc),
            _p(a), _p(dudt), _p(div_v),
            count=_grid_count("sm2012_forces", spec, kern))
    return a, dudt, div_v


def _table_args(table, x):
    """K27-K29's table arguments, its arrays checked against x's device
    and dtype."""
    dt = x.dtype
    nd, nt = table.log_dens.shape[0], table.log_temp.shape[0]
    _check(table.log_dens, "log_dens", dt, (nd,))
    _check(table.log_temp, "log_temp", dt, (nt,))
    for name in ("energy", "mu", "kappa", "kappap", "gamma"):
        _check(getattr(table, name), name, dt, (nd, nt))
    return (*(_p(getattr(table, k)) for k in ("log_dens", "log_temp",
                                              "energy", "mu", "kappa",
                                              "kappap", "gamma")),
            nd, nt, float(table.fcol2), 4.0 * table.rad_const,
            float(table.temp_min))


def _elements(x, name, dtype, n):
    """x as an (n,) argument, or a scalar one (0-d or 1 element):
    (pointer, per-element flag)."""
    if x.numel() == 1 and tuple(x.shape) != (n,):
        _check(x.reshape(1), name, dtype, (1,))
        return _p(x), 0
    _check(x, name, dtype, (n,))
    return _p(x), 1


def _index_out(n, index, dev):
    return torch.empty((n,), dtype=torch.int32, device=dev) if index \
        else None


def radws_eos(table, rho, u, index=False):
    """K27 on flat rho, u (n,): (P, c) (n,) and, with `index`, the int32
    index idens nt + itemp of each gamma read."""
    n, dt, dev = rho.shape[0], rho.dtype, rho.device
    _check(rho, "rho", dt, (n,))
    _check(u, "u", dt, (n,))
    targs = _table_args(table, rho)
    P, c = (torch.empty((n,), dtype=dt, device=dev) for _ in range(2))
    idx = _index_out(n, index, dev)
    _launch("radws_eos", dt, dev, *targs, _p(rho), _p(u), n, _p(P), _p(c),
            None if idx is None else _p(idx))
    return (P, c) + ((idx,) if index else ())


def radws_equilibrium(table, rho, u, dudt, gpot, temp_amb, index=False):
    """K28 on (N,) rho, u, du/dt, gpot and a scalar or (N,) temp_amb:
    (ueq, dt_therm) (N,) and, with `index`, the int32 index ((idens nt
    + it_eq) nt + it_now) 3 + branch."""
    n, dt, dev = rho.shape[0], rho.dtype, rho.device
    for name, x in (("rho", rho), ("u", u), ("dudt", dudt), ("gpot", gpot)):
        _check(x, name, dt, (n,))
    tp, t_per = _elements(temp_amb, "temp_amb", dt, n)
    targs = _table_args(table, rho)
    ueq, dtt = (torch.empty((n,), dtype=dt, device=dev) for _ in range(2))
    idx = _index_out(n, index, dev)
    _launch("radws_equilibrium", dt, dev, *targs, _p(rho), _p(u), _p(dudt),
            _p(gpot), tp, t_per, n, _p(ueq), _p(dtt),
            None if idx is None else _p(idx))
    return (ueq, dtt) + ((idx,) if index else ())


def radws_implicit_heating(table, rho, u, dudt, gpot, dt_step, temp_amb,
                           index=False):
    """K29 on (N,) rho, u, du/dt, gpot, a scalar or (N,) step dt_step and
    temp_amb: the heating rate (N,) and, with `index`, the int32 index
    (idens nt + it) 3 + branch."""
    n, dt, dev = rho.shape[0], rho.dtype, rho.device
    for name, x in (("rho", rho), ("u", u), ("dudt", dudt), ("gpot", gpot)):
        _check(x, name, dt, (n,))
    sp, s_per = _elements(dt_step, "dt", dt, n)
    tp, t_per = _elements(temp_amb, "temp_amb", dt, n)
    targs = _table_args(table, rho)
    heat = torch.empty((n,), dtype=dt, device=dev)
    idx = _index_out(n, index, dev)
    _launch("radws_implicit_heating", dt, dev, *targs, _p(rho), _p(u),
            _p(dudt), _p(gpot), sp, s_per, tp, t_per, n, _p(heat),
            None if idx is None else _p(idx))
    return (heat, idx) if index else heat


def ambient_temperature(r, rs, q, tsink4, act, active, temp_inf, disc):
    """K30: (N,) T_amb of particles r (N, ndim) from the slots rs (Ns,
    ndim), ndim 1-3, with their factors q = 0.25 r_src^2 and T_sink^4
    (Ns,), the sink sum's mask act and the disc's active (Ns,) bool;
    `disc` a DiscHeatingConfig or None (its midplane the first min(2,
    ndim) coordinates)."""
    N, Ns, nd = _gas_and_slots(r, rs, act)
    dt, dev = r.dtype, r.device
    _check(q, "q", dt, (Ns,))
    _check(tsink4, "tsink4", dt, (Ns,))
    _check(active, "active", torch.bool, (Ns,))
    nc = 0 if disc is None else min(int(disc.n_central), Ns)
    tau4 = rs2 = expo = 0.0
    if disc is not None:
        tau4, rs2 = disc.temp_au ** 4, disc.rsmooth ** 2
        expo = -2.0 * disc.temp_q
    out = torch.empty((N,), dtype=dt, device=dev)
    _launch("ambient_temperature", dt, dev, _p(r), N, nd, _p(rs), _p(q),
            _p(tsink4), _p(act), Ns, float(temp_inf) ** 4, nc, _p(active),
            float(tau4), float(rs2), float(expo), _p(out),
            count=tree_count("ambient_temperature", nd))
    return out


# --- K34-K37: radiation -------------------------------------------------------

def _radiation_grid(spec):
    """nd, then the cells, lo, extents and periodic flags of a radiation
    field's grid padded to three dims (any object with ndim, lo,
    extents, ncells and periodic)."""
    nd = spec.ndim
    pad = 3 - nd
    return (nd, *[int(n) for n in spec.ncells[:nd]], *(1,) * pad,
            *[float(x) for x in spec.lo[:nd]], *(0.0,) * pad,
            *[float(x) for x in spec.extents[:nd]], *(1.0,) * pad,
            *[int(bool(p)) for p in spec.periodic[:nd]], *(0,) * pad)


def cell_field(spec, cell_of, slot_of, m, rho, mu_bar, vol):
    """K34: flat (C,) per-cell rho and n_H^2 from K1's binning (cell_of,
    slot_of (N,) int32; the discarded in cell C) and the particles' m,
    rho (N,): the slot map, then the per-cell sums over V_cell `vol`."""
    N, dt, dev = m.shape[0], m.dtype, m.device
    _check(rho, "rho", dt, (N,))
    _check(cell_of, "cell_of", torch.int32, (N,))
    _check(slot_of, "slot_of", torch.int32, (N,))
    C, K = spec.total_cells, spec.k_cell
    ids = torch.full((C * K,), -1, dtype=torch.int32, device=dev)
    rho_c, nh2_c = (torch.empty((C,), dtype=dt, device=dev)
                    for _ in range(2))
    _launch("cell_field", dt, dev, _p(cell_of), _p(slot_of), N, C, K,
            _p(ids), _p(m), _p(rho), float(mu_bar), float(vol), _p(rho_c),
            _p(nh2_c), count=tree_count("cell_field", spec.ndim))
    return rho_c, nh2_c


def ray_march(spec, field, r0, dirs, lengths, n_steps):
    """K35: (N, S) midpoint integrals of the flat per-cell `field` along
    rays from r0 (N, nd) with directions dirs (N, S, nd), or (S, nd)
    shared by every particle, and lengths (N, S)."""
    N, nd = r0.shape
    S = lengths.shape[1]
    dt, dev = r0.dtype, r0.device
    n_cells = math.prod(spec.ncells[:spec.ndim])
    _check(field, "field", dt, (n_cells,))
    _check(lengths, "lengths", dt, (N, S))
    shared = dirs.dim() == 2
    _check(dirs, "dirs", dt, (S, nd) if shared else (N, S, nd))
    out = torch.empty((N, S), dtype=dt, device=dev)
    _launch("ray_march", dt, dev, *_radiation_grid(spec), _p(field), _p(r0),
            _p(dirs), int(shared), _p(lengths), N, S, int(n_steps), _p(out),
            count=tree_count("ray_march", spec.ndim))
    return out


def packet_march(spec, opacity, r0, dirs, n_steps, ds):
    """K36: (path (C,), absorbed (C,), escaped 0-d) of packets from r0
    (Np, nd) along dirs (Np, nd) through the flat per-cell `opacity`, at
    step ds."""
    n, nd = r0.shape
    dt, dev = r0.dtype, r0.device
    n_cells = math.prod(spec.ncells[:spec.ndim])
    _check(opacity, "opacity", dt, (n_cells,))
    _check(dirs, "dirs", dt, (n, nd))
    # the float64 sums: path, absorbed, then the escaped weight
    acc = torch.zeros((2 * n_cells + 1,), dtype=torch.float64, device=dev)
    path, absorbed = (torch.empty((n_cells,), dtype=dt, device=dev)
                      for _ in range(2))
    escaped = torch.empty((), dtype=dt, device=dev)
    _launch("packet_march", dt, dev, *_radiation_grid(spec), _p(opacity),
            _p(r0), _p(dirs), n, int(n_steps), float(ds), _p(acc), _p(path),
            _p(absorbed), _p(escaped),
            count=tree_count("packet_march", spec.ndim))
    return path, absorbed, escaped


# particles per block of a K37 histogram pass, and the most blocks
STROMGREN_CHUNK = 2048
STROMGREN_MAX_BLOCKS = 1024


def stromgren_prefix(r, rec, r_src, ndot, on, n_iter):
    """K37: (N,) bool, reached by some source after the independent
    Stromgren prefixes and `n_iter` flux-weighted rounds, from r (N,
    ndim), ndim 1-3, the recombination rates rec (N,), the sources r_src
    (S, ndim), ndot (S,) and on (S,) bool."""
    N, dt, dev = r.shape[0], r.dtype, r.device
    S = r_src.shape[0]
    nd = _gas_ndim(r, "r")
    _check(r, "r", dt, (N, nd))
    _check(rec, "rec", dt, (N,))
    _check(r_src, "r_src", dt, (S, nd))
    _check(ndot, "ndot", dt, (S,))
    _check(on, "on", torch.bool, (S,))
    n_blocks = max(1, min(-(-N // STROMGREN_CHUNK), STROMGREN_MAX_BLOCKS))
    chunk = max(1, -(-N // n_blocks))
    nlo = max(1, -(-max(N - 1, 1).bit_length() // 8))
    d, wrec = (torch.empty((S, N), dtype=dt, device=dev) for _ in range(2))
    partial = torch.empty((S, n_blocks, 256), dtype=dt, device=dev)
    # five 8-byte words a source (csrc/radiation.cu:SrcState)
    state = torch.zeros((S, 5), dtype=torch.int64, device=dev)
    out = torch.empty((N,), dtype=torch.bool, device=dev)
    _launch("stromgren_prefix", dt, dev, _p(r), _p(rec), N, nd, _p(r_src),
            _p(ndot), _p(on), S, int(n_iter), nlo, chunk, n_blocks, _p(d),
            _p(wrec), _p(partial), _p(state), _p(out),
            count=tree_count("stromgren_prefix", nd))
    return out
