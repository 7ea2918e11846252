"""Build, load and launch the CUDA kernels K1-K15 of ``csrc/``.

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
under ``tree_near_mfv``, and otherwise under their own names.  The
N-body kernels K13-K15 count under ``direct_nbody``, ``direct_softened``
and ``direct_snap``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"
_UNITS = ("grid27_bin.cu", "grid27_density.cu", "grid27_forces.cu",
          "tree_gather.cu", "tree_build.cu", "tree_walk.cu", "tree_near.cu",
          "active_density.cu", "active_forces.cu", "mfv_density.cu",
          "mfv_gradients.cu", "mfv_fluxes.cu", "nbody_direct.cu")
# no --use_fast_math: the float64 parity checks need IEEE sqrt and division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel since the last reset_launches()
LAUNCHES = {"grid27_bin": 0, "grid27_density": 0, "grid27_forces": 0,
            "tree_gather": 0, "tree_build": 0, "tree_walk": 0,
            "tree_near": 0, "tree_walk_list": 0, "tree_near_list": 0,
            "tree_near_mfv": 0, "tree_walk_ewald": 0, "tree_near_ewald": 0,
            "tree_walk_gadget2": 0, "tree_walk_eigenmac": 0,
            "tree_walk_fast": 0, "tree_near_fast": 0, "active_density": 0,
            "active_forces": 0,
            "mfv_density": 0, "mfv_gradients": 0, "mfv_fluxes": 0,
            "direct_nbody": 0, "direct_softened": 0, "direct_snap": 0}

_lib = None

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = {
    "grid27_bin": [_P, _I, _I, _I, _I, _D, _D, _D, _D, _D, _D, _I,
                   _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "grid27_density": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _D, _D, _D, _D, _D, _D, _D, _P, _P, _P, _P, _I, _P],
    "grid27_forces": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _D, _D, _D, _D, _I, _I, _D, _D, _P, _P, _P, _I, _P],
    "tree_gather": [_P, _I, _P, _P, _P, _P, _I, _D, _D, _D, _P, _P, _I, _P],
    "tree_build": [_P, _P, _I, _I, _P, _P, _I, _P],
    "tree_walk": [_P, _P, _P, _P, _I, _I, _I, _P, _D, _I, _I, _I, _D, _P,
                  _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "tree_near": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  _I, _D, _D, _P, _P, _P, _P, _P, _I, _P],
    "active_density": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _D, _D, _D, _D, _D, _D, _D, _P, _P, _P, _P, _I,
                       _P],
    "active_forces": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _D, _D, _D, _D, _D, _I, _I, _I, _D, _D, _P,
                      _P, _P, _P, _I, _P],
    "mfv_density": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _D, _D, _D,
                    _D, _D, _D, _D, _D, _P, _P, _P, _P, _I, _P],
    "mfv_gradients": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _D, _D, _D,
                      _D, _D, _P, _P, _P, _P, _P, _I, _P],
    "mfv_fluxes": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _D, _D, _D,
                   _D, _D, _I, _P, _P, _I, _P],
    "direct_nbody": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    "direct_softened": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    "direct_snap": [_P, _P, _P, _P, _I, _I, _P, _I, _P],
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
    the library.  Returns the library's path."""
    so = library_path()
    if so.exists():
        return so
    _BUILD.mkdir(exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [_BUILD / f"{tag}.{Path(u).stem}.o" for u in _UNITS]
    procs = [subprocess.Popen(
        [_nvcc(), *compile_flags, "-c", "-o", str(o), str(_CSRC / u)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for u, o in zip(_UNITS, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = so.with_name(f"{tag}.tmp")
    link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    log = "".join(logs) + link.stdout + link.stderr
    so.with_suffix(".log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [u for u, p in zip(_UNITS, procs) if p.returncode != 0]
    if failed or link.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed or 'link'}):\n"
                           + log[-6000:])
    os.replace(tmp, so)
    return so


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
    if spec.ndim != 3 or spec.qz != 1 or spec.mirror:
        raise NotImplementedError("the CUDA kernels take 3D grids without "
                                  "mirror layers and with qz = 1")
    return (*spec.ncells, spec.k_cell, *[int(p) for p in spec.periodic],
            *[float(x) for x in spec.extents])


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


def grid27_bin(spec, r: torch.Tensor):
    """K1 on r (N, 3): (cell_of, slot_of) int32 (N,) and overflow ()."""
    N = r.shape[0]
    _check(r, "r", r.dtype, (N, 3))
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
    _launch("grid27_bin", r.dtype, dev, _p(r), N, *spec.ncells,
            *[float(x) for x in spec.lo], *[float(x) for x in spec.extents],
            spec.k_cell, _p(count), _p(offset), _p(rank_tmp), _p(members),
            _p(cell_of), _p(slot_of), _p(overflow))
    return cell_of, slot_of, overflow


def grid27_density(spec, kern, h_fac, h_converge, hmax, r_d, m_d, h_d,
                   fill):
    """K2 on dense (*ncells, K[, 3]) tensors: (rho, invom, zeta) sums at
    each slot's final h and its converged flag."""
    shape = tuple(spec.ncells) + (spec.k_cell,)
    dt = r_d.dtype
    _check(r_d, "r_d", dt, shape + (3,))
    _check(m_d, "m_d", dt, shape)
    _check(h_d, "h_d", dt, shape)
    _check(fill, "fill", torch.bool, shape)
    rho, invom, zeta = (torch.empty(shape, dtype=dt, device=r_d.device)
                        for _ in range(3))
    done = torch.empty(shape, dtype=torch.bool, device=r_d.device)
    _launch("grid27_density", dt, r_d.device, _p(r_d), _p(m_d), _p(h_d),
            _p(fill), *_grid_args(spec), float(kern.kernnorm), float(h_fac),
            float(h_converge), float(hmax), _p(rho), _p(invom), _p(zeta),
            _p(done))
    return rho, invom, zeta, done


def grid27_forces(spec, kern, visc, r_d, v_d, packed, fill):
    """K3 on dense tensors: pair sums a (*ncells, K, 3), dudt and the
    unnormalised div_v (*ncells, K).  `packed` (*ncells, K, 9) holds
    ops.sph_grid27.FORCE_SCALARS."""
    shape = tuple(spec.ncells) + (spec.k_cell,)
    dt = r_d.dtype
    _check(r_d, "r_d", dt, shape + (3,))
    _check(v_d, "v_d", dt, shape + (3,))
    _check(packed, "packed", dt, shape + (9,))
    _check(fill, "fill", torch.bool, shape)
    a = torch.empty(shape + (3,), dtype=dt, device=r_d.device)
    dudt = torch.empty(shape, dtype=dt, device=r_d.device)
    div_v = torch.empty(shape, dtype=dt, device=r_d.device)
    _launch("grid27_forces", dt, r_d.device, _p(r_d), _p(v_d), _p(packed),
            _p(fill), *_grid_args(spec), float(kern.kernnorm),
            int(visc.avisc), int(visc.acond), float(visc.alpha_visc),
            float(visc.beta_visc), _p(a), _p(dudt), _p(div_v))
    return a, dudt, div_v


# ---------------------------------------------------------------------------
# Tree gravity, K4-K7 (layouts of ops/tree.py)
# ---------------------------------------------------------------------------

_LEAF = 32
_PCOLS, _CCOLS = 6, 16


def _tree_shapes(spec):
    if spec.leaf_size != _LEAF:
        raise NotImplementedError(f"the tree kernels take buckets of "
                                  f"{_LEAF} slots, not {spec.leaf_size}")
    G = spec.n_leaves
    return G, G * _LEAF, (2 << spec.depth) - 1


def tree_gather(spec, gmap, r, m, h, zh, periodic_extent):
    """K4: slot table (G*32, 6) and alive (G*32,) bool from particle
    fields (h, zh may be None) through gmap (G, 32) int32."""
    G, S, _ = _tree_shapes(spec)
    N, dt, dev = r.shape[0], r.dtype, r.device
    _check(gmap, "gmap", torch.int32, (G, _LEAF))
    _check(r, "r", dt, (N, 3))
    _check(m, "m", dt, (N,))
    for name, x in (("h", h), ("zh", zh)):
        if x is not None:
            _check(x, name, dt, (N,))
    ext = [0.0, 0.0, 0.0] if periodic_extent is None \
        else [float(e) for e in periodic_extent]
    ptab = torch.empty((S, _PCOLS), dtype=dt, device=dev)
    alive = torch.empty((S,), dtype=torch.bool, device=dev)
    _launch("tree_gather", dt, dev, _p(gmap), G, _p(r), _p(m),
            None if h is None else _p(h), None if zh is None else _p(zh),
            int(periodic_extent is not None), *ext, _p(ptab), _p(alive))
    return ptab, alive


def tree_build(spec, ptab, alive):
    """K5: the level-concatenated cell table (2^(D+1) - 1, 16)."""
    _, S, rows = _tree_shapes(spec)
    dt, dev = ptab.dtype, ptab.device
    _check(ptab, "ptab", dt, (S, _PCOLS))
    _check(alive, "alive", torch.bool, (S,))
    ctab = torch.empty((rows, _CCOLS), dtype=dt, device=dev)
    box = torch.empty((rows, 6), dtype=dt, device=dev)
    _launch("tree_build", dt, dev, _p(ptab), _p(alive), spec.depth,
            int(spec.quadrupole), _p(ctab), _p(box))
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
_FAST_COLS = 13


def _ewald_args(ewald, dt, dev):
    """(table pointer, metadata array) of an (EwaldTable, extent) pair,
    or (None, None); the caller keeps the array alive over the call."""
    if ewald is None:
        return None, None
    table, extent = ewald
    tab = table.tensor(dev, dt)
    return tab, table.meta(extent)


def launch_names(spec, ewald=False, listed=False, mfv=False):
    """The LAUNCHES names (K6, K7) of a walk with TreeSpec `spec`, with
    or without the Ewald sum, over a group list or all groups, and (K7)
    in the SPH or the MFV zeta mode."""
    if listed:
        return "tree_walk_list", "tree_near_list"
    if ewald:
        return "tree_walk_ewald", "tree_near_ewald"
    if spec.fast:
        return "tree_walk_fast", "tree_near_fast"
    walk = "tree_walk" if spec.mac == "geometric" else f"tree_walk_{spec.mac}"
    return walk, "tree_near_mfv" if mfv else "tree_near"


def tree_walk(spec, ctab, ptab, alive, group_ids=None, gfac=None,
              ewald=None):
    """K6: far a (G*32, 3), far pot (G*32,), near list (G, Wn) int32 and
    overflow () bool; with spec.fast the first two are the groups'
    expansions (G, 13) (a0, pot0, Jacobian) and None.  `gfac` (G,) is
    the per-group factor of the gadget2 or eigenmac MAC (required with
    either); `ewald` an (EwaldTable, extent) pair for the periodic walk.
    With `group_ids` (G_act,) int32 only the listed groups walk: their
    rows are written, the others hold zeros (a, pot) and -1 (near)."""
    G, S, rows = _tree_shapes(spec)
    dt, dev = ptab.dtype, ptab.device
    _check(ctab, "ctab", dt, (rows, _CCOLS))
    _check(ptab, "ptab", dt, (S, _PCOLS))
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
        a_far, pot_far = alloc((G, _FAST_COLS), dtype=dt, device=dev), None
    else:
        a_far = alloc((S, 3), dtype=dt, device=dev)
        pot_far = alloc((S,), dtype=dt, device=dev)
    near = (torch.full((G, spec.near_cap), -1, dtype=torch.int32,
                       device=dev) if listed else
            torch.empty((G, spec.near_cap), dtype=torch.int32, device=dev))
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    tab, meta = _ewald_args(ewald, dt, dev)
    count = launch_names(spec, tab is not None, listed)[0]
    if n_groups:
        _launch("tree_walk", dt, dev, _p(ctab), _p(ptab), _p(alive), gptr,
                n_groups, spec.depth, spec.near_cap, ctypes.addressof(caps_c),
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
    """K7: a (n_out, 3), gpot (n_out,) at rows out_index[slot] of the live
    slots (zero elsewhere), and the support overflow () bool.  `kern`
    None sums Newtonian pairs only.  With spec.fast, `a_far` is K6's
    (G, 13) expansions and `pot_far` None.  `ewald` an (EwaldTable,
    extent) pair min-images each pair and adds the table's correction.
    With `group_ids` only the listed groups' slots are written.
    `zeta_scaling` "mfv" takes the meshless finite-volume zeta term."""
    mfv = zeta_scaling == "mfv"
    if mfv and group_ids is not None:
        raise NotImplementedError("the MFV zeta mode walks all groups")
    G, S, rows = _tree_shapes(spec)
    dt, dev = ptab.dtype, ptab.device
    _check(ctab, "ctab", dt, (rows, _CCOLS))
    _check(ptab, "ptab", dt, (S, _PCOLS))
    _check(alive, "alive", torch.bool, (S,))
    _check(near, "near", torch.int32, (G, spec.near_cap))
    if spec.fast:
        _check(a_far, "a_far", dt, (G, _FAST_COLS))
        if pot_far is not None:
            raise ValueError("pot_far: the fast multipoles take None")
    else:
        _check(a_far, "a_far", dt, (S, 3))
        _check(pot_far, "pot_far", dt, (S,))
    out_index = out_index.reshape(-1)
    _check(out_index, "out_index", torch.int32, (S,))
    gptr, n_groups = _group_list(spec, group_ids, dev)
    a = torch.zeros((n_out, 3), dtype=dt, device=dev)
    gpot = torch.zeros((n_out,), dtype=dt, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    smoothed = kern is not None
    tab, meta = _ewald_args(ewald, dt, dev)
    count = launch_names(spec, tab is not None, group_ids is not None,
                         mfv)[1]
    if n_groups:
        _launch("tree_near", dt, dev, _p(ctab), _p(ptab), _p(alive),
                _p(near), None if spec.fast else _p(a_far),
                None if spec.fast else _p(pot_far),
                _p(a_far) if spec.fast else None, _p(out_index), gptr,
                n_groups, spec.depth, spec.near_cap, spec.support_cap,
                int(smoothed), int(mfv),
                float(kern.kernrange) if smoothed else 0.0,
                float(kern.kernnorm) if smoothed else 0.0,
                None if tab is None else _p(tab),
                None if meta is None else meta.ctypes.data, _p(a), _p(gpot),
                _p(overflow), count=count)
    return a, gpot, overflow


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
    own h over the 27 cells of K1's slot map ids_d (*ncells, K) int32
    (-1 empty): (rho, invom, zeta) sums at the final h and the converged
    flag, each (n,)."""
    N, dt, dev = r.shape[0], r.dtype, r.device
    n = _active_args(spec, idx, cell_of, ids_d, N)
    _check(r, "r", dt, (N, 3))
    _check(m, "m", dt, (N,))
    _check(h, "h", dt, (N,))
    rho, invom, zeta = (torch.empty((n,), dtype=dt, device=dev)
                        for _ in range(3))
    done = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        _launch("active_density", dt, dev, _p(idx), n, _p(cell_of),
                _p(ids_d), _p(r), _p(m), _p(h), *_grid_args(spec),
                float(kern.kernnorm), float(h_fac), float(h_converge),
                float(hmax), _p(rho), _p(invom), _p(zeta), _p(done))
    return rho, invom, zeta, done


def active_forces(spec, kern, visc, idx, cell_of, ids_d, r, v, packed,
                  level, levelneib, hydro_forces):
    """K9: pair forces of the particles idx (n,) int32 over the 27 cells
    of ids_d: a (n, 3), dudt and div_v (n,) after the epilogue (zero
    without hydro forces), and a copy of levelneib (N,) int32 raised by
    the neighbour-level scatter in both directions.  `packed` (N, 9)
    holds ops.sph_grid27.FORCE_SCALARS per particle."""
    N, dt, dev = r.shape[0], r.dtype, r.device
    n = _active_args(spec, idx, cell_of, ids_d, N)
    _check(r, "r", dt, (N, 3))
    _check(v, "v", dt, (N, 3))
    _check(packed, "packed", dt, (N, 9))
    _check(level, "level", torch.int32, (N,))
    _check(levelneib, "levelneib", torch.int32, (N,))
    a = torch.empty((n, 3), dtype=dt, device=dev)
    dudt = torch.empty((n,), dtype=dt, device=dev)
    div_v = torch.empty((n,), dtype=dt, device=dev)
    lneib = levelneib.clone()
    if n:
        _launch("active_forces", dt, dev, _p(idx), n, _p(cell_of),
                _p(ids_d), _p(r), _p(v), _p(packed), _p(level),
                *_grid_args(spec), float(kern.kernnorm),
                float(kern.kernrange), int(hydro_forces), int(visc.avisc),
                int(visc.acond), float(visc.alpha_visc),
                float(visc.beta_visc), _p(a), _p(dudt), _p(div_v),
                _p(lneib))
    return a, dudt, div_v, lneib


# ---------------------------------------------------------------------------
# Meshless finite volume, K10-K12 (layouts of ops/mfv_grid27.py)
# ---------------------------------------------------------------------------

def _slot_map_args(spec, ids_d, r):
    N = r.shape[0]
    _check(ids_d, "ids_d", torch.int32, tuple(spec.ncells) + (spec.k_cell,))
    _check(r, "r", r.dtype, (N, 3))
    return N


def mfv_density(spec, kern, h_fac, h_converge, hmax, ids_d, r, m, h):
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
            *_grid_args(spec), float(kern.kernnorm), float(h_fac),
            float(h_fac ** 3), float(h_converge), float(hmax), _p(ndens),
            _p(invom), _p(zeta), _p(done))
    return ndens, invom, zeta, done


def mfv_gradients(spec, kern, ids_d, r, packed):
    """K11 over the slot map: B (N, 3, 3), grad (N, 5, 3), alpha_slope
    (N, 5), vsig_max (N,) and bad (N,) bool.  `packed` (N, 8) holds
    ops.mfv_grid27.GRAD_COLS."""
    N = _slot_map_args(spec, ids_d, r)
    dt, dev = r.dtype, r.device
    _check(packed, "packed", dt, (N, 8))
    B = torch.zeros((N, 3, 3), dtype=dt, device=dev)
    grad = torch.zeros((N, 5, 3), dtype=dt, device=dev)
    alpha = torch.ones((N, 5), dtype=dt, device=dev)
    vsig = torch.zeros((N,), dtype=dt, device=dev)
    bad = torch.zeros((N,), dtype=torch.bool, device=dev)
    _launch("mfv_gradients", dt, dev, _p(ids_d), _p(r), _p(packed),
            *_grid_args(spec), float(kern.kernnorm), float(kern.kernrange),
            _p(B), _p(grad), _p(alpha), _p(vsig), _p(bad))
    return B, grad, alpha, vsig, bad


def mfv_fluxes(spec, kern, cfg, dt_t, ids_d, r, packed):
    """K12 over the slot map: dQdt (N, 5) and rdmdt_dot (N, 3) with the
    MUSCL half step over dt_t (a 0-d tensor on the device, read there).
    `packed` (N, 41) holds ops.mfv_grid27.FLUX_COLS."""
    N = _slot_map_args(spec, ids_d, r)
    dt, dev = r.dtype, r.device
    _check(packed, "packed", dt, (N, 41))
    _check(dt_t, "dt", dt, ())
    dQdt = torch.zeros((N, 5), dtype=dt, device=dev)
    rdmdt = torch.zeros((N, 3), dtype=dt, device=dev)
    _launch("mfv_fluxes", dt, dev, _p(ids_d), _p(r), _p(packed), _p(dt_t),
            *_grid_args(spec), float(kern.kernnorm), float(cfg.gamma),
            int(cfg.zero_mass_flux), _p(dQdt), _p(rdmdt))
    return dQdt, rdmdt


# ---------------------------------------------------------------------------
# Direct-summation N-body gravity, K13-K15 (ops/gravity.py)
# ---------------------------------------------------------------------------

def _stars(r, m, *vectors):
    """(N, ndim) of a star set, checked: r and the (N, ndim) `vectors` in
    r's dtype, m (N,); ndim 2 or 3."""
    N, ndim = r.shape if r.dim() == 2 else (None, None)
    if ndim not in (2, 3):
        raise ValueError(f"r: expected shape (N, 2) or (N, 3), got "
                         f"{tuple(r.shape)}")
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


def direct_softened(r, v, m, h, compute_jerk: bool = False):
    """K14: mean-h M4-softened (a, adot, gpot); adot is the Newtonian
    jerk, zero without `compute_jerk`."""
    N, ndim = _stars(r, m, ("v", v))
    _check(h, "h", r.dtype, (N,))
    a = torch.empty_like(r)
    adot = torch.empty_like(r) if compute_jerk else torch.zeros_like(r)
    gpot = torch.empty_like(m)
    _launch("direct_softened", r.dtype, r.device, _p(r), _p(v), _p(m), _p(h),
            N, ndim, int(compute_jerk), _p(a),
            _p(adot) if compute_jerk else None, _p(gpot))
    return a, adot, gpot


def direct_snap(r, v, a, m):
    """K15: the snap (N, ndim) of every star from r, v and a."""
    N, ndim = _stars(r, m, ("v", v), ("a", a))
    snap = torch.empty_like(r)
    _launch("direct_snap", r.dtype, r.device, _p(r), _p(v), _p(a), _p(m), N,
            ndim, _p(snap))
    return snap
