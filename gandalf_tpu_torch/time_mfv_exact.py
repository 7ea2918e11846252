"""A/B of K12's exact Riemann mode with the one-dimensional solve out of
line, as csrc/riemann_exact.cuh builds it (``__noinline__``), against
the same kernel with the solve inlined at each of its call sites, and
print one JSON line per mode.

    python -m gandalf_tpu_torch.time_mfv_exact

The inlined variant is made from csrc/ itself: the headers are copied
beside the library in _build/ with ``__noinline__`` of solve_1d turned
into ``__forceinline__``, and mfv_fluxes_exact_3d_m4.cu is built from
there with nvcc (its wall time printed: the source alone, no other
build running).  Both versions run on the same inputs: mfv_box at 64^3
(check.mfv_params, jittered, hydro only) in float32 with the exact
solver and springel2009 after setup and two steps, the state's
gradients, alphas, a0 and dt packed as the controller packs them.  Per mode (MUSCL with the
cell alphas; RK2 with the cell alphas): whether the outputs agree
(within 1e-6 of dQdt's largest value), then ms a launch (CUDA events, 5
launches) in the order out of line, inlined, inlined, out of line.
Refuses to run without CUDA.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import shutil
import subprocess
import sys
import time

import torch

SOURCE = "mfv_fluxes_exact_3d_m4.cu"


def build_inlined_variant():
    """The library of SOURCE with the exact solve inlined (ctypes), built
    once per source tree; returns it and nvcc's wall seconds (None when
    it was built before)."""
    from . import _ext

    d = _ext._BUILD / f"exact_inlined_{_ext._source_hash()}"
    so = d / "libexact_inlined.so"
    seconds = None
    if not so.exists():
        d.mkdir(parents=True, exist_ok=True)
        for f in _ext._CSRC.glob("*.cuh"):
            shutil.copy(f, d / f.name)
        shutil.copy(_ext._CSRC / SOURCE, d / SOURCE)
        hdr = d / "riemann_exact.cuh"
        src = hdr.read_text()
        old = "__device__ __noinline__ Sample1d<T> solve_1d("
        if old not in src:
            raise RuntimeError(f"time_mfv_exact: {old!r} not in the source")
        hdr.write_text(src.replace(
            old, "__device__ __forceinline__ Sample1d<T> solve_1d("))
        t0 = time.perf_counter()
        out = subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(so),
                              str(d / SOURCE)], capture_output=True,
                             text=True)
        seconds = time.perf_counter() - t0
        if out.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + (out.stdout
                                                   + out.stderr)[-4000:])
    lib = ctypes.CDLL(str(so))
    name = "mfv_fluxes_exact_3d_m4"
    for sfx in ("f32", "f64"):
        fn = getattr(lib, f"{name}_{sfx}")
        fn.argtypes = _ext._ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib, seconds


def _ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("time_mfv_exact: no CUDA device")
    from . import _ext
    from .check import jittered_box_ic, mfv_params
    from .ops import mfv_grid27 as mg
    from .ops import sph_grid27 as g27
    from .ops.active_grid import dense_ids
    from .sim.simulation import SimulationBase

    _ext.lib()
    inl, seconds = build_inlined_variant()
    shipped = _ext._launch

    def inlined_launch(name, dtype, device, *args, count=None):
        fn = getattr(inl, f"{name}_{_ext._float_suffix(dtype)}")
        rc = fn(*args, device.index,
                torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} (inlined) failed: code {rc}")

    def on_inlined(call):
        _ext._launch = inlined_launch
        try:
            return call()
        finally:
            _ext._launch = shipped

    dev = torch.device("cuda", 0)
    p = mfv_params(64, self_gravity=0)
    p.set("riemann_solver", "exact")
    p.set("slope_limiter", "springel2009")
    sim = SimulationBase.factory(p, dev, torch.float32)
    sim.SetupSimulation(jittered_box_ic(p, 64))
    sim.main_loop_steps(2)
    s, spec, kern = sim.state, sim.gridspec, sim.kern
    ids_d = dense_ids(spec, g27.bin_particles(spec, s.r))
    fpk = mg.pack_flux_fields(s.h, s.ndens, s.Wprim, s.sound, s.a0, s.B,
                              s.grad, s.alpha_slope, s.bad_grad)
    print(json.dumps({"source": SOURCE, "inlined_build_s": seconds,
                      "N": s.N, "k_cell": spec.k_cell}), flush=True)
    for scheme in ("muscl", "rk2"):
        cfg = dataclasses.replace(sim.mfv_cfg, time_scheme=scheme)

        def call():
            return mg.fluxes_kernel(kern, cfg, spec, s.dt, ids_d, s.r, fpk)

        a, b = call(), on_inlined(call)
        same = float((a.dQdt - b.dQdt).abs().max()) \
            <= 1e-6 * float(a.dQdt.abs().max())
        t1 = _ms(call)
        r1 = _ms(lambda: on_inlined(call))
        r2 = _ms(lambda: on_inlined(call))
        t2 = _ms(call)
        print(json.dumps({"mode": f"exact_{scheme}_cell", "same": same,
                          "out_of_line_ms": [t1, t2],
                          "inlined_ms": [r1, r2]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
