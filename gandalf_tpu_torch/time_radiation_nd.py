"""A/B of K35 (ray_march) and K36 (packet_march) with the grid's ndim a
template parameter, as csrc/radiation.cu builds them, against the same
kernels with ndim a run-time loop bound, and print one JSON line per
ndim.

    python -m gandalf_tpu_torch.time_radiation_nd

The run-time variant is made from csrc/radiation.cu itself: Grid<T>
carries nd again, cell_of loops to it, and both kernels read it (their
NDIM parameter unused); it is built with nvcc beside the library in
_build/.  Both versions run on the same inputs, those of
check.radiation_kernel_inputs at the HII region of check.spitzer_sim in
float32: the 3D sphere and the 2D disc at 262,144 particles, the 1D rod
at 65,536 (48 samples a ray, the first Monte-Carlo iteration's 8 N
packets of 256 steps).  Per kernel: whether the outputs agree (K35 bit
for bit, K36 within 1e-5 of the largest cell sum: its float64 atomics
add in another order), then ms a launch (CUDA events, 5 launches) in the
order template, run-time, run-time, template.  Refuses to run without
CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

# (ndim, particles) of the comparison
CASES = ((3, 262144), (2, 262144), (1, 65536))


def runtime_source(src: str) -> str:
    """csrc/radiation.cu with ndim a run-time loop bound in K35, K36 and
    the cell lookup they share."""
    edits = (
        ("struct Grid {\n  int n[3];", "struct Grid {\n  int nd;\n  int n[3];"),
        ("  Grid<T> g;\n  for (int k = 0; k < 3; ++k) {",
         "  Grid<T> g;\n  g.nd = nd;\n  for (int k = 0; k < 3; ++k) {"),
        ("constexpr int nd = NDIM;", "const int nd = g.nd;"),
        ("cell_of<T, NDIM>(g, ", "cell_of_rt(g, "),
    )
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"time_radiation_nd: {old!r} not in the source")
        src = src.replace(old, new)
    a = src.index("template <typename T, int NDIM>\n__device__ __forceinline__ "
                  "long long cell_of(")
    b = src.index("// --- K34", a)
    rt = src[a:b].replace("template <typename T, int NDIM>",
                          "template <typename T>").replace(
        "long long cell_of(", "long long cell_of_rt(").replace(
        "k < NDIM", "k < g.nd").replace("#pragma unroll\n", "")
    return src[:b] + rt + src[b:]


def build_runtime_variant():
    """The run-time-ndim library (ctypes), built once per source."""
    from . import _ext

    src = (_ext._CSRC / "radiation.cu").read_text()
    so = _ext._BUILD / f"libradiation_nd_rt_{_ext._source_hash()}.so"
    if not so.exists():
        _ext._BUILD.mkdir(exist_ok=True)
        cu = so.with_suffix(".cu")
        cu.write_text(runtime_source(src))
        out = subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(so),
                              str(cu)], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + (out.stdout
                                                   + out.stderr)[-4000:])
    lib = ctypes.CDLL(str(so))
    for name in ("ray_march", "packet_march"):
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{sfx}")
            fn.argtypes = _ext._ARGTYPES[name]
            fn.restype = ctypes.c_int
    return lib


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
        sys.exit("time_radiation_nd: no CUDA device")
    from . import _ext
    from .check import radiation_kernel_inputs, spitzer_sim

    _ext.lib()
    rt = build_runtime_variant()
    shipped = _ext._launch

    def runtime_launch(name, dtype, device, *args, count=None):
        fn = getattr(rt, f"{name}_{_ext._float_suffix(dtype)}")
        rc = fn(*args, device.index,
                torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} (run-time ndim) failed: code {rc}")

    def on_runtime(call):
        _ext._launch = runtime_launch
        try:
            return call()
        finally:
            _ext._launch = shipped

    dev = torch.device("cuda", 0)
    for ndim, n in CASES:
        sim = spitzer_sim(n, "monoionisation", dev, torch.float32, ndim=ndim)
        inp = radiation_kernel_inputs(sim)
        spec = inp["spec"]
        field = inp["field"].reshape(-1).contiguous()
        opacity = inp["opacity"].reshape(-1).contiguous()
        ds = 0.5 * min(spec.extents[k] / spec.ncells[k]
                       for k in range(spec.ndim))
        calls = {
            "ray_march": lambda: (_ext.ray_march(
                spec, field, inp["r"], inp["dirs"], inp["lengths"], 48),),
            "packet_march": lambda: _ext.packet_march(
                spec, opacity, inp["r0"], inp["pdirs"], 256, ds),
        }
        report = {}
        for name, call in calls.items():
            a, b = call(), on_runtime(call)
            if name == "ray_march":
                same = all(torch.equal(x, y) for x, y in zip(a, b))
            else:
                same = all(float((x.double() - y.double()).abs().max())
                           <= 1e-5 * float(x.double().abs().max())
                           for x, y in zip(a, b))
            t1 = _ms(call)
            r1 = _ms(lambda: on_runtime(call))
            r2 = _ms(lambda: on_runtime(call))
            t2 = _ms(call)
            report[name] = {"same": same, "template_ms": [t1, t2],
                            "runtime_ms": [r1, r2]}
        print(json.dumps({"ndim": ndim, "N": sim.state.N,
                          "ncells": list(spec.ncells), "report": report}),
              flush=True)
        del sim, inp
    return 0


if __name__ == "__main__":
    sys.exit(main())
