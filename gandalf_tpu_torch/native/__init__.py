"""The C++ host planners of the tree (``kdplan.cpp``), loaded with ctypes.

A copy of the part of ``gandalf_tpu/native`` that the port calls: the KD
bucket planner and the per-level walk statistics, with the same source
and signatures.  The
library is built with g++ at first use into ``gandalf_tpu_torch/_build/``
(its name carries a hash of the source, so an edited source is rebuilt).
The port has no numpy planner to fall back to, so ``load`` raises when
the library cannot be built or loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "kdplan.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build"

_LIB = None


def library_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"libkdplan_{tag}.so"


def _build(so: Path) -> str:
    """Compile kdplan.cpp into `so`; returns "" or the compiler's
    complaint."""
    _BUILD.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    log = ""
    # -march=native is refused on some hosts: then build without it
    for arch in (["-march=native"], []):
        cmd = ["g++", "-O3", *arch, "-shared", "-fPIC", "-o", str(tmp),
               str(_SRC)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            return str(exc)
        if res.returncode == 0:
            os.replace(tmp, so)
            return ""
        log = res.stderr
    tmp.unlink(missing_ok=True)
    return log or "g++ failed"


def load() -> ctypes.CDLL:
    """The planner library, built on first use; raises RuntimeError when
    g++ cannot build it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.exists():
        err = _build(so)
        if err:
            raise RuntimeError(
                "the C++ tree planner is unavailable: g++ could not build "
                "gandalf_tpu_torch/native/kdplan.cpp.  The port has no "
                "numpy fallback (ROADMAP queue 1, item 8):\n" + err[-3000:])
    lib = ctypes.CDLL(str(so))
    lib.kd_plan_buckets.restype = ctypes.c_int64
    lib.kd_plan_buckets.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.tree_walk_stats_levels.restype = ctypes.c_int64
    lib.tree_walk_stats_levels.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    _LIB = lib
    return _LIB
