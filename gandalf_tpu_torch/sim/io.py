"""Snapshot I/O: the port's own copy of ``gandalf_tpu/sim/io.py``, host
numpy only.

The `column` ASCII format (header lines Nhydro/Nstar/ndim/t, then
per-particle rows r[ndim] v[ndim] m h rho u, and the stars' rows r v m h;
src/Common/SimulationIO.hpp WriteColumnSnapshotFile), SEREN unformatted
(`su`, the reference default) and formatted (`sf`) with their star
records, and the float32 SEREN lite (`sl`, written only).  Files written
here read back through the JAX package's readers and the other way round
(tests/test_torch_io.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def write_column_snapshot(filename: str, t: float,
                          hydro: Dict[str, np.ndarray],
                          nstar: int = 0, star: Dict[str, np.ndarray] = None
                          ) -> None:
    r = np.asarray(hydro["r"])
    v = np.asarray(hydro["v"])
    N, ndim = r.shape
    cols = [r[:, k] for k in range(ndim)] + [v[:, k] for k in range(ndim)]
    cols += [np.asarray(hydro[k]) for k in ("m", "h", "rho", "u")]
    data = np.stack(cols, axis=-1)
    with open(filename, "w") as f:
        f.write(f"{N}\n{nstar}\n{ndim}\n{t!r}\n")
        np.savetxt(f, data, fmt="%.12e", delimiter="   ")
        if star is not None and nstar > 0:
            rs = np.asarray(star["r"])
            vs = np.asarray(star["v"])
            scols = [rs[:, k] for k in range(ndim)]
            scols += [vs[:, k] for k in range(ndim)]
            scols += [np.asarray(star[k]) for k in ("m", "h")]
            np.savetxt(f, np.stack(scols, axis=-1), fmt="%.12e",
                       delimiter="   ")


SEREN_TAG = "SERENBINARYDUMPV3"
STRING_LENGTH = 20


def write_seren_unform(filename: str, t: float, hydro: Dict[str, np.ndarray],
                       h_fac: float = 1.2, nsteps: int = 0,
                       noutsnap: int = 0, star: Dict[str, np.ndarray] = None,
                       units: list = None) -> None:
    """SEREN unformatted binary snapshot ('su', the reference default;
    Simulation::WriteSerenUnformSnapshotFile, SimulationIO.hpp).

    Header: 20-char tag, int precision, ndim x3, idata[50] i4,
    ilpdata[50] i8, rdata[50] FLOAT, ddata[50] f8, unit strings, data ids,
    typedata[ndata][5]; then per-array particle data (AoS vectors).
    """
    r = np.asarray(hydro["r"])
    N, ndim = r.shape
    fdtype = np.float64 if r.dtype == np.float64 else np.float32
    isize = 8 if fdtype == np.float64 else 4

    data_ids = ["porig", "r", "m", "h", "v", "rho", "u"]
    widths = {"porig": 1, "r": ndim, "m": 1, "h": 1, "v": ndim,
              "rho": 1, "u": 1}
    dtypes = {"porig": 2, "r": 4, "m": 4, "h": 4, "v": 4, "rho": 4, "u": 4}
    unit_ids = {"porig": 0, "r": 1, "m": 2, "h": 1, "v": 4,
                "rho": 6, "u": 20}

    nstar = 0 if star is None else len(star["m"])
    idata = np.zeros(50, np.int32)
    idata[0] = N
    idata[1] = nstar
    idata[4] = N          # all gas (type slot 3+1)
    idata[19] = len(units) if units else 0
    idata[20] = len(data_ids) + (1 if nstar else 0)
    ilpdata = np.zeros(50, np.int64)
    ilpdata[0] = noutsnap
    ilpdata[1] = nsteps
    rdata = np.zeros(50, fdtype)
    rdata[0] = h_fac
    ddata = np.zeros(50, np.float64)
    ddata[0] = t
    ddata[2] = float(np.mean(hydro["m"])) if N else 0.0

    with open(filename, "wb") as f:
        f.write(SEREN_TAG.ljust(STRING_LENGTH).encode())
        np.array([isize, ndim, ndim, ndim], np.int32).tofile(f)
        idata.tofile(f)
        ilpdata.tofile(f)
        rdata.tofile(f)
        ddata.tofile(f)
        for u in (units or []):
            f.write(str(u).ljust(STRING_LENGTH).encode())
        all_ids = list(data_ids) + (["sink_v1"] if nstar else [])
        for did in all_ids:
            f.write(did.ljust(STRING_LENGTH).encode())
        for did in data_ids:
            np.array([widths[did], 1, N, dtypes[did], unit_ids[did]],
                     np.int32).tofile(f)
        if nstar:
            np.array([1, 1, nstar, 7, 0], np.int32).tofile(f)
        # particle arrays (AoS per particle)
        np.asarray(hydro.get("iorig", np.arange(N)),
                   np.int32).tofile(f)
        r.astype(fdtype).tofile(f)
        np.asarray(hydro["m"], fdtype).tofile(f)
        np.asarray(hydro["h"], fdtype).tofile(f)
        np.asarray(hydro["v"], fdtype).tofile(f)
        np.asarray(hydro["rho"], fdtype).tofile(f)
        np.asarray(hydro["u"], fdtype).tofile(f)
        if nstar:
            sink_len = 12 + 2 * ndim
            np.array([2, 2, 0, sink_len, 0, 0], np.int32).tofile(f)
            rs = np.asarray(star["r"], fdtype)
            vs = np.asarray(star["v"], fdtype)
            ms = np.asarray(star["m"], fdtype)
            hs = np.asarray(star.get("h", np.ones(nstar)), fdtype)
            for i in range(nstar):
                np.array([1, 1], np.int8).tofile(f)
                np.array([i + 1, 0], np.int32).tofile(f)
                sdata = np.zeros(sink_len, fdtype)
                sdata[1:1 + ndim] = rs[i]
                sdata[1 + ndim:1 + 2 * ndim] = vs[i]
                sdata[1 + 2 * ndim] = ms[i]
                sdata[2 + 2 * ndim] = hs[i]
                sdata.tofile(f)


def read_seren_unform(filename: str) -> Tuple[float, Dict[str, np.ndarray]]:
    """Read a SEREN unformatted snapshot (including reference-written ones;
    Simulation::ReadSerenUnformSnapshotFile)."""
    with open(filename, "rb") as f:
        tag = f.read(STRING_LENGTH).decode().strip()
        if tag != SEREN_TAG:
            raise ValueError(f"not a SEREN binary snapshot: {tag!r}")
        isize, ndim, _, _ = np.fromfile(f, np.int32, 4)
        fdtype = np.float64 if isize == 8 else np.float32
        idata = np.fromfile(f, np.int32, 50)
        ilpdata = np.fromfile(f, np.int64, 50)
        rdata = np.fromfile(f, fdtype, 50)
        ddata = np.fromfile(f, np.float64, 50)
        N = int(idata[0])
        nstar = int(idata[1])
        nunit = int(idata[19])
        ndata = int(idata[20])
        for _ in range(nunit):
            f.read(STRING_LENGTH)
        data_ids = [f.read(STRING_LENGTH).decode().strip()
                    for _ in range(ndata)]
        typedata = np.fromfile(f, np.int32, 5 * ndata).reshape(ndata, 5)
        out: Dict[str, np.ndarray] = {}
        for did, td in zip(data_ids, typedata):
            width, _, n, dtype_code = int(td[0]), td[1], int(td[2]), \
                int(td[3])
            if did == "sink_v1":
                break
            if dtype_code == 2:
                arr = np.fromfile(f, np.int32, n * width)
            else:
                arr = np.fromfile(f, fdtype, n * width)
            # vector quantities stay 2D even in 1D sims
            out[did] = arr.reshape(n, width) if (width > 1
                                                 or did in ("r", "v")) \
                else arr
        out["nstar"] = nstar
        if "porig" in out:
            out["iorig"] = out.pop("porig")
        if nstar:
            np.fromfile(f, np.int32, 6)
            sink_len = 12 + 2 * ndim
            rs = np.zeros((nstar, ndim))
            vs = np.zeros((nstar, ndim))
            ms = np.zeros(nstar)
            hs = np.zeros(nstar)
            for i in range(nstar):
                np.fromfile(f, np.int8, 2)
                np.fromfile(f, np.int32, 2)
                sdata = np.fromfile(f, fdtype, sink_len)
                rs[i] = sdata[1:1 + ndim]
                vs[i] = sdata[1 + ndim:1 + 2 * ndim]
                ms[i] = sdata[1 + 2 * ndim]
                hs[i] = sdata[2 + 2 * ndim]
            out["star"] = {"r": rs, "v": vs, "m": ms, "h": hs}
    return float(ddata[0]), out


def read_column_snapshot(filename: str) -> Tuple[float, Dict[str, np.ndarray]]:
    with open(filename, "r") as f:
        n_hydro = int(f.readline())
        n_star = int(f.readline())
        ndim = int(f.readline())
        t = float(f.readline())
        rows = np.loadtxt(f, max_rows=n_hydro) if n_hydro else np.zeros((0, 2 * ndim + 4))
    rows = np.atleast_2d(rows)
    hydro = {
        "r": rows[:, :ndim],
        "v": rows[:, ndim:2 * ndim],
        "m": rows[:, 2 * ndim],
        "h": rows[:, 2 * ndim + 1],
        "rho": rows[:, 2 * ndim + 2],
        "u": rows[:, 2 * ndim + 3],
    }
    hydro["nstar"] = n_star
    return t, hydro


SEREN_ASCII_TAG = "SERENASCIIDUMPV2"


def write_seren_form(filename: str, t: float, hydro: Dict[str, np.ndarray],
                     h_fac: float = 1.2, nsteps: int = 0,
                     noutsnap: int = 0, star: Dict[str, np.ndarray] = None
                     ) -> None:
    """SEREN formatted (ASCII) snapshot, 'sf'
    (Simulation::WriteSerenFormSnapshotFile, SimulationIO.hpp:989-1210):
    same header layout as 'su' but one value per line, then scalar arrays
    one value per line and vector arrays one row per particle."""
    r = np.asarray(hydro["r"])
    N, ndim = r.shape
    data_ids = ["porig", "r", "m", "h", "v", "rho", "u"]
    widths = {"porig": 1, "r": ndim, "m": 1, "h": 1, "v": ndim,
              "rho": 1, "u": 1}
    dtypes = {"porig": 2, "r": 4, "m": 4, "h": 4, "v": 4, "rho": 4, "u": 4}
    unit_ids = {"porig": 0, "r": 1, "m": 2, "h": 1, "v": 4,
                "rho": 6, "u": 20}
    nstar = 0 if star is None else len(star["m"])
    idata = np.zeros(50, np.int64)
    idata[0] = N
    idata[1] = nstar
    idata[4] = N
    idata[20] = len(data_ids) + (1 if nstar else 0)
    ilpdata = np.zeros(50, np.int64)
    ilpdata[0] = noutsnap
    ilpdata[1] = nsteps
    rdata = np.zeros(50)
    rdata[0] = h_fac
    ddata = np.zeros(50)
    ddata[0] = t
    ddata[2] = float(np.mean(hydro["m"])) if N else 0.0

    with open(filename, "w") as f:
        w = lambda x: f.write(f"{x}\n")
        w(SEREN_ASCII_TAG)
        w(4)
        for _ in range(3):
            w(ndim)
        for arr in (idata, ilpdata):
            for x in arr:
                w(int(x))
        for arr in (rdata, ddata):
            for x in arr:
                w(f"{x:.10e}")
        for did in data_ids + (["sink_v1"] if nstar else []):
            w(did)
        for did in data_ids:
            f.write(f"{widths[did]} 1 {N} {dtypes[did]} {unit_ids[did]}\n")
        if nstar:
            f.write(f"1 1 {nstar} 7 0\n")
        np.savetxt(f, np.asarray(hydro.get("iorig", np.arange(N)),
                                 np.int64), fmt="%d")
        np.savetxt(f, r, fmt="%.10e")
        np.savetxt(f, np.asarray(hydro["m"]), fmt="%.10e")
        np.savetxt(f, np.asarray(hydro["h"]), fmt="%.10e")
        np.savetxt(f, np.asarray(hydro["v"]).reshape(N, ndim), fmt="%.10e")
        np.savetxt(f, np.asarray(hydro["rho"]), fmt="%.10e")
        np.savetxt(f, np.asarray(hydro["u"]), fmt="%.10e")
        if nstar:
            sink_len = 12 + 2 * ndim
            f.write(f"2 2 0 {sink_len} 0 0\n")
            for i in range(nstar):
                f.write("1 1\n")
                f.write(f"{i + 1} 0\n")
                sdata = np.zeros(sink_len)
                sdata[1:1 + ndim] = np.asarray(star["r"])[i]
                sdata[1 + ndim:1 + 2 * ndim] = np.asarray(star["v"])[i]
                sdata[1 + 2 * ndim] = np.asarray(star["m"])[i]
                sdata[2 + 2 * ndim] = np.asarray(star["h"])[i]
                f.write(" ".join(f"{x:.10e}" for x in sdata) + "\n")


def read_seren_form(filename: str) -> Tuple[float, Dict[str, np.ndarray]]:
    """Read a SEREN formatted ('sf') snapshot."""
    with open(filename) as f:
        tok = iter(f.read().split())
    tag = next(tok)
    if not tag.startswith("SERENASCIIDUMP"):
        raise ValueError(f"not a SEREN ASCII snapshot: {tag!r}")
    next(tok)                          # precision
    ndim = int(next(tok))
    next(tok); next(tok)
    idata = np.array([int(next(tok)) for _ in range(50)])
    ilpdata = np.array([int(next(tok)) for _ in range(50)])
    rdata = np.array([float(next(tok)) for _ in range(50)])
    ddata = np.array([float(next(tok)) for _ in range(50)])
    N, nstar, ndata = int(idata[0]), int(idata[1]), int(idata[20])
    data_ids = [next(tok) for _ in range(ndata)]
    typedata = [[int(next(tok)) for _ in range(5)] for _ in range(ndata)]
    out: Dict[str, np.ndarray] = {}
    for did, td in zip(data_ids, typedata):
        if did == "sink_v1":
            break
        width, n = td[0], td[2]
        vals = np.array([float(next(tok)) for _ in range(n * width)])
        out[did] = vals.reshape(n, width) if (width > 1
                                              or did in ("r", "v")) else vals
    out["nstar"] = nstar
    if "porig" in out:
        out["iorig"] = out.pop("porig").astype(np.int64)
    if nstar:
        for _ in range(6):
            next(tok)
        sink_len = 12 + 2 * ndim
        rs, vs = np.zeros((nstar, ndim)), np.zeros((nstar, ndim))
        ms, hs = np.zeros(nstar), np.zeros(nstar)
        for i in range(nstar):
            for _ in range(4):
                next(tok)
            sdata = np.array([float(next(tok)) for _ in range(sink_len)])
            rs[i] = sdata[1:1 + ndim]
            vs[i] = sdata[1 + ndim:1 + 2 * ndim]
            ms[i] = sdata[1 + 2 * ndim]
            hs[i] = sdata[2 + 2 * ndim]
        out["star"] = {"r": rs, "v": vs, "m": ms, "h": hs}
    return float(ddata[0]), out


def write_seren_lite(filename: str, t: float, hydro: Dict[str, np.ndarray],
                     noutsnap: int = 0) -> None:
    """Reduced 'sl' (lite) binary snapshot: float32 r/m/h/rho/u only
    (Simulation::WriteSerenLiteSnapshotFile)."""
    r = np.asarray(hydro["r"])
    N, ndim = r.shape
    data_ids = ["r", "m", "h", "rho", "u"]
    widths = {"r": ndim, "m": 1, "h": 1, "rho": 1, "u": 1}
    unit_ids = {"r": 1, "m": 2, "h": 1, "rho": 6, "u": 20}
    idata = np.zeros(50, np.int32)
    idata[0] = N
    idata[4] = N
    idata[20] = len(data_ids)
    ilpdata = np.zeros(50, np.int64)
    ilpdata[0] = noutsnap
    rdata = np.zeros(50, np.float32)
    ddata = np.zeros(50, np.float64)
    ddata[0] = t
    with open(filename, "wb") as f:
        f.write(SEREN_TAG.ljust(STRING_LENGTH).encode())
        np.array([4, ndim, ndim, ndim], np.int32).tofile(f)
        idata.tofile(f)
        ilpdata.tofile(f)
        rdata.tofile(f)
        ddata.tofile(f)
        for did in data_ids:
            f.write(did.ljust(STRING_LENGTH).encode())
        for did in data_ids:
            np.array([widths[did], 1, N, 4, unit_ids[did]],
                     np.int32).tofile(f)
        r.astype(np.float32).tofile(f)
        for k in ("m", "h", "rho", "u"):
            np.asarray(hydro[k], np.float32).tofile(f)
