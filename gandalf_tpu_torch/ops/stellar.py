"""Stellar-properties table: mass -> (L, N_LyC, Teff, Mdot, vwind).

Counterpart of ``gandalf_tpu/ops/stellar.py`` (Nbody::
LoadStellarPropertiesTable and UpdateStellarProperties,
src/Nbody/Nbody.cpp:143-224): a small table linearly interpolated in
mass, luminosity and ionising photon rate stored as log10.  The
radiation schemes read N_LyC of every sink and star from it
(``stellar_nlyc``).  The table's columns stay host numpy arrays; the
interpolation is elementwise torch on the masses' device and dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor

# the fallback table in the reference's stellar.dat layout (representative
# ZAMS values: mass, log L/Lsun, log N_LyC [s^-1], Teff [K], Mdot [1e-6
# Msun/yr], vwind [km/s]), used where no stellar.dat is present
_DEFAULT = np.array([
    #  M      logL   logNLyC  Teff    Mdot    vwind
    [0.0,    0.00,   0.0,     0.0,    0.0,    0.0],
    [1.0,    1.00,   0.0,     5800.,  0.0,    0.0],
    [4.0,    2.35,   0.0,     12300., 0.0,    0.0],
    [5.0,    2.79,   0.0,     15400., 0.0,    0.0],
    [6.0,    3.06,   44.0,    17500., 0.0,    0.0],
    [7.5,    3.34,   44.6,    19000., 0.11,   750.0],
    [9.0,    3.59,   45.2,    21000., 0.23,   1000.0],
    [12.0,   3.95,   45.9,    24000., 0.40,   1500.0],
    [15.0,   4.21,   46.5,    27000., 0.71,   1800.0],
    [20.0,   4.56,   47.3,    31000., 1.30,   2200.0],
    [25.0,   4.81,   47.9,    34000., 2.10,   2500.0],
    [30.0,   5.00,   48.3,    36500., 3.10,   2800.0],
    [35.0,   5.15,   48.6,    38500., 4.10,   3000.0],
    [40.0,   5.28,   48.8,    40000., 5.20,   3200.0],
    [50.0,   5.47,   49.1,    42500., 7.50,   3500.0],
    [60.0,   5.62,   49.4,    44500., 10.0,   3700.0],
    [80.0,   5.84,   49.7,    47000., 15.0,   4000.0],
    [100.0,  6.00,   49.9,    48500., 21.0,   4200.0],
    [120.0,  6.13,   50.0,    50000., 27.0,   4400.0],
])


@dataclasses.dataclass(frozen=True)
class StellarTable:
    mass: np.ndarray       # (T,) in code mass units
    log_lum: np.ndarray    # log10 L
    log_nlyc: np.ndarray   # log10 N_LyC
    teff: np.ndarray
    mdot: np.ndarray
    vwind: np.ndarray


def _from_rows(t: np.ndarray, m_inscale: float) -> StellarTable:
    return StellarTable(mass=t[:, 0] / m_inscale, log_lum=t[:, 1],
                        log_nlyc=t[:, 2], teff=t[:, 3], mdot=t[:, 4],
                        vwind=t[:, 5])


def default_stellar_table(m_inscale: float = 1.0) -> StellarTable:
    return _from_rows(_DEFAULT, m_inscale)


def load_stellar_table(path: str, m_inscale: float = 1.0) -> StellarTable:
    """Read a `stellar.dat`-format file: first line = row count, four
    more header lines, then rows of (mass, logL, logNLyC, Teff, Mdot,
    vwind) (Nbody::LoadStellarPropertiesTable, Nbody.cpp:143-186)."""
    with open(path) as f:
        n = int(f.readline().split()[0])
        for _ in range(4):
            f.readline()
        rows = []
        while len(rows) < n:
            parts = f.readline().split()
            if len(parts) >= 6:
                rows.append([float(x) for x in parts[:6]])
    return _from_rows(np.asarray(rows), m_inscale)


def interp(x: Tensor, xp: np.ndarray, fp: np.ndarray) -> Tensor:
    """numpy/JAX ``interp`` on a tensor: piecewise linear through (xp,
    fp), clamped to the end values, with jnp.interp's arithmetic
    (fp[i-1] + (x - xp[i-1]) / dx * df)."""
    xp_t = torch.as_tensor(np.asarray(xp), dtype=x.dtype, device=x.device)
    fp_t = torch.as_tensor(np.asarray(fp), dtype=x.dtype, device=x.device)
    n = xp_t.shape[0]
    i = torch.clamp(torch.searchsorted(xp_t, x.contiguous(), right=True),
                    1, n - 1)
    df = fp_t[i] - fp_t[i - 1]
    dx = xp_t[i] - xp_t[i - 1]
    delta = x - xp_t[i - 1]
    np_dtype = np.float64 if x.dtype == torch.float64 else np.float32
    eps = np.spacing(np.finfo(np_dtype).eps)
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp_t[i - 1],
                    fp_t[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp_t[0], fp_t[0], f)
    return torch.where(x > xp_t[-1], fp_t[-1], f)


def stellar_nlyc(table: StellarTable, m: Tensor) -> Tensor:
    """Ionising photon rate per star: 10^(linear interpolation of
    logNLyC) (Nbody::UpdateStellarProperties, Nbody.cpp:186-224)."""
    return torch.pow(10.0, interp(m, table.mass, table.log_nlyc))
