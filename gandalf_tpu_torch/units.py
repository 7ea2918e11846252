"""Dimensional unit system (analogue of SimUnits, src/Common/SimUnits.cpp).

All internal maths is dimensionless with G = 1: the length and mass output
units define the base scales (outscale = 1), the time scale follows from
t = sqrt(R^3 / (G M)) (SimUnits.cpp SetupUnits), and every other quantity
is derived from (r, m, t).  `inscale` converts parameter-file inputs to
internal units; `outscale` converts internal values to output units.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

# physical constants (SI; reference src/Headers/Constants.h)
G_CONST = 6.67384e-11
M_SUN = 1.98892e30
M_JUP = 1.89813e27
M_EARTH = 5.9722e24
R_PC = 3.08567758e16
R_AU = 1.49597870e11
R_SUN = 6.955e8
MYR = 3.1556952e13
YR = 3.1556952e7
DAY = 8.64e4
K_BOLTZMANN = 1.38064852e-23
M_HYDROGEN = 1.67353284e-27
L_SUN = 3.828e26

_LENGTH = {"mpc": 1e6 * R_PC, "kpc": 1e3 * R_PC, "pc": R_PC, "au": R_AU,
           "r_sun": R_SUN, "r_earth": 6.371e6, "km": 1000.0, "m": 1.0,
           "cm": 0.01, "": 1.0}
_MASS = {"m_sun": M_SUN, "m_jup": M_JUP, "m_earth": M_EARTH,
         "kg": 1.0, "g": 1e-3, "": 1.0}
_TIME = {"gyr": 1000 * MYR, "myr": MYR, "yr": YR, "day": DAY,
         "s": 1.0, "": 1.0}
_VELOCITY = {"km_s": 1000.0, "au_yr": R_AU / YR, "m_s": 1.0,
             "cm_s": 0.01, "": 1.0}
_ACCEL = {"km_s2": 1000.0, "au_yr2": R_AU / YR ** 2, "m_s2": 1.0,
          "cm_s2": 0.01, "": 1.0}
_DENSITY = {"m_sun_pc3": M_SUN / R_PC ** 3, "kg_m3": 1.0,
            "g_cm3": 1000.0, "": 1.0}
_COLUMN = {"m_sun_pc2": M_SUN / R_PC ** 2, "kg_m2": 1.0,
           "g_cm2": 10.0, "": 1.0}
_PRESSURE = {"Pa": 1.0, "bar": 1e5, "g_cms2": 0.1, "": 1.0}
_FORCE = {"N": 1.0, "dyn": 1e-5, "": 1.0}
_ENERGY = {"J": 1.0, "erg": 1e-7, "GJ": 1e9, "1e40erg": 1e33, "": 1.0}
_MOMENTUM = {"m_sunkm_s": M_SUN * 1000.0, "m_sunau_yr": M_SUN * R_AU / YR,
             "kgm_s": 1.0, "gcm_s": 1e-5, "": 1.0}
_ANGMOM = {"m_sunkm2_s": M_SUN * 1e6, "m_sunau2_yr": M_SUN * R_AU ** 2 / YR,
           "kgm2_s": 1.0, "gcm2_s": 1e-7, "": 1.0}
_ANGVEL = {"rad_s": 1.0, "": 1.0}
_DMDT = {"m_sun_yr": M_SUN / YR, "m_sun_myr": M_SUN / MYR, "kg_s": 1.0,
         "g_s": 1e-3, "": 1.0}
_LUM = {"L_sun": L_SUN, "W": 1.0, "erg_s": 1e-7, "": 1.0}
_KAPPA = {"m2_kg": 1.0, "cm2_g": 0.1, "": 1.0}
_B = {"tesla": 1.0, "gauss": 1e-4, "": 1.0}
_Q = {"C": 1.0, "": 1.0}
_JCUR = {"C_s_m2": 1.0, "": 1.0}
_U = {"J_kg": 1.0, "erg_g": 1e-4, "": 1.0}
_DUDT = {"J_kg_s": 1.0, "erg_g_s": 1e-4, "": 1.0}
_TEMP = {"K": 1.0, "": 1.0}


@dataclasses.dataclass
class Unit:
    """One physical quantity's scaling (reference SimUnit, SimUnits.h:52)."""

    table: Dict[str, float]
    inunit: str = ""
    outunit: str = ""
    inscale: float = 1.0
    outscale: float = 1.0
    inSI: float = 1.0
    outSI: float = 1.0

    def si_unit(self, unit: str) -> float:
        if unit not in self.table:
            raise ValueError(f"Unrecognised unit: {unit!r}")
        return self.table[unit]

    def output_scale(self, unit_string: str) -> float:
        """Scale factor to output internal values in `unit_string`
        (SimUnit::OutputScale)."""
        return self.inscale * self.inSI / self.si_unit(unit_string)


class SimUnits:
    """All quantity scalings; dimensionless mode is a no-op passthrough."""

    QUANTITIES = ("r", "m", "t", "v", "a", "rho", "sigma", "press", "f",
                  "E", "mom", "angmom", "angvel", "dmdt", "L", "kappa",
                  "B", "Q", "Jcur", "u", "dudt", "temp")
    _TABLES = {"r": _LENGTH, "m": _MASS, "t": _TIME, "v": _VELOCITY,
               "a": _ACCEL, "rho": _DENSITY, "sigma": _COLUMN,
               "press": _PRESSURE, "f": _FORCE, "E": _ENERGY,
               "mom": _MOMENTUM, "angmom": _ANGMOM, "angvel": _ANGVEL,
               "dmdt": _DMDT, "L": _LUM, "kappa": _KAPPA, "B": _B,
               "Q": _Q, "Jcur": _JCUR, "u": _U, "dudt": _DUDT,
               "temp": _TEMP}

    def __init__(self) -> None:
        self.dimensionless = True
        for q in self.QUANTITIES:
            setattr(self, q, Unit(self._TABLES[q]))

    def setup_units(self, params) -> None:
        """SimUnits::SetupUnits: base scales from r/m output units, t from
        G = 1, all others derived."""
        self.dimensionless = bool(params.intparams["dimensionless"])
        if self.dimensionless:
            return
        # input units default to output units when not given
        for q in self.QUANTITIES:
            inkey, outkey = f"{q}inunit", f"{q}outunit"
            if params.stringparams.get(inkey, "") == "":
                params.stringparams[inkey] = params.stringparams[outkey]

        def wire(q):
            u: Unit = getattr(self, q)
            u.inunit = params.stringparams[f"{q}inunit"]
            u.outunit = params.stringparams[f"{q}outunit"]
            u.inSI = u.si_unit(u.inunit)
            u.outSI = u.si_unit(u.outunit)
            return u

        r = wire("r")
        r.outscale = 1.0
        r.inscale = r.outscale * r.outSI / r.inSI
        m = wire("m")
        m.outscale = 1.0
        m.inscale = m.outscale * m.outSI / m.inSI
        t = wire("t")
        t.inscale = ((r.inscale * r.inSI) ** 1.5
                     / math.sqrt(m.inscale * m.inSI * G_CONST)) / t.inSI
        t.outscale = ((r.outscale * r.outSI) ** 1.5
                      / math.sqrt(m.outscale * m.outSI * G_CONST)) / t.outSI

        R = r.outscale * r.outSI        # base scales in SI
        M = m.outscale * m.outSI
        T = t.outscale * t.outSI
        derived_si = {
            "v": R / T, "a": R / T ** 2, "rho": M / R ** 3,
            "sigma": M / R ** 2, "press": M / (R * T ** 2),
            "f": M * R / T ** 2, "E": M * R ** 2 / T ** 2,
            "mom": M * R / T, "angmom": M * R ** 2 / T, "angvel": 1.0 / T,
            "dmdt": M / T, "L": M * R ** 2 / T ** 3, "kappa": R ** 2 / M,
            "B": math.sqrt(M / (R * T ** 2)), "Q": math.sqrt(M * R),
            "Jcur": math.sqrt(M / R ** 3) / T,
            "u": R ** 2 / T ** 2, "dudt": R ** 2 / T ** 3,
            "temp": (R ** 2 / T ** 2) * M_HYDROGEN / K_BOLTZMANN,
        }
        for q, si in derived_si.items():
            u = wire(q)
            u.outscale = si / u.outSI
            u.inscale = si / u.inSI
            # convention note: outscale converts internal -> output unit:
            # value_out = value_internal * outscale
        # r/m/t handled above

    def output_scale(self, q: str) -> float:
        return 1.0 if self.dimensionless else getattr(self, q).outscale

    def input_scale(self, q: str) -> float:
        """Divide parameter-file values by this to get internal units
        (reference usage: value /= simunits.X.outscale with inscale
        handling input-unit conversion)."""
        return 1.0 if self.dimensionless else getattr(self, q).inscale


# parameter-file entries that carry units (reference: each consumer divides
# by simunits.X.outscale at ProcessParameters / IC time; here one pass)
_PARAM_UNITS = {
    "mcloud": "m", "mplummer": "m", "m1": "m", "m2": "m",
    "Minj": "m",
    "radius": "r", "rplummer": "r", "abin": "r", "rstar": "r",
    "rsmooth": "r", "r_smooth": "r", "sma": "r",
    "press1": "press", "press2": "press",
    "rhofluid1": "rho", "rhofluid2": "rho", "rho_sink": "rho",
    "rho_bary": "rho",
    "temp0": "temp", "temp_ambient": "temp", "tempmin": "temp",
    "temp_au": "temp",
    "angvel": "angvel",
    "tend": "t", "dt_snap": "t", "tsnapfirst": "t", "tsupernova": "t",
    "dt_python": None,   # wall-clock seconds, never scaled
}
_PARAM_UNITS.update({f"boxmin[{k}]": "r" for k in range(3)})
_PARAM_UNITS.update({f"boxmax[{k}]": "r" for k in range(3)})
_PARAM_UNITS.update({f"vfluid1[{k}]": "v" for k in range(3)})
_PARAM_UNITS.update({f"vfluid2[{k}]": "v" for k in range(3)})


def inscale_parameters(params, units: "SimUnits") -> None:
    """Convert unit-carrying parameter values to internal (G = 1) units
    in place (the reference divides each value by simunits.X.outscale at
    its point of use; one coherent pass keeps box/IC/sink values
    consistent).  No-op in dimensionless mode or when already applied."""
    if units.dimensionless:
        return
    if params.intparams.get("_inscaled", 0):
        return
    for key, q in _PARAM_UNITS.items():
        if q is None or key not in params.floatparams:
            continue
        params.floatparams[key] = (params.floatparams[key]
                                   / units.input_scale(q))
    params.intparams["_inscaled"] = 1
