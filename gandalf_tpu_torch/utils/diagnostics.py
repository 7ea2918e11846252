"""Conservation diagnostics: the port's own copy of
``gandalf_tpu/utils/diagnostics.py`` (Diagnostics<ndim> +
CalculateDiagnostics, src/Headers/Diagnostics.h:42-67 and
src/Common/SimAnalysis.hpp): energy / momentum / angular-momentum / centre
of mass accounting and the energy error (Eerror) tracked against the
initial diagnostics, computed every `ndiagstep` steps on host arrays and
appended to run_id.diag.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Diagnostics:
    Nhydro: int = 0
    Etot: float = 0.0
    ke: float = 0.0
    utot: float = 0.0
    gpe: float = 0.0
    mtot: float = 0.0
    mom: np.ndarray = None
    angmom: np.ndarray = None
    rcom: np.ndarray = None
    vcom: np.ndarray = None

    @staticmethod
    def compute(r: np.ndarray, v: np.ndarray, m: np.ndarray,
                u: Optional[np.ndarray] = None,
                gpot: Optional[np.ndarray] = None) -> "Diagnostics":
        r = np.asarray(r)
        v = np.asarray(v)
        m = np.asarray(m)
        N, ndim = r.shape
        d = Diagnostics()
        d.Nhydro = N
        d.mtot = float(m.sum())
        d.ke = float(0.5 * (m * (v ** 2).sum(-1)).sum())
        d.utot = float((m * np.asarray(u)).sum()) if u is not None else 0.0
        # gpot is the positive potential magnitude (reference convention);
        # each pair counted from both sides -> factor 1/2
        d.gpe = float(-0.5 * (m * np.asarray(gpot)).sum()) \
            if gpot is not None else 0.0
        d.Etot = d.ke + d.utot + d.gpe
        d.mom = (m[:, None] * v).sum(0)
        d.rcom = (m[:, None] * r).sum(0) / d.mtot
        d.vcom = (m[:, None] * v).sum(0) / d.mtot
        if ndim == 3:
            d.angmom = (m[:, None] * np.cross(r, v)).sum(0)
        elif ndim == 2:
            d.angmom = np.array([(m * (r[:, 0] * v[:, 1]
                                       - r[:, 1] * v[:, 0])).sum()])
        else:
            d.angmom = np.zeros(1)
        return d

    def energy_error(self, d0: "Diagnostics") -> float:
        """Eerror = |Etot - Etot0| / |Etot0| (Simulation.cpp:1652-1659)."""
        denom = abs(d0.Etot) if abs(d0.Etot) > 1e-30 else 1.0
        return abs(self.Etot - d0.Etot) / denom

    def line(self, t: float, d0: Optional["Diagnostics"] = None) -> str:
        err = self.energy_error(d0) if d0 is not None else 0.0
        mom = " ".join(f"{x:.8e}" for x in self.mom)
        return (f"{t:.8e} {self.Etot:.10e} {self.ke:.8e} {self.utot:.8e} "
                f"{self.gpe:.8e} {mom} {err:.8e}")
