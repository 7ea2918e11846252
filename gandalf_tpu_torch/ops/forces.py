"""Artificial dissipation configuration for the SPH pair forces.

Counterpart of the head of ``gandalf_tpu/ops/forces.py``: the
``AVISC_*``/``ACOND_*`` codes and ``ArtificialViscosity``.  The pair
forces themselves are K3 in ``ops/sph_grid27.py``.
"""

from __future__ import annotations

import dataclasses

AVISC_NONE = 0
AVISC_MON97 = 1
AVISC_MON97MM97 = 2      # time-dependent alpha (Morris & Monaghan 97)
ACOND_NONE = 0
ACOND_WADSLEY2008 = 1
ACOND_PRICE2008 = 2

_AVISC_CODES = {"none": AVISC_NONE, "mon97": AVISC_MON97,
                "mon97mm97": AVISC_MON97MM97, "mon97cd2010": AVISC_MON97MM97}
_ACOND_CODES = {"none": ACOND_NONE, "wadsley2008": ACOND_WADSLEY2008,
                "price2008": ACOND_PRICE2008}


@dataclasses.dataclass(frozen=True)
class ArtificialViscosity:
    """Static dissipation configuration."""

    avisc: int = AVISC_MON97
    acond: int = ACOND_NONE
    alpha_visc: float = 1.0
    alpha_visc_min: float = 0.1
    beta_visc: float = 2.0

    @staticmethod
    def from_params(params) -> "ArtificialViscosity":
        avisc = params.stringparams["avisc"]
        # avisc = mon97 with time_dependent_avisc = mm97/cd2010 is the
        # time-dependent scheme
        if (avisc == "mon97"
                and params.stringparams["time_dependent_avisc"] != "none"):
            avisc = "mon97mm97"
        return ArtificialViscosity(
            avisc=_AVISC_CODES[avisc],
            acond=_ACOND_CODES[params.stringparams["acond"]],
            alpha_visc=params.floatparams["alpha_visc"],
            alpha_visc_min=params.floatparams["alpha_visc_min"],
            beta_visc=params.floatparams["beta_visc"],
        )
