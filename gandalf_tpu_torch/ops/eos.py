"""Equation of state: the adiabatic (`energy_eqn`) EOS.

Counterpart of ``gandalf_tpu/ops/eos.py`` (``EOS``, ``Adiabatic``,
``eos_factory``) for the one EOS of the ported slice.  Pressure is
(gamma-1)*rho*u and the sound speed sqrt(gamma*(gamma-1)*u).
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EOS:
    """Base EOS: perfect-gas relations parameterised by gamma."""

    gamma: float
    mu_bar: float = 1.0

    @property
    def gammam1(self) -> float:
        return self.gamma - 1.0

    def specific_internal_energy(self, rho: Tensor, u: Tensor) -> Tensor:
        raise NotImplementedError

    def pressure(self, rho: Tensor, u: Tensor) -> Tensor:
        return self.gammam1 * rho * u

    def sound_speed(self, rho: Tensor, u: Tensor) -> Tensor:
        raise NotImplementedError

    def thermal_update(self, rho: Tensor, u: Tensor):
        """Return (u, pressure, sound) after a density update."""
        u_new = self.specific_internal_energy(rho, u)
        return u_new, self.pressure(rho, u_new), self.sound_speed(rho, u_new)


@dataclasses.dataclass(frozen=True)
class Adiabatic(EOS):
    """'energy_eqn': u evolves; c = sqrt(gamma*(gamma-1)*u)."""

    def specific_internal_energy(self, rho, u):
        return u

    def sound_speed(self, rho, u):
        return torch.sqrt(self.gamma * self.gammam1 * u)


def eos_factory(params) -> EOS:
    """Build the EOS named by `gas_eos`; only `energy_eqn` (and its alias
    `constant_temp`) without a radiation wrapper is ported."""
    name = params.stringparams["gas_eos"]
    if params.stringparams["radiation"] not in ("none", "null", ""):
        raise NotImplementedError(
            "radiation EOS wrappers are not ported yet (ROADMAP queue 1, "
            "item 12)")
    if name in ("energy_eqn", "constant_temp"):
        return Adiabatic(gamma=params.floatparams["gamma_eos"],
                         mu_bar=params.floatparams["mu_bar"])
    raise NotImplementedError(
        f"gas_eos {name!r} is not ported yet (ROADMAP queue 1, item 9)")
