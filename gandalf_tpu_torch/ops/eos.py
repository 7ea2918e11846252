"""Equation of state: the adiabatic (`energy_eqn`), isothermal,
barotropic, polytropic and radws EOS.

Counterpart of ``gandalf_tpu/ops/eos.py`` (``EOS``, ``Adiabatic``,
``Isothermal``, ``Barotropic``, ``Polytropic``, ``Radws``,
``IonisingRadiationEOS``, ``MCRadiationEOS``, ``eos_factory``) for the
EOS of the ported slices.  Pressure is
(gamma-1)*rho*u (K*rho^eta for the polytrope); the adiabatic sound speed
is sqrt(gamma*(gamma-1)*u), the others' sqrt((gamma-1)*u), all
elementwise torch.  The radws EOS reads gamma from its opacity table at
the nearest (rho, T(u)) entry through ``ops/radws.py:radws_eos`` (K27 on
CUDA tensors).  With a radiation scheme (ionisation, treeray,
monoionisation) the factory wraps every EOS but radws in the ionisation
blend, whose ``thermal_update`` takes the particles' ``ionfrac``
(``needs_ionfrac``); every EOS's ``thermal_update`` accepts the keyword.
The locally isothermal family (it reads the star positions, which the
JAX package's grid passes do not give its EOS: fault F20) raises
NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from .radws import make_ideal_table, radws_eos, read_opacity_table

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EOS:
    """Base EOS: perfect-gas relations parameterised by gamma."""

    gamma: float
    mu_bar: float = 1.0

    # the radiation wrappers blend the base state with the ionisation
    # fraction; the passes hand `ionfrac` to thermal_update where it is set
    needs_ionfrac = False

    @property
    def gammam1(self) -> float:
        return self.gamma - 1.0

    def specific_internal_energy(self, rho: Tensor, u: Tensor) -> Tensor:
        raise NotImplementedError

    def pressure(self, rho: Tensor, u: Tensor) -> Tensor:
        return self.gammam1 * rho * u

    def sound_speed(self, rho: Tensor, u: Tensor) -> Tensor:
        raise NotImplementedError

    def thermal_update(self, rho: Tensor, u: Tensor, ionfrac=None):
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


@dataclasses.dataclass(frozen=True)
class Isothermal(EOS):
    """Fixed temperature: u = temp0/(gamma-1)/mu_bar, c = sqrt((gamma-1) u)."""

    temp0: float = 1.0

    def specific_internal_energy(self, rho, u):
        return torch.full_like(rho, self.temp0 / self.gammam1 / self.mu_bar)

    def sound_speed(self, rho, u):
        return torch.sqrt(self.gammam1 * u)


@dataclasses.dataclass(frozen=True)
class Barotropic(EOS):
    """Barotropic EOS (src/Thermal/BarotropicEOS.cpp): isothermal at low
    density, adiabatic above rho_bary."""

    temp0: float = 1.0
    rho_bary: float = 1.0e-14

    def specific_internal_energy(self, rho, u):
        return (self.temp0 * (1.0 + (rho / self.rho_bary) ** self.gammam1)
                / self.gammam1 / self.mu_bar)

    def sound_speed(self, rho, u):
        return torch.sqrt(self.gammam1 * u)


@dataclasses.dataclass(frozen=True)
class Polytropic(EOS):
    """P = K rho^eta (src/Thermal/PolytropicEOS.cpp)."""

    Kpoly: float = 1.0
    eta: float = 1.4

    def specific_internal_energy(self, rho, u):
        return self.Kpoly * rho ** (self.eta - 1.0) / self.gammam1

    def pressure(self, rho, u):
        return self.Kpoly * rho ** self.eta

    def sound_speed(self, rho, u):
        return torch.sqrt(self.gammam1 * u)


@dataclasses.dataclass(frozen=True, eq=False)
class Radws(EOS):
    """Opacity-table EOS with variable gamma (src/Thermal/RadwsEOS.cpp):
    P = (gamma(rho,T) - 1) rho u, c = sqrt(gamma (gamma-1) u), u kept."""

    table: object = None

    def specific_internal_energy(self, rho, u):
        return u

    def pressure(self, rho, u):
        return radws_eos(self.table, rho, u)[0]

    def sound_speed(self, rho, u):
        return radws_eos(self.table, rho, u)[1]

    def thermal_update(self, rho, u, ionfrac=None):
        p, c = radws_eos(self.table, rho, u)
        return u, p, c


@dataclasses.dataclass(frozen=True, eq=False)
class IonisingRadiationEOS(EOS):
    """The photoionised-gas wrapper (IonisingRadiation,
    src/Thermal/IonisingRadiationEOS.cpp:96-121): an ionised particle
    (ionfrac > 0.5) keeps its u where it exceeds the base EOS's, so an
    isothermal base does not reset the HII region's temperature."""

    base: object = None
    needs_ionfrac = True

    def thermal_update(self, rho, u, ionfrac=None):
        u_b, p_b, c_b = self.base.thermal_update(rho, u)
        if ionfrac is None:
            return u_b, p_b, c_b
        u_new = torch.where(ionfrac > 0.5, torch.maximum(u, u_b), u_b)
        return (u_new, self.base.pressure(rho, u_new),
                self.base.sound_speed(rho, u_new))

    def specific_internal_energy(self, rho, u):
        return self.base.specific_internal_energy(rho, u)

    def sound_speed(self, rho, u):
        return self.base.sound_speed(rho, u)


@dataclasses.dataclass(frozen=True, eq=False)
class MCRadiationEOS(EOS):
    """The ionisation-fraction blend (MCRadiationEOS,
    src/Thermal/MCRadiationEOS.cpp): u = f u_ion + (1 - f) u_base with
    u_ion = temp_ion / (gamma - 1) / mu_ion."""

    base: object = None
    temp_ion: float = 1.0e4
    mu_ion: float = 0.678
    needs_ionfrac = True

    def thermal_update(self, rho, u, ionfrac=None):
        u_b, p_b, c_b = self.base.thermal_update(rho, u)
        if ionfrac is None:
            return u_b, p_b, c_b
        u_ion = self.temp_ion / self.gammam1 / self.mu_ion
        u_new = ionfrac * u_ion + (1.0 - ionfrac) * u_b
        return (u_new, self.base.pressure(rho, u_new),
                self.base.sound_speed(rho, u_new))

    def specific_internal_energy(self, rho, u):
        return self.base.specific_internal_energy(rho, u)

    def sound_speed(self, rho, u):
        return self.base.sound_speed(rho, u)


# the radiation schemes, and the EOS their wrapper blends
# (gandalf_tpu/ops/eos.py:281-299; Hydrodynamics.cpp:81-90)
RADIATION_SCHEMES = ("ionisation", "monoionisation", "treeray")
_WRAPPED = ("energy_eqn", "constant_temp", "isothermal", "polytropic",
            "barotropic", "barotropic2")


def eos_factory(params, device="cpu", dtype=torch.float64) -> EOS:
    """Build the EOS named by `gas_eos`: `energy_eqn` (and its alias
    `constant_temp`), `isothermal`, `barotropic`, `polytropic` and
    `radws`, whose opacity table (`radws_table`, the reference's text
    format) is read onto `device` in `dtype`; when the file is missing,
    a warning, and the synthetic ideal-gas, constant-opacity table at
    gamma_eos, mu_bar and temp_ambient.  With a radiation scheme every
    one but radws comes wrapped: IonisingRadiationEOS for ionisation and
    treeray, MCRadiationEOS for monoionisation."""
    name = params.stringparams["gas_eos"]
    fp = params.floatparams
    gamma, mu_bar = fp["gamma_eos"], fp["mu_bar"]
    radiation = params.stringparams["radiation"]
    if radiation in RADIATION_SCHEMES and name in _WRAPPED:
        base = _base_eos(params, name, gamma, mu_bar, device, dtype)
        if radiation == "monoionisation":
            return MCRadiationEOS(gamma=gamma, mu_bar=mu_bar, base=base,
                                  temp_ion=fp["temp_ion"],
                                  mu_ion=fp["mu_ion"])
        return IonisingRadiationEOS(gamma=gamma, mu_bar=mu_bar, base=base)
    return _base_eos(params, name, gamma, mu_bar, device, dtype)


def _base_eos(params, name, gamma, mu_bar, device, dtype) -> EOS:
    fp = params.floatparams
    if name in ("energy_eqn", "constant_temp"):
        return Adiabatic(gamma=gamma, mu_bar=mu_bar)
    if name == "radws":
        path = params.stringparams["radws_table"]
        temp_amb = fp["temp_ambient"]
        kw = dict(temp_ambient=temp_amb, device=device, dtype=dtype)
        if os.path.exists(path):
            table = read_opacity_table(path, **kw)
        else:
            print(f"WARNING: radws_table {path!r} not found; using a "
                  "synthetic ideal-gas/constant-opacity table")
            table = make_ideal_table(gamma=gamma, mu_bar=mu_bar, **kw)
        return Radws(gamma=gamma, mu_bar=mu_bar, table=table)
    if name == "isothermal":
        return Isothermal(gamma=gamma, mu_bar=mu_bar, temp0=fp["temp0"])
    if name == "barotropic":
        return Barotropic(gamma=gamma, mu_bar=mu_bar, temp0=fp["temp0"],
                          rho_bary=fp["rho_bary"])
    if name == "polytropic":
        return Polytropic(gamma=gamma, mu_bar=mu_bar, Kpoly=fp["Kpoly"],
                          eta=fp["eta_eos"])
    if name in ("locally_isothermal", "local_isothermal",
                "disc_locally_isothermal"):
        # their temperature reads the particle positions, which the JAX
        # package's grid passes do not hand to thermal_update
        # (gandalf_tpu/ops/sph_grid27.py:777-778, :836; ops/eos.py:143-145)
        raise NotImplementedError(
            f"gas_eos {name!r} is not ported yet: the JAX package runs the "
            "locally isothermal family only on its all-pairs path (fault "
            "F20; ROADMAP queue 1, item 9)")
    raise NotImplementedError(
        f"gas_eos {name!r} is not ported yet (ROADMAP queue 1, item 9)")
