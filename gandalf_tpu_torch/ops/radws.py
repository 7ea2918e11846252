"""RadWS radiative cooling and heating (Stamatellos et al. 2007): the
opacity table, the table EOS's lookup, the equilibrium finder and the
implicit heating rate.

Counterpart of ``gandalf_tpu/ops/radws.py``.  Every particle relaxes
exponentially toward a local radiative-equilibrium energy,

  u(t + dt) = ueq + (u0 - ueq) exp(-dt / dt_therm),

with ueq and dt_therm from the energy balance

  f(T) = dudt - 4 sigma (T^4 - T_amb^4) / (col2 kappa(T) + 1/kappa_p(T))

over the tabulated opacities.  Every table lookup is a nearest-index
gather (``_closest_index``, searchsorted and the nearer neighbour),
and u -> T counts the entries of the density's energy row below u, as
the JAX package does: on a row that is not monotone a binary search
would pick another index.

Three functions launch a kernel of ``csrc/radws.cu`` on CUDA tensors and
run their plain PyTorch version (``*_plain``, the JAX arithmetic step by
step) on CPU tensors:

- ``radws_eos`` (K27): gamma(rho, T(u)) of ``Radws._gamma_of``
  (``gandalf_tpu/ops/eos.py:199``), then P = (gamma-1) rho u and
  c = sqrt(gamma (gamma-1) u), on any shape;
- ``energy_find_equi`` (K28): the 30-step log-T bisection for
  (ueq, dt_therm) with col2 = fcol2 max(gpot, 0) rho fused in;
- ``radws_implicit_heating`` (K29): the 40-step bisection of the
  implicit update for the MFV energy, col2 fused in likewise.

Each takes ``index`` to also return the table indices its results were
read at (int32, see the kernels' sources), for the flip counts of the
comparisons.  ``radws_energy_integration`` and ``radws_col2`` are
elementwise torch.  The table is ``OpacityTable``: its arrays are tensors
on the run's device and in its dtype, its scalars Python floats.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _ext

Tensor = torch.Tensor

RAD_CONST_CGS = 5.670374419e-5     # Stefan-Boltzmann [erg cm^-2 s^-1 K^-4]
FIND_ITER = 30                     # energy_find_equi's bisection steps
IMPLICIT_ITER = 40                 # radws_implicit_heating's
# elements per chunk of the plain u -> T count (rows of nt entries)
_CHUNK = 1 << 15


@dataclasses.dataclass(frozen=True)
class OpacityTable:
    log_dens: Tensor     # (nd,) log10 rho grid
    log_temp: Tensor     # (nt,) log10 T grid
    energy: Tensor       # (nd, nt) specific internal energy u(rho, T)
    mu: Tensor           # (nd, nt) mean molecular weight
    kappa: Tensor        # (nd, nt)
    kappap: Tensor       # (nd, nt) Planck mean
    gamma: Tensor        # (nd, nt)
    fcol2: float         # column-density metric factor
    rad_const: float     # Stefan-Boltzmann in code units
    temp_min: float
    temp_ambient: float

    ARRAYS = ("log_dens", "log_temp", "energy", "mu", "kappa", "kappap",
              "gamma")


def _table(arrays: dict, device, dtype, **scalars) -> OpacityTable:
    return OpacityTable(**{k: torch.as_tensor(np.ascontiguousarray(v),
                                              dtype=dtype, device=device)
                           for k, v in arrays.items()},
                        **{k: float(v) for k, v in scalars.items()})


def read_opacity_table(path: str, u_scale: float = 1.0,
                       kappa_scale: float = 1.0,
                       rad_const: float = RAD_CONST_CGS,
                       temp_ambient: float = 10.0, temp_min: float = 5.0,
                       lombardi: bool = False, device="cpu",
                       dtype=torch.float64) -> OpacityTable:
    """Parse the reference's 9-column text format (dens temp energy mu
    kappa kappar kappap gamma gamma1, density-major, after a header line
    "ndens ntemp fcol"; lines starting with # skipped)."""
    rows = []
    header = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if header is None:
                header = line.split()
                continue
            vals = line.split()
            if len(vals) >= 9:
                rows.append([float(x) for x in vals[:9]])
    ndens, ntemp, fcol = int(header[0]), int(header[1]), float(header[2])
    arr = np.asarray(rows).reshape(ndens, ntemp, 9)
    fcol2 = fcol * fcol if lombardi else fcol * fcol * 4.0 * np.pi
    return _table({"log_dens": np.log10(arr[:, 0, 0]),
                   "log_temp": np.log10(arr[0, :, 1]),
                   "energy": arr[:, :, 2] / u_scale, "mu": arr[:, :, 3],
                   "kappa": arr[:, :, 4] / kappa_scale,
                   "kappap": arr[:, :, 6] / kappa_scale,
                   "gamma": arr[:, :, 7]}, device, dtype, fcol2=fcol2,
                  rad_const=rad_const, temp_min=temp_min,
                  temp_ambient=temp_ambient)


def make_ideal_table(ndens: int = 8, ntemp: int = 128,
                     gamma: float = 5.0 / 3.0, mu_bar: float = 1.0,
                     kappa0: float = 1.0, rad_const: float = 1.0,
                     temp_ambient: float = 10.0, temp_min: float = 1.0,
                     fcol: float = 1.0, logrho_range=(-8.0, 2.0),
                     logtemp_range=(0.0, 5.0), device="cpu",
                     dtype=torch.float64) -> OpacityTable:
    """Synthetic table: ideal gas u = T/((gamma-1) mu), constant opacity
    (no physical table ships with the repository)."""
    ld = np.linspace(*logrho_range, ndens)
    lt = np.linspace(*logtemp_range, ntemp)
    T = 10.0 ** lt
    u = T / ((gamma - 1.0) * mu_bar)
    full = np.full((ndens, ntemp), 1.0)
    return _table({"log_dens": ld, "log_temp": lt,
                   "energy": np.broadcast_to(u, (ndens, ntemp)).copy(),
                   "mu": full * mu_bar, "kappa": full * kappa0,
                   "kappap": full * kappa0, "gamma": full * gamma},
                  device, dtype, fcol2=fcol * fcol * 4.0 * np.pi,
                  rad_const=rad_const, temp_min=temp_min,
                  temp_ambient=temp_ambient)


# -- the lookups --------------------------------------------------------------
def _closest_index(grid: Tensor, x: Tensor) -> Tensor:
    """Nearest grid index (OpacityTable::getClosestIndex): searchsorted
    (left), clipped to [1, n-1], and the upper neighbour only where it is
    strictly nearer."""
    hi = torch.searchsorted(grid, x.contiguous())
    hi = torch.clamp(hi, 1, grid.shape[0] - 1)
    lo = hi - 1
    pick_hi = (x - grid[lo]) > (grid[hi] - x)
    return torch.where(pick_hi, hi, lo)


def idens_of(table: OpacityTable, rho: Tensor) -> Tensor:
    return _closest_index(table.log_dens,
                          torch.log10(torch.clamp_min(rho, 1e-30)))


def itemp_of(table: OpacityTable, temp: Tensor) -> Tensor:
    return _closest_index(table.log_temp,
                          torch.log10(torch.clamp_min(temp, 1e-30)))


def _temp_index(table: OpacityTable, idens: Tensor, u: Tensor) -> Tensor:
    """The nearest entry of u in each density's energy row: the count of
    the row's entries below u, clipped to [1, nt-1], and the nearer of
    it and the entry before (chunked over elements)."""
    nt = table.log_temp.shape[0]
    flat_i, flat_u = idens.reshape(-1), u.reshape(-1)
    out = []
    for c0 in range(0, flat_u.numel(), _CHUNK):
        rows = table.energy[flat_i[c0:c0 + _CHUNK]]
        uc = flat_u[c0:c0 + _CHUNK]
        it = torch.sum(rows < uc[:, None], dim=-1)
        it = torch.clamp(it, 1, nt - 1)
        lo = it - 1
        u_lo = torch.gather(rows, 1, lo[:, None])[:, 0]
        u_hi = torch.gather(rows, 1, it[:, None])[:, 0]
        out.append(torch.where((uc - u_lo) > (u_hi - uc), it, lo))
    if not out:
        return torch.zeros_like(idens)
    return torch.cat(out).reshape(u.shape)


def temp_from_u(table: OpacityTable, rho: Tensor, u: Tensor) -> Tensor:
    """The tabulated temperature nearest to u at rho (GetIEner + eos_temp;
    any shape)."""
    ii = _temp_index(table, idens_of(table, rho), u)
    return 10.0 ** table.log_temp[ii]


def u_of_temp(table: OpacityTable, rho: Tensor, temp: Tensor) -> Tensor:
    """Tabulated u(rho, T) (OpacityTable::GetEnergy)."""
    return table.energy[idens_of(table, rho), itemp_of(table, temp)]


def _pow4(x: Tensor) -> Tensor:
    """x^4 as (x x)(x x), the JAX package's integer power."""
    x2 = x * x
    return x2 * x2


def _ebalance(table: OpacityTable, dudt, temp_ex4, temp, kappa, kappap,
              col2):
    """Radiative heating/cooling rate (EnergyRadws.cpp:709-718), with
    T_amb^4 given."""
    return dudt - 4.0 * table.rad_const * (_pow4(temp) - temp_ex4) \
        / (col2 * kappa + 1.0 / kappap)


def radws_col2(table: OpacityTable, rho: Tensor, gpot: Tensor) -> Tensor:
    """Column-density-squared metric, RadWS variant: fcol2 gpot rho
    (EnergyRadws::GetCol2; gpot is the positive smoothed potential)."""
    return table.fcol2 * gpot * rho


def radws_energy_integration(u0: Tensor, ueq: Tensor, dt_therm: Tensor,
                             dt) -> Tensor:
    """Exponential relaxation toward equilibrium over dt (a scalar or per
    particle; EnergyRadws::EnergyIntegration)."""
    x = dt / torch.clamp_min(dt_therm, 1e-30)
    decay = torch.exp(-torch.clamp_max(x, 40.0))
    u = u0 * decay + ueq * (1.0 - decay)
    u = torch.where(x >= 40.0, ueq, u)
    return torch.where(dt_therm <= 1e-30, u0, u)


def _amb(table: OpacityTable, temp_amb, like: Tensor) -> Tensor:
    """The ambient temperature as a tensor of `like`'s dtype: the table's
    by default, else the scalar or per-particle field given."""
    if temp_amb is None:
        temp_amb = table.temp_ambient
    return torch.as_tensor(temp_amb, dtype=like.dtype, device=like.device)


def _check_table(table: OpacityTable, x: Tensor) -> None:
    if table.log_dens.shape[0] < 2 or table.log_temp.shape[0] < 2:
        raise ValueError("an opacity table needs at least 2 densities "
                         "and 2 temperatures")
    if table.energy.dtype != x.dtype or table.energy.device != x.device:
        raise ValueError(f"the opacity table lies on {table.energy.device} "
                         f"in {table.energy.dtype}, the inputs on "
                         f"{x.device} in {x.dtype}")


# -- K27: the table EOS -------------------------------------------------------
def radws_eos(table: OpacityTable, rho: Tensor, u: Tensor,
              index: bool = False):
    """(P, c) of the radws EOS at (rho, u) of any common shape: gamma at
    the nearest (rho, T(u)) entry, P = (gamma-1) rho u, c = sqrt(gamma
    (gamma-1) u); with `index` also the int32 index idens nt + itemp of
    the gamma read.  K27 on CUDA tensors."""
    _check_table(table, rho)
    if rho.is_cuda:
        out = _ext.radws_eos(table, rho.reshape(-1).contiguous(),
                             u.reshape(-1).contiguous(), index)
        return tuple(x.reshape(rho.shape) for x in out)
    return radws_eos_plain(table, rho, u, index)


def radws_eos_plain(table: OpacityTable, rho: Tensor, u: Tensor,
                    index: bool = False):
    """Plain version of K27: the JAX package's Radws._gamma_of and
    thermal_update."""
    idens = idens_of(table, rho)
    temp = 10.0 ** table.log_temp[_temp_index(table, idens, u)]
    it = itemp_of(table, temp)
    g = table.gamma[idens, it]
    out = ((g - 1.0) * rho * u, torch.sqrt(g * (g - 1.0) * u))
    if index:
        nt = table.log_temp.shape[0]
        out += ((idens * nt + it).to(torch.int32),)
    return out


# -- K28: the equilibrium finder ----------------------------------------------
def energy_find_equi(table: OpacityTable, rho: Tensor, u: Tensor,
                     dudt: Tensor, gpot: Tensor, temp_amb=None,
                     index: bool = False):
    """(ueq, dt_therm) per particle (EnergyFindEqui, EnergyRadws.cpp:
    340-700) with col2 = radws_col2(rho, max(gpot, 0)); `temp_amb` is
    the table's ambient temperature by default, else a scalar or a
    per-particle field (radiative feedback).  With `index` also the int32
    index ((idens nt + it_eq) nt + it_now) 3 + branch of the two
    temperature reads (branch 0 the root, 1 T_min, 2 the top).  K28 on
    CUDA tensors."""
    _check_table(table, rho)
    tamb = _amb(table, temp_amb, rho)
    if rho.is_cuda:
        return _ext.radws_equilibrium(table, rho, u, dudt, gpot, tamb,
                                      index)
    return energy_find_equi_plain(table, rho, u, dudt, gpot, tamb, index)


def energy_find_equi_plain(table: OpacityTable, rho, u, dudt, gpot,
                           temp_amb, index: bool = False,
                           n_iter: int = FIND_ITER):
    """Plain version of K28: gandalf_tpu/ops/radws.py:energy_find_equi
    step by step after radws_col2.  f is decreasing in T: the bisection
    keeps the upper half where f(mid) > 0; net cooling at T_min clamps to
    T_min, net heating at the table's top to the top; ueq is the energy
    entry at the nearest index of T_eq."""
    col2 = radws_col2(table, rho, torch.clamp_min(gpot, 0.0))
    idens = idens_of(table, rho)
    temp = 10.0 ** table.log_temp[_temp_index(table, idens, u)]
    tamb4 = _pow4(temp_amb)

    def f_of(T):
        it = itemp_of(table, T)
        return _ebalance(table, dudt, tamb4, T, table.kappa[idens, it],
                         table.kappap[idens, it], col2)

    t_lo = torch.full_like(rho, table.temp_min)
    t_hi = (10.0 ** table.log_temp[-1]).expand(rho.shape)
    f_lo, f_hi = f_of(t_lo), f_of(t_hi)
    lo, hi = torch.log10(t_lo), torch.log10(t_hi)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        take_lo = f_of(10.0 ** mid) > 0.0
        lo = torch.where(take_lo, mid, lo)
        hi = torch.where(take_lo, hi, mid)
    tequi = 10.0 ** (0.5 * (lo + hi))
    at_lo, at_hi = f_lo <= 0.0, f_hi >= 0.0
    tequi = torch.where(at_lo, t_lo, torch.where(at_hi, t_hi, tequi))
    it_eq = itemp_of(table, tequi)
    ueq = table.energy[idens, it_eq]
    # the radiative rate at the current temperature
    it_now = itemp_of(table, temp)
    dudt_rad = _ebalance(table, 0.0, tamb4, temp, table.kappa[idens, it_now],
                         table.kappap[idens, it_now], col2)
    denom = dudt + dudt_rad
    dt_therm = torch.where(
        torch.abs(denom) > 1e-30,
        (ueq - u) / torch.where(denom == 0, 1.0, denom), 1e30)
    dt_therm = torch.where(dt_therm < 0.0, 1e30, dt_therm)
    if index:
        nt = table.log_temp.shape[0]
        branch = torch.where(at_lo, 1, torch.where(at_hi, 2, 0))
        return ueq, dt_therm, (((idens * nt + it_eq) * nt + it_now) * 3
                               + branch).to(torch.int32)
    return ueq, dt_therm


# -- K29: the implicit heating rate -------------------------------------------
def radws_implicit_heating(table: OpacityTable, rho: Tensor, u: Tensor,
                           dudt: Tensor, gpot: Tensor, dt, temp_amb=None,
                           index: bool = False):
    """The implicit radiative heating rate of the MFV energy update
    (EnergyRadws::ImplicitEnergyUpdate, EnergyRadws.cpp:546-640) with
    col2 = radws_col2(rho, max(gpot, 0)): the root of g(T) = T/(mu
    (gamma-1)) - u - dt ebalance(T) on the tabulated range, and the rate
    there (the edge rates where g keeps its sign).  `dt` is a scalar or
    per particle.  With `index` also the int32 index (idens nt + it) 3 +
    branch of the rate's read (branch 0 the root, 1 T_min, 2 the top).
    K29 on CUDA tensors."""
    _check_table(table, rho)
    tamb = _amb(table, temp_amb, rho)
    dt = torch.as_tensor(dt, dtype=rho.dtype, device=rho.device)
    if rho.is_cuda:
        return _ext.radws_implicit_heating(table, rho, u, dudt, gpot, dt,
                                           tamb, index)
    return radws_implicit_heating_plain(table, rho, u, dudt, gpot, dt, tamb,
                                        index)


def radws_implicit_heating_plain(table: OpacityTable, rho, u, dudt, gpot,
                                 dt, temp_amb, index: bool = False,
                                 n_iter: int = IMPLICIT_ITER):
    """Plain version of K29: gandalf_tpu/ops/radws.py:
    radws_implicit_heating step by step after radws_col2; g is
    increasing in T and the bisection keeps the upper half where
    g(mid) < 0."""
    col2 = radws_col2(table, rho, torch.clamp_min(gpot, 0.0))
    idens = idens_of(table, rho)
    tamb4 = _pow4(temp_amb)

    def g_of(T):
        it = itemp_of(table, T)
        heat = _ebalance(table, dudt, tamb4, T, table.kappa[idens, it],
                         table.kappap[idens, it], col2)
        u_T = T / (table.mu[idens, it] * (table.gamma[idens, it] - 1.0))
        return u_T - u - dt * heat, heat, it

    t_lo = torch.full_like(rho, table.temp_min)
    t_hi = (10.0 ** table.log_temp[-1]).expand(rho.shape)
    g_lo, h_lo, it_lo = g_of(t_lo)
    g_hi, h_hi, it_hi = g_of(t_hi)
    lo, hi = torch.log10(t_lo), torch.log10(t_hi)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        take_hi = g_of(10.0 ** mid)[0] < 0.0
        lo = torch.where(take_hi, mid, lo)
        hi = torch.where(take_hi, hi, mid)
    _, heat, it = g_of(10.0 ** (0.5 * (lo + hi)))
    at_lo, at_hi = g_lo >= 0.0, g_hi <= 0.0
    heat = torch.where(at_lo, h_lo, torch.where(at_hi, h_hi, heat))
    if index:
        nt = table.log_temp.shape[0]
        it = torch.where(at_lo, it_lo, torch.where(at_hi, it_hi, it))
        branch = torch.where(at_lo, 1, torch.where(at_hi, 2, 0))
        return heat, ((idens * nt + it) * 3 + branch).to(torch.int32)
    return heat

