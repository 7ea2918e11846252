"""Carry state and grid plans across from the JAX package.

``state_from_numpy`` turns a dict of numpy arrays (the JAX ``SphState``'s
fields, read out with ``np.asarray``) into the port's ``SphState`` on a
given device and float dtype; ``state_to_numpy`` goes back.
``mfv_state_from_jax`` does the same for a JAX ``MfvState`` (its
block-timestep fields included; ``mfv_state_to_numpy`` goes back), and
``nbody_state_from_jax`` for a JAX ``NbodyState`` (``nbody_state_to_numpy``
goes back).
``sinks_from_jax`` copies a JAX ``SinkState`` into the port's.
``grid_spec_from_jax`` and ``tree_spec_from_jax`` copy a frozen JAX
``Grid27Spec`` or ``TreeSpec`` field for field (the TreeSpec's MAC and
fast-multipole fields included); ``ewald_table_from_jax`` copies a JAX
``EwaldTable`` into the port's (float64 numpy arrays and the same
metadata), ``opacity_table_from_jax`` a JAX RadWS ``OpacityTable`` into
the port's (tensors on a device in a dtype, Python float scalars),
``stellar_table_from_jax`` a JAX ``StellarTable`` and
``mc_draws_from_numpy`` the Monte-Carlo packets' draws (source index,
direction) of each iteration, made with jax.random and read out as
numpy, into what ``ops/mcrt.py`` takes;
``schedule_from_jax``
copies a JAX ``BlockSchedule`` and ``schedule_to_jax`` gives a port
schedule's fields as numpy arrays in the JAX package's types (for
``BlockSchedule(**{k: jnp.asarray(v) ...})``).  Nothing here imports
JAX: the JAX objects are read through their attributes only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .integrate.block import BlockSchedule
from .ops.ewald import EwaldTable
from .ops.radws import OpacityTable
from .ops.sinks import SinkState
from .ops.sph_grid27 import Grid27Spec
from .ops.stellar import StellarTable
from .ops.tree import TreeSpec
from .state import MfvState, NbodyState, SphState

_OPTIONAL = ("bucket_map", "walk_mp", "walk_near", "walk_plan_r",
             "walk_anchors", "walk_margin", "sinks")


def state_from_numpy(fields: Dict[str, np.ndarray], device="cpu",
                     dtype=torch.float64) -> SphState:
    """SphState from per-field numpy arrays: floating fields take `dtype`,
    integer and bool fields keep their kind."""
    kw = {}
    for f in dataclasses.fields(SphState):
        x = fields.get(f.name)
        if x is None:
            if f.name not in _OPTIONAL:
                raise KeyError(f"missing SphState field {f.name!r}")
            kw[f.name] = None
            continue
        # copies: arrays read out of JAX are read-only views
        x = np.array(x)
        if x.dtype.kind == "f":
            kw[f.name] = torch.tensor(x, dtype=dtype, device=device)
        else:
            kw[f.name] = torch.tensor(x, device=device)
    kw["nstep"] = kw["nstep"].to(torch.int64)
    return SphState(**kw)


def state_to_numpy(state: SphState) -> Dict[str, np.ndarray]:
    """Every non-None tensor field as a host numpy array (the sinks stay
    out)."""
    out = {}
    for f in dataclasses.fields(SphState):
        x = getattr(state, f.name)
        if isinstance(x, torch.Tensor):
            out[f.name] = x.detach().cpu().numpy()
    return out


def sinks_from_jax(sinks, device="cpu", dtype=torch.float64) -> SinkState:
    """The port's SinkState from a JAX one (read through its
    attributes), the smooth-accretion spin ledger `angmom` and the
    accretion rate `mdot` included (zeros where the JAX state leaves
    them None): floating fields take `dtype`, `active` stays bool."""
    kw = {}
    n = np.asarray(sinks.m).shape[0]
    empty = {"angmom": np.zeros((n, 3)), "mdot": np.zeros(n)}
    for f in dataclasses.fields(SinkState):
        x = getattr(sinks, f.name)
        x = np.array(empty[f.name] if x is None else x)
        kw[f.name] = torch.tensor(x, device=device,
                                  dtype=dtype if x.dtype.kind == "f"
                                  else None)
    return SinkState(**kw)


def mfv_state_from_jax(state, device="cpu",
                       dtype=torch.float64) -> MfvState:
    """The port's MfvState from a JAX MfvState (read through its
    attributes): floating fields take `dtype`, integer and bool fields
    keep their kind, ``bad_grad`` becomes a 0/1 float; the block-timestep
    fields (dQ, dQdt, rdmdt, rdmdt0, level, levelneib, nlast, tlast) come
    along where the JAX state has them."""
    kw = {}
    for f in dataclasses.fields(MfvState):
        x = getattr(state, f.name, None)
        if x is None:
            kw[f.name] = None
            continue
        x = np.array(x)
        if x.dtype.kind == "f" or f.name == "bad_grad":
            kw[f.name] = torch.tensor(x.astype(np.float64), dtype=dtype,
                                      device=device)
        else:
            kw[f.name] = torch.tensor(x, device=device)
    kw["nstep"] = kw["nstep"].to(torch.int64)
    return MfvState(**kw)


def mfv_state_to_numpy(state: MfvState) -> Dict[str, np.ndarray]:
    """Every non-None tensor field of an MfvState as a host numpy
    array."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(MfvState)
            if isinstance(getattr(state, f.name), torch.Tensor)}


def nbody_state_from_jax(state, device="cpu",
                         dtype=torch.float64) -> NbodyState:
    """The port's NbodyState from a JAX NbodyState (read through its
    attributes, field by field): floating fields take `dtype`, integer
    and bool fields keep their kind, nstep becomes int64."""
    kw = {}
    for f in dataclasses.fields(NbodyState):
        x = np.array(getattr(state, f.name))
        if x.dtype.kind == "f":
            kw[f.name] = torch.tensor(x, dtype=dtype, device=device)
        else:
            kw[f.name] = torch.tensor(x, device=device)
    kw["nstep"] = kw["nstep"].to(torch.int64)
    return NbodyState(**kw)


def nbody_state_to_numpy(state: NbodyState) -> Dict[str, np.ndarray]:
    """Every field of an NbodyState as a host numpy array."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(NbodyState)}


def grid_spec_from_jax(spec) -> Grid27Spec:
    """Field-for-field copy of gandalf_tpu's frozen Grid27Spec."""
    return Grid27Spec(ndim=int(spec.ndim),
                      ncells=tuple(int(n) for n in spec.ncells),
                      lo=tuple(float(x) for x in spec.lo),
                      extents=tuple(float(x) for x in spec.extents),
                      k_cell=int(spec.k_cell),
                      periodic=tuple(bool(p) for p in spec.periodic),
                      qz=int(spec.qz),
                      mirror=tuple(tuple(w) for w in spec.mirror))


def tree_spec_from_jax(spec) -> TreeSpec:
    """Field-for-field copy of gandalf_tpu's frozen TreeSpec."""
    return TreeSpec(**{f.name: getattr(spec, f.name)
                       for f in dataclasses.fields(TreeSpec)})


def ewald_table_from_jax(table) -> EwaldTable:
    """The port's EwaldTable from a JAX one (read through its
    attributes): the arrays as float64 (nmax int32) numpy, the static
    metadata as it is."""
    return EwaldTable(
        pot=np.array(table.pot, dtype=np.float64),
        acc=np.array(table.acc, dtype=np.float64),
        inv_dgrid=np.array(table.inv_dgrid, dtype=np.float64),
        nmax=np.array(table.nmax, dtype=np.int32),
        far_kind=int(table.far_kind), open_axes=tuple(table.open_axes),
        per_axes=tuple(table.per_axes), L_per=float(table.L_per),
        area=float(table.area), pot_const=float(table.pot_const),
        far_thresh=table.far_thresh)


def opacity_table_from_jax(table, device="cpu",
                           dtype=torch.float64) -> OpacityTable:
    """The port's OpacityTable from a JAX one (read through its
    attributes): the arrays on `device` in `dtype`, the scalars as
    Python floats."""
    return OpacityTable(
        **{k: torch.as_tensor(np.array(getattr(table, k)), device=device,
                              dtype=dtype).contiguous()
           for k in OpacityTable.ARRAYS},
        **{k: float(getattr(table, k)) for k in ("fcol2", "rad_const",
                                                 "temp_min",
                                                 "temp_ambient")})


_SCHED_INT = ("n", "level_max", "nresync", "nstep_part")


def schedule_from_jax(sched, device="cpu",
                      dtype=torch.float64) -> BlockSchedule:
    """The port's BlockSchedule from a JAX one: integer fields int32,
    float fields `dtype`."""
    return BlockSchedule(**{
        f: torch.tensor(np.array(getattr(sched, f)), device=device,
                        dtype=torch.int32 if f in _SCHED_INT else dtype)
        for f in BlockSchedule._fields})


def schedule_to_jax(sched: BlockSchedule) -> Dict[str, np.ndarray]:
    """A schedule's fields as host numpy arrays (int32 and float)."""
    return {f: getattr(sched, f).detach().cpu().numpy()
            for f in BlockSchedule._fields}


def stellar_table_from_jax(table) -> StellarTable:
    """The port's StellarTable from a JAX one (host numpy columns)."""
    return StellarTable(**{f.name: np.array(getattr(table, f.name),
                                            dtype=np.float64)
                           for f in dataclasses.fields(StellarTable)})


def mc_draws_from_numpy(draws, device="cpu", dtype=torch.float64):
    """[(source index (Np,) int64, direction (Np, ndim))] on `device` in
    `dtype` from numpy pairs, one pair per Monte-Carlo iteration."""
    return [(torch.tensor(np.asarray(src), dtype=torch.int64,
                          device=device),
             torch.tensor(np.asarray(dirs), dtype=dtype, device=device))
            for src, dirs in draws]
