"""The distributed (Nmpi > 1) grad-h SPH controller.

Counterpart of ``gandalf_tpu/sim/dist_sim.py``'s
DistributedGradhSphSimulation (the reference's MPI mode: domain
decomposition, ghost exchange, the dt Allreduce, migration at tree
rebuilds).  The particle state is split into z-slab shards
(``parallel/dist.py``), one list entry per shard on the shard group's
devices (``parallel/comm.py``), and every step runs the predict, the
sharded hydro pass with halos (K1 with ``zrow_max``, K2 and K3 on ghosted
slabs), ring-LET gravity (K4-K7 over the ring, K38 for the far shards),
the corrector and the minimum timestep over the shards.  At the rebuild
cadence the shards migrate on the devices (without gravity) or the host
replans the decomposition.

One process drives every shard, as the JAX package's single-controller
program drives its mesh; so several shards may share one card or the
CPU.  The options outside this slice are refused before any state is
built (ROADMAP queue 1, item 13).

One place differs from the JAX package (ROADMAP queue 3, F36): the ring
radius is planned from the live particles' largest h, where the JAX
package's controller takes the largest h of the padded state, whose pads
have h = 1; in a unit box that makes every ring cover all shards, so the
far walk never runs.  And dt is clamped to tend on the host, as the
port's single-device step clamps it (the JAX package's distributed step
does not).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..integrate.leapfrog import correct, predict, sph_timestep
from ..ops.sph_grid27 import plan_grid27
from ..parallel import dist
from ..parallel.comm import ShardGroup, default_shard_devices
from ..parallel.let import grow_let_caps, let_gravity, plan_let
from ..state import GAS_TYPE, SphState, make_sph_state
from .ic import generate_ic
from .simulation import GradhSphSimulation, _host, _unsupported

ITEM = "item 13"


class DistributedGradhSphSimulation(GradhSphSimulation):
    """Grad-h SPH over Nmpi z-slab shards on `shard_devices` (default:
    one per visible CUDA device, the counterpart of jax.devices()).
    The state is ``shards``, one SphState per shard; ``state`` stays
    None."""

    def __init__(self, params, device="cuda", dtype=torch.float32,
                 shard_devices=None):
        super().__init__(params, device, dtype)
        self.shards: List[SphState] = None
        self.shard_devices = shard_devices
        self.group = None
        self.distplan = None
        self.letplan = None
        self._gmaps = None
        self._perm_stale = False
        self._mig_round = 0
        self.n_migrations = 0
        self.n_replans = 0

    # -- the state ------------------------------------------------------------
    def gathered_state(self):
        """The shard-major concatenation of the shards on the
        controller's device, pads included, as the JAX package's sharded
        state is (None before the setup): a copy of every field."""
        if self.shards is None:
            return None
        return dist.concat_shards(self.shards, self.device)

    # -- parameters -----------------------------------------------------------
    def process_parameters(self):
        super().process_parameters()
        sp = self.params.stringparams
        refused = (
            ("sinks or stars", self.sink_cfg.create or self.sink_cfg.accrete),
            ("dust", self.has_dust),
            ("the cd2010 viscosity switch",
             self.integ.td_avisc and self.td_avisc_type == "cd2010"),
            ("block timesteps", self.use_block),
            ("mirror/wall boundaries", bool(self.box.mirror_walls())),
            ("the Ewald sum", self.use_ewald),
            ("the radws EOS", sp["gas_eos"] == "radws"),
            ("external potentials", self.extpot != "none"),
        )
        for what, on in refused:
            if on:
                raise _unsupported(f"{what} over shards (Nmpi > 1)", ITEM)
        self.n_shards = self.params.intparams["Nmpi"]
        if self.n_shards < 2:
            raise ValueError(f"the distributed controller runs Nmpi > 1 "
                             f"shards, not {self.n_shards}: one shard is "
                             f"the single-device controller's")
        devices = (default_shard_devices() if self.shard_devices is None
                   else list(self.shard_devices))
        if self.n_shards > len(devices):
            raise ValueError(f"Nmpi={self.n_shards} > {len(devices)} "
                             "devices")
        self.group = ShardGroup(devices[:self.n_shards])

    # -- planning -------------------------------------------------------------
    def _plan_all(self, r_np: np.ndarray, h_np: np.ndarray,
                  growth: float = 1.3):
        """The grid (rows a multiple of the shard count) and the
        decomposition, balanced where the uniform split is not
        (gandalf_tpu/sim/dist_sim.py:72-85)."""
        h_max = float(h_np.max()) * growth
        self.gridspec = plan_grid27(self.box, r_np, h_max,
                                    self.kern.kernrange,
                                    z_multiple=self.n_shards)
        self.distplan = dist.plan_decomposition(self.gridspec, r_np,
                                                self.n_shards,
                                                balance="auto")

    def _plan_dist_tree(self):
        """The ring LET plan (gandalf_tpu/sim/dist_sim.py:87-121; with
        Nmpi > 1 plan_let always gives one, so the JAX package's
        replicated-tree branch never runs here); R from the live
        particles' h (F36)."""
        p = self.params
        mp = p.stringparams["multipole"]
        theta_sqd = p.floatparams["thetamaxsqd"]
        alive = np.concatenate([_host(s.alive) for s in self.shards])
        h_all = np.concatenate([_host(s.h) for s in self.shards])
        h_max = float(h_all[alive].max()) if alive.any() else 0.0
        r_sh = np.concatenate([_host(s.r) for s in self.shards])
        spec = self.gridspec
        cell0 = spec.extents[0] / spec.ncells[0]
        w_min = (float(self.distplan.row_len.min()) * cell0
                 if self.distplan.balanced else None)
        self.letplan = plan_let(
            r_sh.astype(np.float64), self.distplan.perm, self.n_shards,
            self.distplan.cap, z_lo=spec.lo[0], z_extent=spec.extents[0],
            leaf_size=32, theta_sqd=theta_sqd,
            quadrupole=mp in ("quadrupole", "fast_quadrupole"),
            h_support=self.kern.kernrange * h_max, prev=self.letplan,
            w_slab_min=w_min)
        assert self.letplan is not None
        self._n_tree_plans += 1
        G = self.letplan.g_loc
        gm = torch.as_tensor(self.letplan.gmap)
        self._gmaps = [self.group.to(gm[k * G:(k + 1) * G], k)
                       for k in range(self.n_shards)]

    # -- the physics ----------------------------------------------------------
    def _dist_force_pass(self, shards: List[SphState],
                         alives: List[torch.Tensor]) -> List[SphState]:
        """The sharded hydro pass, then ring-LET gravity
        (gandalf_tpu/sim/dist_sim.py:172-280, the gas and gravity
        branches)."""
        shards = dist.dist_hydro_pass(
            self.group, self.distplan, self.kern, self.visc, self.box,
            self.eos, self.h_fac, self.h_converge, self.hydro_forces,
            shards, alives)
        if not self.self_gravity:
            return shards
        pext = self._periodic_extent()
        ms = [self._gravity_mass(s) for s in shards]
        a_g, gpot, ovg = let_gravity(
            self.group, self.letplan, self._gmaps, [s.r for s in shards],
            ms, [s.h for s in shards], [s.zeta * s.hfactor for s in shards],
            alives, self.kern, periodic_extent=pext)
        return [s.replace(a=s.a + a, gpot=gp,
                          neib_overflow=s.neib_overflow
                          | self.group.to(ovg, k))
                for k, (s, a, gp) in enumerate(zip(shards, a_g, gpot))]

    def _dist_dt(self, shards, alives) -> List[torch.Tensor]:
        """The minimum timestep over the shards' live particles, on every
        shard (gandalf_tpu/sim/dist_sim.py:294-305)."""
        mins = [torch.min(torch.where(
            al, sph_timestep(self.integ, s, self.hydro_forces), 1e30))
            for s, al in zip(shards, alives)]
        return self.group.pmin(mins)

    def _bootstrap(self, shards: List[SphState]) -> List[SphState]:
        alives = [s.alive for s in shards]
        shards = self._dist_force_pass(shards, alives)
        shards = [s.replace(a0=s.a, dudt0=s.dudt, u0=s.u, r0=s.r, v0=s.v)
                  for s in shards]
        return [s.replace(dt=dt)
                for s, dt in zip(shards, self._dist_dt(shards, alives))]

    def _step(self, shards: List[SphState]) -> List[SphState]:
        """One KDK step over the shards (gandalf_tpu/sim/dist_sim.py:
        481-514, local_gas): predict, wrap, the force pass, mm97's rate
        of alpha, correct, the next dt."""
        integ, box = self.integ, self.box
        ts, out = [], []
        for s in shards:
            dt = s.dt
            ts.append(s.t + dt)
            s = predict(integ, s, dt)
            r, v = box.reflect(box.wrap(s.r), s.v)
            out.append(s.replace(r=r, v=v, r0=box.wrap(s.r0)))
        alives = [s.alive for s in out]
        out = self._dist_force_pass(out, alives)
        out = [correct(integ, s, s.dt, self._dalphadt(s)) for s in out]
        dts = self._dist_dt(out, alives)
        return [s.replace(t=t, dt=dt, nstep=s.nstep + 1)
                for s, t, dt in zip(out, ts, dts)]

    # -- migration and replans ------------------------------------------------
    def _try_device_migrate(self) -> bool:
        """Device-side migration at the rebuild cadence; the host replans
        instead with self-gravity (the tree plans name slots), after an
        overflow of the migration's capacity, and at every 8th cadence
        (gandalf_tpu/sim/dist_sim.py:617-653)."""
        if self.self_gravity:
            return False
        self._mig_round += 1
        if self._mig_round % 8 == 0:
            return False
        shards, _, over = dist.migrate_particles(self.group, self.distplan,
                                                 self.shards)
        if bool(over):
            return False
        self.shards = shards
        self._perm_stale = True
        self.n_migrations += 1
        return True

    def _refresh_perm(self):
        """The plan's permutation from the shards' iorig after device
        migrations (lazy: only where the host needs the original order)."""
        if self._perm_stale:
            self.distplan = dist.perm_from_iorig(
                self.distplan, [s.iorig for s in self.shards])
            self._perm_stale = False

    def _replan(self, growth: float = 1.3, grow_caps: bool = False):
        """Gather, re-decompose and re-shard, and replan the tree
        (gandalf_tpu/sim/dist_sim.py:750-780)."""
        self._refresh_perm()
        host = dist.unshard_state(self.distplan, self.shards, self._n_orig,
                                  self.device)
        alive = _host(host.alive)
        self._plan_all(_host(host.r), _host(host.h)[alive], growth=growth)
        host = host.replace(neib_overflow=torch.zeros_like(
            host.neib_overflow))
        self.shards = dist.shard_state(self.group, self.distplan, host)
        if self.self_gravity:
            if grow_caps:
                self.letplan = grow_let_caps(self.letplan)
            self._plan_dist_tree()
        self.n_replans += 1

    def _overflowed(self) -> bool:
        return bool(self.shards[0].neib_overflow)

    # -- host lifecycle -------------------------------------------------------
    def SetupSimulation(self, ic: Dict[str, np.ndarray] = None):
        """The IC, the plans, the sharded state and the bootstrap pass,
        replanned on overflow at most 3 times
        (gandalf_tpu/sim/dist_sim.py:664-714)."""
        self._require_device()
        with self.timing.block("SETUP"):
            self.process_parameters()
            if ic is None:
                ic = self._staged_ic()
            if ic is None:
                with self.timing.block("GENERATE_IC"):
                    ic = generate_ic(self.params, self.eos)
            if "star" in ic:
                raise _unsupported("stars over shards (Nmpi > 1)", ITEM)
            ptype = ic.get("ptype")
            if ptype is not None and not np.all(np.asarray(ptype)
                                                == GAS_TYPE):
                raise _unsupported("particle types other than gas over "
                                   "shards (Nmpi > 1)", ITEM)
            state = make_sph_state(ic["r"], ic["v"], ic["m"], ic["h"],
                                   ic["u"], device=self.device,
                                   dtype=self.dtype)
            alpha0 = (self.visc.alpha_visc_min if self.integ.td_avisc
                      else self.visc.alpha_visc)
            state = state.replace(alpha=torch.full_like(state.alpha, alpha0))
            if "t" in ic:
                state = state.replace(t=torch.tensor(
                    float(ic["t"]), dtype=self.dtype, device=self.device))
            self._n_orig = state.N
            self._plan_all(np.asarray(ic["r"]), np.asarray(ic["h"]))
            self.shards = dist.shard_state(self.group, self.distplan, state)
            if self.self_gravity:
                self._plan_dist_tree()
            self.shards = self._bootstrap(self.shards)
            tries = 0
            while self._overflowed():
                tries += 1
                if tries > 3:
                    raise RuntimeError("distributed setup keeps "
                                       "overflowing")
                self._n_grid_overflows += 1
                self._replan(growth=1.3)
                self.shards = self._bootstrap(self.shards)
        self._init_output_cadence()

    def _clamp_dt_to_tend(self):
        """Bound the shards' dt (the same on every shard) by the time
        left to tend."""
        s0 = self.shards[0]
        cap = self.params.floatparams["tend"] - float(s0.t)
        if 0.0 < cap < float(s0.dt):
            self.shards = [s.replace(dt=torch.full_like(s.dt, cap))
                           for s in self.shards]

    def main_loop_step(self):
        """The cadence's migration or replan, then one step; on overflow
        the step is redone after a replan with grown caps
        (gandalf_tpu/sim/dist_sim.py:782-802)."""
        ntb = max(self.params.intparams["ntreebuildstep"], 1)
        if self.Nsteps > 0 and self.Nsteps % ntb == 0:
            with self.timing.block("DECOMPOSE"):
                if not self._try_device_migrate():
                    self._replan()
        self._clamp_dt_to_tend()
        with self.timing.block("MAIN_LOOP"):
            prev = self.shards
            self.shards = self._step(prev)
            if self._overflowed():
                with self.timing.block("GRID_REPLAN"):
                    self._n_grid_overflows += 1
                    self.shards = prev
                    self._replan(growth=1.3, grow_caps=True)
                    self.shards = self._step(self.shards)
        self.Nsteps += 1
        self.t = float(self.shards[0].t)

    def main_loop_steps(self, n: int) -> int:
        """n steps, one at a time."""
        for _ in range(n):
            self.main_loop_step()
        return n

    def _state_to_host(self) -> Dict[str, np.ndarray]:
        """A snapshot's arrays in the original particle order
        (gandalf_tpu/sim/dist_sim.py:804-815)."""
        self._refresh_perm()
        host = dist.unshard_state(self.distplan, self.shards, self._n_orig,
                                  self.device)
        return {k: _host(getattr(host, k))
                for k in ("r", "v", "a", "m", "h", "rho", "u", "dudt",
                          "pressure", "sound", "div_v", "gpot")}
