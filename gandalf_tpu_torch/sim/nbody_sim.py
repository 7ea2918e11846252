"""Pure N-body simulation controller.

Counterpart of ``gandalf_tpu/sim/nbody_sim.py:NbodySimulation`` (the
reference's NbodySimulation, src/Nbody/NbodySimulation.cpp:183-330):
direct-summation gravity over all pairs of stars with a global timestep,
in 2D or 3D, under one of the schemes

- ``hermite4``: Hermite predictor, P(EC)^Npec with the Hermite corrector;
- ``hermite4ts``, ``hermite6ts``: the time-symmetric correctors with at
  least two P(EC) iterations (6TS predicts with the step-start snap and
  takes a second force pass, K15, for the snap);
- ``lfkdk``, ``lfdkd``: velocity-Verlet leapfrog, one force pass a step.

Gravity is unsoftened (K13) or, with ``nbody_softening = 1`` (the
default), softened with the mean-h smoothing kernel (K14: M4 or the
quintic, direct or tabulated; the gaussian is refused, fault F23); the
external potentials ``plummer`` and ``vertical`` add their acceleration,
jerk and potential.  With ``sub_systems = 1`` bound few-body systems are found on
the host every ``nsystembuildstep`` steps (``ops/systemtree.py``), their
members collapsed onto the centre of mass for the global integration (the
kernels mask coincident pairs) and their internal motion integrated on
the host, as in the JAX package.

A step runs eagerly on the state's device.  The host clamps each step's
dt to tend and to the next snapshot time from one read of (t, dt) per
step, taken right after the previous step.  Snapshots are taken as the
JAX package's ``output`` takes them (through ``Run``): the stars, with
any sub-system expanded and rho and u zero (``_state_to_host``), in
memory or, with a run_id and ``GANDALF_WRITE_SNAPSHOTS=1``, in files.  Unlike the hydro
controllers, this one does not burst: the clamp needs the previous
step's dt, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .._ext import refuse_gaussian_gravity
from ..integrate import hermite
from ..integrate.hermite import HermiteConfig
from ..kernels.smoothing import kernel_factory
from ..ops.gravity import (EXTERNAL_POTENTIALS, direct_nbody, direct_snap,
                           direct_softened, external_potential)
from ..ops.systemtree import build_subsystems, integrate_internal_motion
from ..state import NbodyState, make_nbody_state
from .ic import generate_nbody_ic
from .simulation import SimulationBase, _host, _unsupported

SCHEMES = ("hermite4", "hermite4ts", "hermite6ts", "lfkdk", "lfdkd")


class NbodySimulation(SimulationBase):
    """Direct-summation N-body on one device; float64 unless the caller
    asks for float32."""

    def __init__(self, params, device="cuda", dtype=torch.float64):
        super().__init__(params, device, dtype)
        self.subsystems = []
        # member indices -> (COM-frame r, v) of each collapsed sub-system,
        # and its nested inner pairs
        self._sys_rel = {}
        self._sys_children = {}
        self._dt_host = 0.0

    # -- parameters ------------------------------------------------------------
    def process_parameters(self):
        p = self.params
        ip, fp, sp = p.intparams, p.floatparams, p.stringparams
        if sp["sim"] != "nbody":
            raise _unsupported(f"sim {sp['sim']!r}", "items 9-10")
        if self.ndim not in (2, 3):
            raise _unsupported(f"N-body in {self.ndim}D", "item 11")
        if sp["radiation"] not in ("none", "null", ""):
            # the JAX package's N-body controller never reads `radiation`
            raise _unsupported("radiation in NbodySimulation (the JAX "
                               "package's controller ignores it: fault "
                               "F26)", "item 12")
        self.scheme = sp["nbody"]
        if self.scheme not in SCHEMES:
            raise _unsupported(f"nbody scheme {self.scheme!r}", "item 11")
        self.hermite = HermiteConfig.from_params(p)
        self.softening = bool(ip["nbody_softening"])
        self.kern = (kernel_factory(sp["kernel"], self.ndim,
                                    ip["tabulated_kernel"])
                     if self.softening else None)
        # M4 or the quintic, direct or tabulated: the JAX package's
        # gaussian wgrav and wpot are zero (fault F23)
        refuse_gaussian_gravity(self.kern, "softened N-body gravity (K14)")
        self.extpot = sp["external_potential"]
        if self.extpot not in EXTERNAL_POTENTIALS:
            raise ValueError(
                f"Unrecognised external_potential: {self.extpot!r}")
        self.extpot_cfg = {
            "mplummer": fp["mplummer"], "rplummer": fp["rplummer"],
            "kgrav": ip["kgrav"], "avert": fp["avert"], "rzero": 0.0,
        }
        self.use_sys = bool(ip["sub_systems"])

    # -- the physics -----------------------------------------------------------
    def _forces(self, s: NbodyState) -> NbodyState:
        """a, adot and gpot at the current r, v (K13 or K14, plus the
        external potential); for hermite6ts also the snap from the new a
        (K15)."""
        if self.softening:
            g = direct_softened(s.r, s.v, s.m, s.h, self.kern,
                                compute_jerk=True)
        else:
            g = direct_nbody(s.r, s.v, s.m, compute_jerk=True)
        a, adot, gpot = g.a, g.adot, g.gpot
        if self.extpot != "none":
            a_x, adot_x, pot_x = external_potential(
                self.extpot, self.extpot_cfg, s.r, s.v)
            a, adot, gpot = a + a_x, adot + adot_x, gpot + pot_x
        s = s.replace(a=a, adot=adot, gpot=gpot)
        if self.scheme == "hermite6ts":
            s = s.replace(a2dot=direct_snap(s.r, s.v, s.a, s.m))
        return s

    def _bootstrap(self, s: NbodyState) -> NbodyState:
        """Forces, the step-start copies and the startup dt from |a|/|adot|
        only (a2dot and a3dot are not known yet; hermite6ts has its snap)."""
        s = self._forces(s)
        a2dot = s.a2dot if self.scheme == "hermite6ts" \
            else torch.zeros_like(s.a)
        s = s.replace(a0=s.a, adot0=s.adot, r0=s.r, v0=s.v, a2dot=a2dot,
                      a2dot0=a2dot, a3dot=torch.zeros_like(s.a))
        amag = torch.sqrt(torch.sum(s.a * s.a, dim=-1))
        adotmag = torch.sqrt(torch.sum(s.adot * s.adot, dim=-1))
        dt = self.hermite.nbody_mult * torch.min(amag / (adotmag + 1e-20))
        return s.replace(dt=dt)

    def _step(self, s: NbodyState) -> NbodyState:
        """One global step of s.dt: predict, P(EC)^n (at least two
        iterations for the time-symmetric schemes), the end-of-step copies
        and the next dt (NbodySimulation::MainLoop :258-330)."""
        cfg, scheme = self.hermite, self.scheme
        dt = s.dt
        t = s.t + dt
        if scheme in ("lfkdk", "lfdkd"):
            # velocity-Verlet leapfrog (NbodyLeapfrogKDK.cpp)
            v_half = s.v0 + 0.5 * dt * s.a0
            s = s.replace(r=s.r0 + dt * v_half, v=v_half)
            s = self._forces(s)
            s = hermite.end_timestep(s.replace(v=s.v + 0.5 * dt * s.a))
            amag = torch.sqrt(torch.sum(s.a * s.a, dim=-1))
            dt_next = cfg.nbody_mult * torch.min(
                torch.sqrt(s.h / (amag + 1e-20)))
            return s.replace(t=t, dt=dt_next, nstep=s.nstep + 1)
        if scheme == "hermite6ts":
            s, corr = hermite.predict_ts6(s, dt), hermite.correct_ts6
        elif scheme == "hermite4ts":
            s, corr = hermite.predict(s, dt), hermite.correct_ts4
        else:
            s, corr = hermite.predict(s, dt), hermite.correct
        npec = max(2 if scheme in ("hermite4ts", "hermite6ts") else 1,
                   cfg.npec)
        for _ in range(npec):
            s = corr(self._forces(s), dt)
        s = hermite.end_timestep(s)
        dt_next = torch.min(hermite.aarseth_timestep(cfg, s))
        return s.replace(t=t, dt=dt_next, nstep=s.nstep + 1)

    # -- setup and host loop ---------------------------------------------------
    def SetupSimulation(self, ic: Optional[Dict[str, np.ndarray]] = None):
        """The star set (generated, or `ic` with keys r, v, m, h) and the
        bootstrap force pass."""
        self._require_device()
        with self.timing.block("SETUP"):
            self.process_parameters()
            if ic is None:
                with self.timing.block("GENERATE_IC"):
                    ic = generate_nbody_ic(self.params)
            self.state = make_nbody_state(ic["r"], ic["v"], ic["m"], ic["h"],
                                          device=self.device,
                                          dtype=self.dtype)
            self._step_fn = self._step
            self.state = self._bootstrap(self.state)
        self._read_clock()
        self._init_output_cadence()
        self.setup_complete = True

    def _read_clock(self):
        """t and dt of the state to the host, in one read."""
        self.t, self._dt_host = torch.stack(
            (self.state.t, self.state.dt)).tolist()

    def main_loop_step(self):
        """One global step.  Every nsystembuildstep steps the sub-systems
        are rebuilt first (with sub_systems = 1).  dt is clamped to tend -
        t and, while the next snapshot time lies ahead, to tsnapnext - t
        (gandalf_tpu/sim/nbody_sim.py:159-169); a non-finite or
        non-positive dt (every star collapsed into one system has no
        global acceleration) becomes that cap."""
        p = self.params
        if self.use_sys and self.Nsteps % max(
                p.intparams["nsystembuildstep"], 1) == 0:
            with self.timing.block("SUBSYSTEMS"):
                self._rebuild_subsystems()
        cap = max(p.floatparams["tend"] - self.t, 1e-30)
        if self.tsnapnext > self.t:
            cap = min(cap, self.tsnapnext - self.t)
        dt_glob = self._dt_host
        if not math.isfinite(dt_glob) or dt_glob <= 0.0 or dt_glob > cap:
            dt_glob = cap
            self.state = self.state.replace(dt=torch.tensor(
                dt_glob, dtype=self.dtype, device=self.device))
        traj0 = None
        if self._sys_rel:
            # the start-of-step Hermite derivatives: the cubic
            # trajectories the internal integration predicts perturbers
            # and COMs along
            s0 = self.state
            traj0 = tuple(_host(x).copy()
                          for x in (s0.r0, s0.v0, s0.a0, s0.adot0))
        with self.timing.block("MAIN_LOOP"):
            self.state = self._step(self.state)
        if self._sys_rel:
            with self.timing.block("SUBSYSTEMS"):
                self._integrate_subsystems(dt_glob, traj0)
        self.Nsteps += 1
        self._read_clock()

    def main_loop_steps(self, n: int) -> int:
        """One step: the N-body controller does not burst."""
        self.main_loop_step()
        return 1

    def _state_to_host(self) -> Dict[str, np.ndarray]:
        """A snapshot's arrays (gandalf_tpu/sim/nbody_sim.py:363-372): the
        stars with any sub-system expanded, and rho and u zero so that
        hydro analysis reads them."""
        s = self.state
        out = {k: _host(getattr(s, k))
               for k in ("r", "v", "a", "m", "h", "gpot")}
        if self._sys_rel:
            out["r"], out["v"] = self._absolute_state()
        out["rho"] = np.zeros(s.N)
        out["u"] = np.zeros(s.N)
        return out

    # -- sub-systems (SystemParticle internal integration) -------------------
    def _absolute_state(self):
        """Absolute star positions and velocities (each collapsed
        sub-system's COM plus its members' internal offsets), numpy."""
        r = _host(self.state.r).copy()
        v = _host(self.state.v).copy()
        for members, (rel_r, rel_v) in self._sys_rel.items():
            idx = list(members)
            r[idx] = r[idx] + rel_r
            v[idx] = v[idx] + rel_v
        return r, v

    def _rebuild_subsystems(self):
        """Find bound sub-systems on the absolute coordinates and collapse
        their members onto their COM for the global integration
        (NbodySystemTree::BuildSubSystems), then refresh the forces,
        derivatives and dt with the bootstrap pass."""
        p = self.params
        r_abs, v_abs = self._absolute_state()
        s = self.state
        m = _host(s.m)
        self.subsystems = build_subsystems(
            r_abs, v_abs, m, _host(s.gpot),
            Ncompmax=p.intparams.get("Ncompmax", 4),
            gpefrac=p.floatparams["gpefrac"])
        self._sys_rel = {}
        self._sys_children = {}
        r_new, v_new = r_abs.copy(), v_abs.copy()
        for sub in self.subsystems:
            idx = list(sub.members)
            mm = m[idx]
            M = mm.sum()
            r_com = (mm[:, None] * r_abs[idx]).sum(0) / M
            v_com = (mm[:, None] * v_abs[idx]).sum(0) / M
            rel_r = r_abs[idx] - r_com
            rel_v = v_abs[idx] - v_com
            self._sys_rel[sub.members] = (rel_r, rel_v)
            r_new[idx] = r_com
            v_new[idx] = v_com
            if sub.n >= 3:
                kids = self._detect_nested(rel_r, rel_v, mm)
                if kids:
                    self._sys_children[sub.members] = kids
        dev = dict(dtype=self.dtype, device=self.device)
        r_t = torch.as_tensor(r_new, **dev)
        v_t = torch.as_tensor(v_new, **dev)
        self.state = self._bootstrap(s.replace(r=r_t, v=v_t, r0=r_t, v0=v_t))
        self._read_clock()

    @staticmethod
    def _detect_nested(rel_r, rel_v, mm):
        """Nested sub-systems inside one system (NbodySystemTree.cpp:
        256-420): greedily accept disjoint bound tight pairs whose
        separation is well inside the distance to the rest of the system.
        Returns a list of local index pairs."""
        n = len(mm)
        dr = rel_r[:, None, :] - rel_r[None, :, :]
        d = np.sqrt((dr ** 2).sum(-1))
        np.fill_diagonal(d, np.inf)
        pairs = sorted(((d[i, j], i, j) for i in range(n)
                        for j in range(i + 1, n)), key=lambda t: t[0])
        kids, used = [], set()
        for d_p, i, j in pairs:
            if i in used or j in used:
                continue
            rest = [k for k in range(n) if k not in (i, j)]
            if not rest:
                break
            d_other = min(min(d[i, k], d[j, k]) for k in rest)
            mu = mm[i] + mm[j]
            eps = (0.5 * ((rel_v[i] - rel_v[j]) ** 2).sum()
                   - mu / max(d_p, 1e-300))
            # tight (hierarchy margin 4x) and bound
            if eps < 0.0 and d_other > 4.0 * d_p:
                kids.append((i, j))
                used.update((i, j))
        # at least two outer nodes must remain, or the outer integration
        # is the pair itself
        if kids and (n - 2 * len(kids) + len(kids)) < 2:
            return []
        return kids

    def _integrate_subsystems(self, dt_glob: float, traj0=None):
        """Advance each sub-system's internal motion over the global step
        (Nbody::IntegrateInternalMotion, Nbody.cpp:481-720): the COM moved
        with the global step; the members orbit in the COM frame under the
        tidal forces of the other (collapsed) stars, predicted along their
        start-of-step cubic trajectories `traj0`.  A nested system
        integrates its outer nodes (inner pairs as point masses), then
        each inner pair about its node with the other nodes as
        perturbers."""
        s = self.state
        r_glob = _host(s.r)
        m = _host(s.m)
        nm = self.hermite.nbody_mult
        for members, (rel_r, rel_v) in list(self._sys_rel.items()):
            idx = list(members)
            others = np.asarray([i for i in range(s.N)
                                 if i not in members])
            r_com = r_glob[idx[0]]
            pert_traj = com_traj = None
            if traj0 is not None:
                if len(others):
                    pert_traj = tuple(arr[others] for arr in traj0)
                com_traj = tuple(arr[idx[0]] for arr in traj0)
            r_pert = r_glob[others] if len(others) else None
            m_pert = m[others] if len(others) else None
            kids = self._sys_children.get(members, [])
            mm = m[idx]
            if not kids:
                self._sys_rel[members] = integrate_internal_motion(
                    rel_r, rel_v, mm, dt_glob, nbody_mult=nm, r_com=r_com,
                    r_pert=r_pert, m_pert=m_pert, pert_traj=pert_traj,
                    com_traj=com_traj)
                continue
            # hierarchical: the outer nodes first
            in_kid = {k for pair in kids for k in pair}
            rest = [k for k in range(len(idx)) if k not in in_kid]
            node_r = [rel_r[rest]] if rest else []
            node_v = [rel_v[rest]] if rest else []
            node_m = [mm[rest]] if rest else []
            kid_off = []        # each inner pair's offsets about its node
            for (i, j) in kids:
                mc = mm[i] + mm[j]
                r_c = (mm[i] * rel_r[i] + mm[j] * rel_r[j]) / mc
                v_c = (mm[i] * rel_v[i] + mm[j] * rel_v[j]) / mc
                kid_off.append((np.stack([rel_r[i] - r_c, rel_r[j] - r_c]),
                                np.stack([rel_v[i] - v_c, rel_v[j] - v_c])))
                node_r.append(r_c[None])
                node_v.append(v_c[None])
                node_m.append(np.array([mc]))
            node_r = np.concatenate(node_r)
            node_v = np.concatenate(node_v)
            node_m = np.concatenate(node_m)
            node_r, node_v = integrate_internal_motion(
                node_r, node_v, node_m, dt_glob, nbody_mult=nm, r_com=r_com,
                r_pert=r_pert, m_pert=m_pert, pert_traj=pert_traj,
                com_traj=com_traj)
            # then the inner pairs about their end-of-step nodes
            new_r, new_v = rel_r.copy(), rel_v.copy()
            if rest:
                new_r[rest] = node_r[:len(rest)]
                new_v[rest] = node_v[:len(rest)]
            for kk, (i, j) in enumerate(kids):
                nd = len(rest) + kk
                pr, pv = kid_off[kk]
                # perturbers: the other outer nodes (end of step, absolute
                # coordinates) and the stars outside the system
                o_nodes = [q for q in range(len(node_m)) if q != nd]
                rp = r_com + node_r[o_nodes]
                mp = node_m[o_nodes]
                if len(others):
                    rp = np.concatenate([rp, r_glob[others]])
                    mp = np.concatenate([mp, m[others]])
                pr, pv = integrate_internal_motion(
                    pr, pv, mm[[i, j]], dt_glob, nbody_mult=nm,
                    r_com=r_com + node_r[nd],
                    r_pert=rp if len(rp) else None,
                    m_pert=mp if len(mp) else None)
                new_r[[i, j]] = node_r[nd] + pr
                new_v[[i, j]] = node_v[nd] + pv
            self._sys_rel[members] = (new_r, new_v)
