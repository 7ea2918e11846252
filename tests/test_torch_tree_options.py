"""Port parity of the self-gravitating slice's options and replans
(float64, CPU): the accuracy MACs (gadget2, eigenmac), the fast
multipoles (fast_monopole, fast_quadrupole) and the Ewald sum run like
the JAX package's over 5 steps, the monopole too, octtree buckets still
raise, and too-small tree caps overflow and regrow as in the JAX
package.  The options run on a 12^3 box at theta^2 = 1, where the walk
accepts cells from the second level down; the bootstrap and window
replans of each MAC at 16^3 are counted in both packages (ROADMAP fault
F4)."""

import dataclasses

import numpy as np
import pytest
import torch

from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu_torch.check import jittered_box_ic
from gandalf_tpu_torch.convert import tree_spec_from_jax
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

from test_torch_tree_sim import TOL, _counts, _errors, _pair, _params

torch.set_num_threads(1)


def test_octtree_buckets_raise():
    p = _params(8)
    p.set("neib_search", "octtree")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GradhSphSimulation(p).process_parameters()


def _option_pair(n_side, overrides):
    """Both controllers after setup on the jittered box with `overrides`,
    the JAX one counting its tree plans."""
    p = _params(n_side)
    p.set("ntreebuildstep", 2)
    for k, v in overrides.items():
        p.set(k, v)
    ic = jittered_box_ic(p, n_side)
    jsim = JaxSim(p)
    jsim.restart_data = {k: v.copy() for k, v in ic.items()}
    plan = jsim._plan_tree_buckets
    jsim.n_plans = 0

    def counted(*args, **kw):
        jsim.n_plans += 1
        return plan(*args, **kw)

    jsim._plan_tree_buckets = counted
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(p, device="cpu", dtype=torch.float64)
    tsim.SetupSimulation({k: v.copy() for k, v in ic.items()})
    return jsim, tsim


OPTIONS = {
    "gadget2": {"gravity_mac": "gadget2"},
    "eigenmac": {"gravity_mac": "eigenmac"},
    "fast_monopole": {"multipole": "fast_monopole"},
    "fast_quadrupole": {"multipole": "fast_quadrupole"},
    "ewald": {"ewald": 1},
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_gravity_option_runs_like_jax(option):
    """5 steps of the option against the JAX package, within 1e-9, on a
    12^3 box at theta^2 = 1 (the Ewald sum at 8^3, the Jeans box's size
    in test_torch_ewald_sim.py): the port's TreeSpec carries the JAX
    package's MAC and fast flags."""
    over = dict(OPTIONS[option], thetamaxsqd=1.0)
    jsim, tsim = _option_pair(8 if option == "ewald" else 12, over)
    assert tsim.treespec.mac == jsim.treespec.mac
    assert tsim.treespec.fast == jsim.treespec.fast
    assert tsim.treespec.quadrupole == jsim.treespec.quadrupole
    assert tsim.use_ewald == (option == "ewald")
    for i in range(5):
        jsim.main_loop_step()
        tsim.main_loop_step()
        errs = _errors(jsim, tsim)
        assert max(errs.values()) <= TOL, (i, errs)
    assert tree_spec_from_jax(jsim.treespec) == tsim.treespec


def test_mac_replans_f4():
    """ROADMAP fault F4 at 16^3 (theta^2 = 0.1): gadget2's bootstrap walk
    opens every cell (a0 is zero), but the 128 leaves fit the measured
    caps, so neither package replans, at bootstrap or over 2 steps, for
    either accuracy MAC (the counts are printed; the geometric MAC's are
    0, test_torch_tree_sim.py).  Both take the same fields and replans."""
    for mac in ("gadget2", "eigenmac"):
        jsim, tsim = _option_pair(16, {"gravity_mac": mac})
        boot = (getattr(jsim, "_n_grid_overflows", 0), tsim._n_grid_overflows)
        for i in range(2):
            jsim.main_loop_step()
            tsim.main_loop_step()
        errs = _errors(jsim, tsim)
        assert max(errs.values()) <= TOL, (mac, errs)
        window = (getattr(jsim, "_n_grid_overflows", 0) - boot[0],
                  tsim._n_grid_overflows - boot[1])
        print(f"F4 {mac} at 16^3: bootstrap replans JAX {boot[0]}, port "
              f"{boot[1]}; replans over 2 steps JAX {window[0]}, port "
              f"{window[1]}")
        assert boot[0] == boot[1] and window[0] == window[1]


def test_monopole_slice_runs_like_jax():
    """multipole = monopole is the same kernels with the quadrupole terms
    off: two steps against the JAX package."""
    ic = jittered_box_ic(_params(8), 8)
    sims = []
    for cls, kw in ((JaxSim, {}), (GradhSphSimulation,
                                   {"device": "cpu",
                                    "dtype": torch.float64})):
        p = _params(8)
        p.set("multipole", "monopole")
        sim = cls(p, **kw)
        if cls is JaxSim:
            sim.restart_data = {k: v.copy() for k, v in ic.items()}
            sim.SetupSimulation()
        else:
            sim.SetupSimulation({k: v.copy() for k, v in ic.items()})
        for _ in range(2):
            sim.main_loop_step()
        sims.append(sim)
    jsim, tsim = sims
    assert not tsim.treespec.quadrupole
    assert tree_spec_from_jax(jsim.treespec) == tsim.treespec
    assert max(_errors(jsim, tsim).values()) <= TOL


def test_small_caps_overflow_and_regrow_like_jax():
    """Starting from caps too small for the walk, both packages overflow
    on the same step, replan with grown caps to the same TreeSpec, and
    go on to the same state."""
    jsim, tsim = _pair(8)
    small = dataclasses.replace(
        jsim.treespec, near_cap=4,
        frontier_levels=tuple(min(w, 2) for w in
                              jsim.treespec.frontier_levels))
    jsim.treespec = small
    jsim._compile()
    tsim.treespec = tree_spec_from_jax(small)
    c0 = _counts(jsim, tsim)
    for i in range(3):
        jsim.main_loop_step()
        tsim.main_loop_step()
        jc, tc = _counts(jsim, tsim)
        assert (jc[0] - c0[0][0], jc[1] - c0[0][1]) \
            == (tc[0] - c0[1][0], tc[1] - c0[1][1]), i
        assert tree_spec_from_jax(jsim.treespec) == tsim.treespec, i
        errs = _errors(jsim, tsim)
        assert max(errs.values()) <= TOL, (i, errs)
    # one overflow, on the first step, regrown past the small caps
    assert tsim._n_grid_overflows - c0[1][1] == 1
    assert tsim.treespec.near_cap > small.near_cap


@pytest.mark.parametrize("mac", ["gadget2", "geometric"])
def test_full_width_caps_after_the_growths_f4(monkeypatch, mac):
    """ROADMAP fault F4's last resort, with caps that cannot grow and a
    walk-statistics pass that measures almost no demand: the bootstrap
    overflows 5 times; then an accuracy MAC's walk gets caps of the whole
    tree's width and runs, where the geometric MAC's raises as the JAX
    package does.  Caps change padding only: on the bootstrap's state the
    whole-width walk gives the field of a walk with measured caps, grown
    until it fits."""
    from gandalf_tpu_torch.ops.tree import (grow_tree_caps,
                                            tree_gravity_grouped)
    from gandalf_tpu_torch.sim import simulation as tsim_mod

    def tiny(r, gmap, theta_sqd, **kw):
        depth = int(np.log2(gmap.shape[0]))
        return 1, 1, 1, np.ones(depth + 1, np.int32)

    p = _params(16)
    p.set("gravity_mac", mac)
    ic = jittered_box_ic(p, 16)
    monkeypatch.setattr(tsim_mod, "walk_stats_levels_native", tiny)
    monkeypatch.setattr(tsim_mod, "grow_tree_caps", lambda spec: spec)
    sim = GradhSphSimulation(p, device="cpu", dtype=torch.float64)
    if mac == "geometric":
        with pytest.raises(RuntimeError, match="after 5 replans"):
            sim.SetupSimulation({k: v.copy() for k, v in ic.items()})
        return
    sim.SetupSimulation({k: v.copy() for k, v in ic.items()})
    assert sim._n_grid_overflows == 6
    G = sim.treespec.n_leaves
    assert sim.treespec.near_cap == G
    monkeypatch.undo()
    s = sim.state

    def gravity(spec):
        return tree_gravity_grouped(
            spec, s.bucket_map, s.r, sim._gravity_mass(s), s.h, sim.kern,
            zh=s.zeta * s.hfactor, periodic_extent=sim._periodic_extent(),
            **sim._mac_inputs(s, spec))

    a_wide, pot_wide, ovf = gravity(sim.treespec)
    assert not bool(ovf)
    ref = GradhSphSimulation(p, device="cpu", dtype=torch.float64)
    ref.process_parameters()
    ref.state = s
    ref._plan_tree_buckets(s.r.numpy())
    spec = ref.treespec
    a, pot, ovf = gravity(spec)
    while bool(ovf):
        spec = grow_tree_caps(spec)
        a, pot, ovf = gravity(spec)
    assert spec != sim.treespec
    assert float(torch.abs(a - a_wide).max()) <= 1e-12 * float(
        torch.abs(a_wide).max())
    assert float(torch.abs(pot - pot_wide).max()) <= 1e-12 * float(
        torch.abs(pot_wide).max())
    sim.main_loop_step()
    assert not bool(sim.state.neib_overflow)
