"""Port parity: sinks and stars through the port's GradhSphSimulation on
the CPU against gandalf_tpu's, float64.

- the Boss-Bodenheimer cloud (examples/bossbodenheimer.dat) with a random
  particle distribution at 500 particles and rho_sink lowered to 2e-17
  g cm^-3, so that sinks form and accrete from the first step;
- the hybrid Plummer sphere (256 gas, 8 stars, sink_particles = 1,
  create_sinks = 0, neib_search = kdtree) with star-gas gravity and
  accretion;
- 5 steps of a uniform sphere under each ported EOS (isothermal,
  barotropic, polytropic);
- the overflow rewind of a step with sinks, a burst with sinks against
  single steps, and check.sink_ledger's balance over a burst (port
  only).

Each run holds the alive fields, the gas alive masks and the sink slots
to 1e-9 of each field's largest value, with equal sinks created at equal
steps.  A dead particle's gpot is the tree's potential at its frozen
position in both packages (ROADMAP fault F12), so gpot is compared over
every particle; dead particles' other fields are equal.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu_torch.check import bb_params, ledger_errors, sink_ledger
from gandalf_tpu_torch.params import Parameters
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

torch.set_num_threads(1)

TOL = 1e-9
FIELDS = ("r", "v", "u", "h", "rho", "gpot")
SINK_FIELDS = ("r", "v", "a", "m", "mdot")
REPO = Path(__file__).resolve().parents[1]


def _both(params):
    """The same parameters as a JAX and a port Parameters object."""
    jp = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(jp, table).update(getattr(params, table))
    return jp, params.copy()


def _bb(n=500):
    p = bb_params(n, rho_sink=2.0e-17)
    p.set("particle_distribution", "random")
    p.set("rand_algorithm", "default")
    return p


def _plummer():
    p = Parameters()
    for k, v in dict(run_id="", sim="sph", ndim=3, ic="plummer",
                     Nhydro=256, Nstar=8, gasfrac=0.5, starfrac=0.5,
                     self_gravity=1, hydro_forces=1, dimensionless=1,
                     gas_eos="energy_eqn", neib_search="kdtree",
                     sink_particles=1, create_sinks=0, tsnapfirst=1e30,
                     tend=1e30).items():
        p.set(k, v)
    return p


def _sphere(eos):
    p = Parameters()
    for k, v in dict(run_id="", sim="sph", ndim=3, ic="sphere",
                     Nhydro=400, particle_distribution="cubic_lattice",
                     mcloud=1.0, radius=1.0, dimensionless=1,
                     gas_eos=eos, temp0=1.0, mu_bar=1.0, rho_bary=0.5,
                     Kpoly=1.0, eta_eos=1.4, self_gravity=0,
                     neib_search="kdtree", tsnapfirst=1e30,
                     tend=1e30).items():
        p.set(k, v)
    return p


def _setup(params):
    jp, tp = _both(params)
    jsim = JaxSim(jp)
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(tp, device="cpu", dtype=torch.float64)
    tsim.SetupSimulation()
    return jsim, tsim


def _compare(jsim, tsim, where):
    """Largest error of each field relative to its largest value over
    the alive particles (gpot over all), and of the sinks' fields; equal
    alive masks and active slots."""
    alive = np.asarray(jsim.state.alive)
    assert np.array_equal(tsim.state.alive.numpy(), alive), where
    errs = {}
    for f in FIELDS:
        rows = slice(None) if f == "gpot" else alive
        want = np.asarray(getattr(jsim.state, f))[rows]
        got = getattr(tsim.state, f).numpy()[rows]
        errs[f] = (np.max(np.abs(got - want))
                   / max(np.max(np.abs(want)), 1e-300))
    for f in ("m", "v", "a"):
        dead = ~alive
        want = np.asarray(getattr(jsim.state, f))[dead]
        assert np.array_equal(getattr(tsim.state, f).numpy()[dead],
                              want), (where, f)
    for f in ("t", "dt"):
        want = float(getattr(jsim.state, f))
        errs[f] = (abs(float(getattr(tsim.state, f)) - want)
                   / max(abs(want), 1e-300))
    if getattr(jsim, "has_sinks", False):
        js, ts = jsim.sinks, tsim.state.sinks
        assert np.array_equal(ts.active.numpy(), np.asarray(js.active)), \
            where
        for f in SINK_FIELDS:
            want = np.asarray(getattr(js, f))
            scale = max(np.max(np.abs(want)), 1e-300)
            errs[f"sink_{f}"] = (np.max(np.abs(getattr(ts, f).numpy()
                                               - want)) / scale)
    bad = {k: e for k, e in errs.items() if not e <= TOL}
    assert not bad, f"{where}: {bad}"


def _run(jsim, tsim, steps):
    _compare(jsim, tsim, "bootstrap")
    created = []
    for i in range(steps):
        jsim.main_loop_step()
        tsim.main_loop_step()
        _compare(jsim, tsim, f"step {i + 1}")
        created.append(int(tsim.state.sinks.active.sum())
                       if tsim.has_sinks else 0)
    return created


def test_bb_random_creates_and_accretes_like_jax():
    """6 steps of a random Boss-Bodenheimer cloud of 500 particles in
    physical units: a sink forms in each step and eats gas, the same
    sinks at the same steps in both packages; gas plus sink mass holds.
    The code-unit sound speed agrees at setup (temp0, mu_bar, rho_bary
    and rho_sink through inscale_parameters)."""
    jsim, tsim = _setup(_bb())
    assert tsim.sink_cfg.rho_sink == pytest.approx(jsim.sink_cfg.rho_sink,
                                                   rel=1e-15)
    created = _run(jsim, tsim, 6)
    assert created == [1, 2, 3, 4, 5, 6]
    assert int((~tsim.state.alive).sum()) > 6
    s = tsim.state
    total = float(s.m.sum() + s.sinks.m.sum())
    assert total == pytest.approx(1.0, rel=1e-12)


def test_hybrid_plummer_matches_jax():
    """5 steps of the hybrid Plummer sphere (256 gas, 8 stars from the
    IC, accretion on, creation off) on the grid path with tree gravity:
    star-gas gravity, star-star gravity and accretion as in the JAX
    package."""
    jsim, tsim = _setup(_plummer())
    assert tsim.state.sinks.N == 8 and bool(tsim.state.sinks.active.all())
    _run(jsim, tsim, 5)
    assert int((~tsim.state.alive).sum()) > 0


@pytest.mark.parametrize("eos", ["isothermal", "barotropic", "polytropic"])
def test_eos_sphere_matches_jax(eos):
    """5 steps of a 400-particle uniform sphere under each EOS: u comes
    from rho (no energy integration), as in the JAX package."""
    jsim, tsim = _setup(_sphere(eos))
    assert not tsim.integ.energy_integration
    _run(jsim, tsim, 5)


def test_bb_overflow_rewind_restores_the_sinks():
    """A forced overflow in the third step of a sink run: the step is
    redone from the pre-step state with the sinks rewound, so no gas is
    eaten twice: the same gas is eaten by the same sinks, with the same
    sink masses, as in a run whose grid never overflowed.  (The replanned
    grid moves h within h_converge, so positions agree only to that.)"""
    sims = []
    for _ in range(2):
        sim = GradhSphSimulation(_bb(300), device="cpu",
                                 dtype=torch.float64)
        sim.SetupSimulation()
        sims.append(sim)
    ref, sim = sims
    for i in range(4):
        if i == 2:
            sim.gridspec = dataclasses.replace(
                sim.gridspec, k_cell=sim.gridspec.k_cell // 4)
        ref.main_loop_step()
        sim.main_loop_step()
    assert sim._n_grid_overflows == ref._n_grid_overflows + 1
    assert torch.equal(sim.state.alive, ref.state.alive)
    assert torch.equal(sim.state.sinks.active, ref.state.sinks.active)
    torch.testing.assert_close(sim.state.sinks.m, ref.state.sinks.m,
                               rtol=1e-12, atol=0.0)
    total = float(sim.state.m.sum() + sim.state.sinks.m.sum())
    assert total == pytest.approx(1.0, rel=1e-12)


def test_bb_burst_matches_single_steps():
    """A burst of 4 steps with sinks (nothing read back between steps)
    gives exactly the result of 4 single steps."""
    sims = []
    for _ in range(2):
        sim = GradhSphSimulation(_bb(300), device="cpu",
                                 dtype=torch.float64)
        sim.SetupSimulation()
        sims.append(sim)
    burst, single = sims
    assert burst.main_loop_steps(4) == 4
    for _ in range(4):
        single.main_loop_step()
    for f in ("r", "v", "rho", "h", "m", "flags", "t", "dt"):
        assert torch.equal(getattr(burst.state, f),
                           getattr(single.state, f)), f
    for f in ("r", "v", "m", "active", "mdot"):
        assert torch.equal(getattr(burst.state.sinks, f),
                           getattr(single.state.sinks, f)), f


def test_sink_ledger_balances_over_a_burst():
    """check.sink_ledger over a burst of 4 steps with creation: the
    references it keeps hold each call's values (the step never writes
    its inputs), so each call's sink gain in mass and momentum equals
    what the gas that died carried, to float64 roundoff.  A call of a
    try that overflowed and was redone is recorded too."""
    sim = GradhSphSimulation(_bb(300), device="cpu", dtype=torch.float64)
    sim.SetupSimulation()
    rows = sink_ledger(sim)
    assert sim.main_loop_steps(4) == 4
    em, ep, m_dead = ledger_errors(rows)
    assert len(em) >= 4 and min(m_dead) > 0.0
    assert max(em + ep) <= 1e-12

