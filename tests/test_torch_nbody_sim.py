"""Port parity: the pure N-body controller (gandalf_tpu_torch/sim/
nbody_sim.py) on the CPU against gandalf_tpu's NbodySimulation, float64,
10 steps each through main_loop_step from the same generated ICs:

- a 2D circular binary under hermite4, unsoftened;
- a 256-star Plummer cluster (the plummer_cluster configuration cut to
  256 stars) under hermite4 softened and unsoftened, hermite4ts,
  hermite6ts (unsoftened), lfkdk and lfdkd, and with the plummer external
  potential;
- the hierarchical triple with sub_systems = 1, whose members are
  collapsed onto their centre of mass and integrated on the host, and a
  64-star cluster holding a tight bound binary that becomes a sub-system
  among 62 other stars.

r, v, a, adot, gpot, t and dt agree within 1e-9 relative (of each
field's largest value), and the sub-system runs' absolute member
coordinates too.  Snapshot times lie beyond every run, so the JAX
controller's dt is clamped by tend only, as the port's is.  Also: the
factory's device and dtype defaults and its Nmpi rule, and the JAX
package's own energy drift over 32 steps of plummer_cluster at 1,024
stars, which chip_smoke.py's energy gate refers to."""

import numpy as np
import pytest
import torch

from gandalf_tpu.params import Parameters as JaxParameters
from gandalf_tpu.sim.simulation import SimulationBase as JaxBase
from gandalf_tpu_torch.check import nbody_energy, nbody_params
from gandalf_tpu_torch.sim.nbody_sim import NbodySimulation
from gandalf_tpu_torch.sim.simulation import SimulationBase

torch.set_num_threads(1)

TOL = 1e-9
STEPS = 10
FIELDS = ("r", "v", "a", "adot", "gpot")
# chip_smoke.py's energy gate for plummer_cluster over its 32 timed steps
NBODY_ENERGY_GATE = 1e-7

BINARY = {"ic": "binary", "ndim": 2, "abin": 1.0, "ebin": 0.0, "m1": 0.5,
          "m2": 0.5, "nbody_softening": 0}
TRIPLE = {"ic": "triple", "abin": 4.0, "ebin": 0.2, "abin2": 0.5,
          "m3": 1.0, "nbody_softening": 0, "sub_systems": 1, "tend": 0.5,
          "nbody_mult": 0.05}
RUNS = {
    "binary_hermite4": (2, BINARY),
    "plummer_hermite4_softened": (256, {}),
    "plummer_hermite4_unsoftened": (256, {"nbody_softening": 0}),
    "plummer_hermite4ts": (256, {"nbody": "hermite4ts"}),
    "plummer_hermite6ts": (256, {"nbody": "hermite6ts",
                                 "nbody_softening": 0}),
    "plummer_lfkdk": (256, {"nbody": "lfkdk"}),
    "plummer_lfdkd": (256, {"nbody": "lfdkd", "nbody_softening": 0}),
    "plummer_extpot": (256, {"external_potential": "plummer",
                             "mplummer": 1.0, "rplummer": 1.0}),
    "triple_subsystems": (3, TRIPLE),
}


def _jax_params(port_params):
    q = JaxParameters()
    for table in ("intparams", "floatparams", "stringparams"):
        getattr(q, table).update(getattr(port_params, table))
    return q


def _errors(jsim, tsim):
    errs = {}
    for f in FIELDS:
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        errs[f] = np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-300)
    for f in ("t", "dt"):
        want = float(getattr(jsim.state, f))
        errs[f] = abs(float(getattr(tsim.state, f)) - want) / abs(want)
    return errs


def _run_pair(n, overrides, ic=None, steps=STEPS, each_step=None):
    """Both controllers set up from one IC (generated, or `ic`) and
    stepped `steps` times; `each_step(jsim, tsim)` is called after each
    step."""
    p = nbody_params(n, **overrides)
    jsim = JaxBase.factory(_jax_params(p))
    if ic is not None:
        with pytest.MonkeyPatch.context() as mp:
            from gandalf_tpu.sim import nbody_sim as jax_nbody

            mp.setattr(jax_nbody, "generate_nbody_ic",
                       lambda params: {k: v.copy() for k, v in ic.items()})
            jsim.SetupSimulation()
    else:
        jsim.SetupSimulation()
    tsim = SimulationBase.factory(p, "cpu")
    tsim.SetupSimulation(None if ic is None
                         else {k: v.copy() for k, v in ic.items()})
    for _ in range(steps):
        jsim.main_loop_step()
        tsim.main_loop_step()
        if each_step is not None:
            each_step(jsim, tsim)
    return jsim, tsim


@pytest.mark.parametrize("run", list(RUNS))
def test_ten_steps_match_jax(run):
    n, overrides = RUNS[run]
    jsim, tsim = _run_pair(n, overrides)
    errs = _errors(jsim, tsim)
    assert max(errs.values()) <= TOL, errs
    assert tsim.Nsteps == jsim.Nsteps == STEPS
    assert tsim.t == pytest.approx(jsim.t, rel=TOL)
    if overrides.get("sub_systems"):
        # the members' own orbits, integrated on the host
        for want, got in zip(jsim._absolute_state(),
                             tsim._absolute_state()):
            scale = np.max(np.abs(want))
            assert np.max(np.abs(got - want)) / scale <= TOL
        assert [s.members for s in tsim.subsystems] \
            == [s.members for s in jsim.subsystems]


def test_binary_in_a_cluster_is_a_subsystem():
    """A tight bound binary (separation 5e-4, its internal energy within
    gpefrac of its stars' whole potential energy) among 62 Plummer stars:
    the controllers find the same sub-systems at every rebuild; on the
    steps where they are collapsed the members share one position (the
    plain kernels mask the coincident pairs) and their orbits are
    integrated on the host with the rest of the cluster as perturbers.
    Ten steps agree with the JAX controller, the members' absolute
    coordinates included."""
    from gandalf_tpu_torch.sim.ic import generate_nbody_ic

    overrides = {"nbody_softening": 0, "sub_systems": 1}
    ic = generate_nbody_ic(nbody_params(64, **overrides))
    sep = 5e-4
    vrel = np.sqrt((ic["m"][0] + ic["m"][1]) / sep)     # a circular orbit
    ic["r"][1] = ic["r"][0] + [sep, 0.0, 0.0]
    ic["v"][1] = ic["v"][0] + [0.0, vrel, 0.0]
    found = []

    def each_step(jsim, tsim):
        mine = [s.members for s in tsim.subsystems]
        assert mine == [s.members for s in jsim.subsystems]
        for members in mine:
            if {0, 1} <= set(members):
                found.append(members)
                assert bool(torch.equal(tsim.state.r[0], tsim.state.r[1]))

    jsim, tsim = _run_pair(64, overrides, ic=ic, each_step=each_step)
    assert found, "the binary never became a sub-system"
    errs = _errors(jsim, tsim)
    assert max(errs.values()) <= TOL, errs
    for want, got in zip(jsim._absolute_state(), tsim._absolute_state()):
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= TOL


def test_factory_defaults_and_nmpi():
    """sim = nbody: the card and float64 unless asked otherwise; without
    a CUDA device setup raises; Nmpi = 2 gives the same controller and
    the same run (the star set is replicated on every rank)."""
    sim = SimulationBase.factory(nbody_params(8))
    assert isinstance(sim, NbodySimulation)
    assert sim.device.type == "cuda" and sim.dtype == torch.float64
    assert SimulationBase.factory(nbody_params(8), "cpu",
                                  torch.float32).dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sim.SetupSimulation()
        assert sim.state is None
    runs = []
    for nmpi in (1, 2):
        p = nbody_params(2, nbody_softening=0, Nmpi=nmpi, tend=1.0,
                         **{k: v for k, v in BINARY.items()
                            if k != "nbody_softening"})
        s = SimulationBase.factory(p, "cpu")
        assert type(s) is NbodySimulation
        s.SetupSimulation()
        s.Run(Nadvance=20)
        runs.append(s.state.r.clone())
    assert torch.equal(runs[0], runs[1])


def test_refused_options():
    """Options outside the slice raise NotImplementedError naming their
    ROADMAP item."""
    for over, item in (({"nbody": "hermite6"}, "item 11"),
                       ({"ndim": 1}, "item 11"),
                       ({"kernel": "quintic"}, "item 9"),
                       ({"ic": "file"}, "item 9")):
        sim = SimulationBase.factory(nbody_params(16, **over), "cpu")
        with pytest.raises(NotImplementedError, match=item):
            sim.SetupSimulation()


def test_run_stops_at_tend():
    """Run() through main_loop_steps: the last step is clamped to land on
    tend, as in the JAX package."""
    p = nbody_params(2, tend=0.75, **BINARY)
    sim = SimulationBase.factory(p, "cpu")
    sim.Run()
    assert sim.t == pytest.approx(0.75, rel=1e-12)
    jsim = JaxBase.factory(_jax_params(p))
    jsim.SetupSimulation()
    while jsim.t < 0.75:
        jsim.main_loop_step()
    assert sim.Nsteps == jsim.Nsteps


@pytest.mark.parametrize("route", ["main_loop_step", "Run"])
def test_snapshot_times_clamp_dt_like_jax(route):
    """ROADMAP fault F10: with the default snapshot times (tsnapfirst =
    dt_snap = 0.2) the step that crosses a snapshot time is shortened to
    land on it, as in the JAX package.  Through main_loop_step only the
    first snapshot time clamps (nothing advances it); through Run each
    multiple of 0.2 does.  The binary's steps of about 0.1 cross t = 0.2
    within a few steps."""
    p = nbody_params(2, tend=0.75, **dict(BINARY, tsnapfirst=0.2,
                                          dt_snap=0.2))
    jsim = JaxBase.factory(_jax_params(p))
    jsim.SetupSimulation()
    tsim = SimulationBase.factory(p, "cpu")
    tsim.SetupSimulation()
    if route == "Run":
        jsim.Run()
        tsim.Run()
        landed = [0.2, 0.4, 0.6, 0.75]
    else:
        for _ in range(10):
            jsim.main_loop_step()
            tsim.main_loop_step()
        landed = [0.2]
    assert tsim.Nsteps == jsim.Nsteps
    assert max(_errors(jsim, tsim).values()) <= TOL
    assert tsim.tsnapnext == pytest.approx(jsim.tsnapnext, rel=1e-12)
    # the clamp did shorten a step: re-run the port and record each t
    ts = []
    tsim = SimulationBase.factory(p, "cpu")
    tsim.SetupSimulation()
    while len(ts) < jsim.Nsteps:
        tsim.main_loop_step()
        if route == "Run":
            tsim.output()
        ts.append(tsim.t)
    for t in landed:
        assert min(abs(x - t) for x in ts) <= 1e-12, (t, ts)


def test_jax_energy_drift_is_inside_the_chip_gate():
    """The JAX package's own drift of E = sum m v^2/2 - sum m gpot/2 over
    32 steps of plummer_cluster cut to 1,024 stars (float64, on the
    CPU): 1.9e-9.  chip_smoke.py gates the card's 65,536-star run over 32
    steps at NBODY_ENERGY_GATE, about 50 times that: the step there is
    set by the tightest of 64 times as many stars, and its float64 sums
    have 64 times as many terms.  The port's plain path drifts by the
    same amount."""
    p = nbody_params(1024)
    jsim = JaxBase.factory(_jax_params(p))
    jsim.SetupSimulation()
    tsim = SimulationBase.factory(p, "cpu")
    tsim.SetupSimulation()
    e0 = (nbody_energy(_as_torch(jsim.state)), nbody_energy(tsim.state))
    for _ in range(32):
        jsim.main_loop_step()
        tsim.main_loop_step()
    drift_j = abs(nbody_energy(_as_torch(jsim.state)) - e0[0]) / abs(e0[0])
    drift_t = abs(nbody_energy(tsim.state) - e0[1]) / abs(e0[1])
    assert drift_j < NBODY_ENERGY_GATE / 20
    assert drift_t == pytest.approx(drift_j, rel=1e-3)


def _as_torch(jax_state):
    from gandalf_tpu_torch.convert import nbody_state_from_jax

    return nbody_state_from_jax(jax_state)
