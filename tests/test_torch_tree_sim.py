"""Port parity: the self-gravitating grad-h SPH slice (the benchmark's
configuration, bench.build_sim(n, self_gravity=1), jittered lattice)
through the port's controller on the CPU against gandalf_tpu's
GradhSphSimulation, float64, with the tree rebuilt every 4 steps.

Also records the JAX package's own gravity accuracy against the direct
sum and its energy drift at 16^3, which chip_smoke.py's gates of the
same quantities on the card refer to."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu.ops.sph_gravity import direct_sph_gravity
from gandalf_tpu.ops.tree import tree_gravity_grouped, unwrap_to_buckets
from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu_torch.check import jittered_box_ic, slice_params
from gandalf_tpu_torch.convert import tree_spec_from_jax
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

torch.set_num_threads(1)

TOL = 1e-9
FIELDS = ("r", "v", "u", "h", "rho", "gpot")
NTB = 4
STEPS = 10


def _params(n_side):
    p = slice_params(n_side, 1.0, self_gravity=1)
    p.set("ntreebuildstep", NTB)
    return p


def _pair(n_side):
    """The two simulations after setup; the JAX one counts its tree
    plans (cadence rebuilds and overflow replans)."""
    ic = jittered_box_ic(_params(n_side), n_side)
    jsim = JaxSim(_params(n_side))
    # staged arrays take the generated IC's place (ImportArray's route)
    jsim.restart_data = {k: v.copy() for k, v in ic.items()}
    plan = jsim._plan_tree_buckets
    jsim.n_plans = 0

    def counted(*args, **kw):
        jsim.n_plans += 1
        return plan(*args, **kw)

    jsim._plan_tree_buckets = counted
    jsim.SetupSimulation()
    tsim = GradhSphSimulation(_params(n_side), device="cpu",
                              dtype=torch.float64)
    tsim.SetupSimulation({k: v.copy() for k, v in ic.items()})
    return jsim, tsim


def _errors(jsim, tsim):
    errs = {}
    for f in FIELDS:
        want = np.asarray(getattr(jsim.state, f))
        got = getattr(tsim.state, f).numpy()
        errs[f] = np.max(np.abs(got - want)) / np.max(np.abs(want))
    for f in ("t", "dt"):
        want = float(getattr(jsim.state, f))
        got = float(getattr(tsim.state, f))
        errs[f] = abs(got - want) / max(abs(want), 1e-300)
    return errs


def _counts(jsim, tsim):
    return ((jsim.n_plans, getattr(jsim, "_n_grid_overflows", 0)),
            (tsim._n_tree_plans, tsim._n_grid_overflows))


def _energy(s):
    m = np.asarray(s.m)
    return float(np.sum(m * (0.5 * np.sum(np.asarray(s.v) ** 2, -1)
                             + np.asarray(s.u)))
                 - 0.5 * np.sum(m * np.asarray(s.gpot)))


def _run(n_side):
    """Bootstrap and STEPS steps through both packages, compared after
    each; also the JAX package's gravity accuracy at the bootstrap state
    and its energy drift over the steps."""
    jsim, tsim = _pair(n_side)
    assert tree_spec_from_jax(jsim.treespec) == tsim.treespec
    out = {"errors": [_errors(jsim, tsim)],
           "counts": [_counts(jsim, tsim)],
           "accuracy": _jax_accuracy(jsim), "e0": _energy(jsim.state)}
    for _ in range(STEPS):
        jsim.main_loop_step()
        tsim.main_loop_step()
        out["errors"].append(_errors(jsim, tsim))
        out["counts"].append(_counts(jsim, tsim))
        assert tree_spec_from_jax(jsim.treespec) == tsim.treespec
    out["drift"] = abs(_energy(jsim.state) - out["e0"]) / abs(out["e0"])
    out["nsteps"] = (jsim.Nsteps, tsim.Nsteps)
    return out


def _jax_accuracy(jsim):
    """rms|a_tree - a_direct| / rms|a_direct| of the JAX package's tree
    over all particles, the direct sum at the bucket-unwrapped
    positions (what the tree approximates without an Ewald sum)."""
    s = jsim.state
    pext = [1.0, 1.0, 1.0]
    a_t, _, ovf = tree_gravity_grouped(
        jsim.treespec, s.bucket_map, s.r, s.m, s.h, jsim.kern,
        zh=s.zeta * s.hfactor, periodic_extent=pext)
    assert not bool(ovf)
    flat = s.bucket_map.reshape(-1)
    safe = jnp.maximum(flat, 0)
    in_map = flat >= 0
    r_s = jnp.where(in_map[:, None], s.r[safe], 1e15)
    r_u = np.asarray(unwrap_to_buckets(jsim.treespec, r_s, in_map, pext))
    live = np.asarray(in_map)
    r_unw = np.array(s.r)
    r_unw[np.asarray(flat)[live]] = r_u[live]
    ref = direct_sph_gravity(jsim.kern, jnp.asarray(r_unw), s.m, s.h,
                             s.zeta, s.hfactor)
    da = np.asarray(a_t) - np.asarray(ref.a)
    return float(np.sqrt(np.sum(da * da) / np.sum(np.asarray(ref.a) ** 2)))


@pytest.fixture(scope="module")
def run16():
    return _run(16)


@pytest.mark.parametrize("n_side", [8, 16])
def test_ten_steps_match_jax(n_side, request):
    """r, v, u, h, rho, gpot, t and dt within 1e-9 after the bootstrap
    and every step, with tree plans (rebuilds every 4 steps) and grid
    replans on the same steps."""
    out = request.getfixturevalue("run16") if n_side == 16 else _run(8)
    for i, (errs, (jc, tc)) in enumerate(zip(out["errors"],
                                             out["counts"])):
        assert max(errs.values()) <= TOL, (i, errs)
        assert jc == tc, (i, jc, tc)
    # the bootstrap plan, then a rebuild at steps 4 and 8
    assert out["counts"][-1][1][0] == 1 + (STEPS - 1) // NTB
    assert out["nsteps"] == (STEPS, STEPS)


def test_jax_gravity_accuracy_and_energy_drift(run16):
    """The JAX package's own values at 16^3 in float64, which
    chip_smoke.py's gates refer to: its tree against the direct sum
    (the gate is 1e-2 unless this exceeds 5e-3) and its energy drift
    over 10 steps (the gate is 1e-2 unless twice this is larger)."""
    print(f"gandalf_tpu at 16^3, float64: rms|da|/rms|a| = "
          f"{run16['accuracy']:.3e}, energy drift over {STEPS} steps = "
          f"{run16['drift']:.3e}")
    assert run16["accuracy"] <= 5e-3
    assert 2.0 * run16["drift"] <= 1e-2
