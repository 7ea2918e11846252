"""Port parity of the self-gravitating slice's options and replans: the
tree options the port does not run raise, the monopole runs like the
JAX package's, and too-small tree caps overflow and regrow as in the
JAX package (float64, CPU)."""

import dataclasses

import pytest
import torch

from gandalf_tpu.sim.simulation import GradhSphSimulation as JaxSim
from gandalf_tpu_torch.check import jittered_box_ic
from gandalf_tpu_torch.convert import tree_spec_from_jax
from gandalf_tpu_torch.sim.simulation import GradhSphSimulation

from test_torch_tree_sim import TOL, _counts, _errors, _pair, _params

torch.set_num_threads(1)


@pytest.mark.parametrize("key,value", [("ewald", 1),
                                       ("gravity_mac", "gadget2"),
                                       ("gravity_mac", "eigenmac"),
                                       ("multipole", "fast_monopole"),
                                       ("multipole", "fast_quadrupole"),
                                       ("neib_search", "octtree")])
def test_gravity_options_outside_the_slice_raise(key, value):
    p = _params(8)
    p.set(key, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GradhSphSimulation(p).process_parameters()


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
