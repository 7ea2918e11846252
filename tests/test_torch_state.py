"""Port parity: SphState carries across from the JAX package field by
field, and DomainBox.wrap/min_image agree (float64, CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandalf_tpu import state as jstate
from gandalf_tpu_torch import state as tstate
from gandalf_tpu_torch.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(1)


def _ic(n=64, ndim=3, seed=3):
    rng = np.random.default_rng(seed)
    return dict(r=rng.uniform(0.0, 1.0, (n, ndim)),
                v=rng.standard_normal((n, ndim)),
                m=rng.uniform(0.5, 1.5, n), h=rng.uniform(0.05, 0.1, n),
                u=rng.uniform(1.0, 2.0, n))


def _jax_fields(s):
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s) if getattr(s, f.name) is not None}


def test_state_round_trips_field_by_field():
    ic = _ic()
    js = jstate.make_sph_state(**ic)
    # give every float field distinct values so a swapped field shows
    rng = np.random.default_rng(4)
    js = js.replace(**{
        k: jnp.asarray(rng.standard_normal(np.shape(getattr(js, k))))
        for k in ("a", "r0", "v0", "a0", "rho", "dudt", "pressure",
                  "invomega", "zeta", "hfactor", "div_v", "gpot")})
    fields = _jax_fields(js)
    ts = state_from_numpy(fields, device="cpu", dtype=torch.float64)
    back = state_to_numpy(ts)
    assert set(back) == set(fields)
    for k, x in fields.items():
        assert back[k].shape == x.shape, k
        assert back[k].dtype.kind == x.dtype.kind, k
        np.testing.assert_array_equal(back[k], x, err_msg=k)
    assert ts.N == js.N and ts.ndim == js.ndim
    assert torch.equal(ts.alive, torch.tensor(np.array(js.alive)))


def test_make_sph_state_matches():
    ic = _ic()
    js = _jax_fields(jstate.make_sph_state(**ic))
    ts = state_to_numpy(tstate.make_sph_state(**ic, device="cpu",
                                              dtype=torch.float64))
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


BOXES = {
    "periodic": (("periodic",) * 3, ("periodic",) * 3),
    "mixed": (("periodic", "open", "periodic"),
              ("periodic", "open", "periodic")),
    "open": (("open",) * 3, ("open",) * 3),
}


@pytest.mark.parametrize("kind", sorted(BOXES))
def test_domain_box_wrap_and_min_image(kind):
    lhs, rhs = BOXES[kind]
    codes = {"periodic": jstate.PERIODIC, "open": jstate.OPEN}
    args = (3, (-0.5, 0.0, 1.0), (0.5, 2.0, 4.0),
            tuple(codes[b] for b in lhs), tuple(codes[b] for b in rhs))
    jb, tb = jstate.DomainBox(*args), tstate.DomainBox(*args)
    assert tb.periodic_dims() == jb.periodic_dims()
    assert tb.mirror_walls() == jb.mirror_walls()
    rng = np.random.default_rng(5)
    r = rng.uniform(-3.0, 6.0, (500, 3))
    dr = rng.uniform(-5.0, 5.0, (500, 3))
    np.testing.assert_allclose(
        tb.wrap(torch.as_tensor(r)).numpy(), np.asarray(jb.wrap(
            jnp.asarray(r))), rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        tb.min_image(torch.as_tensor(dr)).numpy(), np.asarray(
            jb.min_image(jnp.asarray(dr))), rtol=0, atol=1e-14)


def test_domain_box_reflect():
    codes = (jstate.MIRROR, jstate.OPEN, jstate.WALL)
    args = (3, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), codes, codes)
    jb, tb = jstate.DomainBox(*args), tstate.DomainBox(*args)
    rng = np.random.default_rng(6)
    r = rng.uniform(-0.2, 1.2, (300, 3))
    v = rng.standard_normal((300, 3))
    jr, jv = jb.reflect(jnp.asarray(r), jnp.asarray(v))
    tr, tv = tb.reflect(torch.as_tensor(r), torch.as_tensor(v))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
