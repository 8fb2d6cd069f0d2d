"""The weighted value sum's autograd Functions on the port against the
reference, on the CPU, where the port runs K6's plain version:
``gathered_weighted_sum`` with the weight in K6's epilogue and outside it,
and ``gathered_weighted_sum_dedup``, forward and gradients in the values
and the weights, against the reference's Pallas rung (its streamed gather
kernel in interpret mode) and its einsum rung (take, then einsum). Inputs:
duplicate-heavy selections whose dedup plan ends in an all-sentinel tile,
and a single token.

Tolerances are the reference's own: float32 outputs 1e-5, gradients 2e-4
(tests/test_kernels_cvmm_fused.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

# The reference's gather kernel raises this deprecation on current jax; it
# is not the port's and not what these tests check.
pytestmark = pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")

D = 72
INPUTS = {"duplicates": (40, 5, 300), "one token": (1, 6, 50)}   # (N, S, rows)


def _inputs(name):
    n, s, rows = INPUTS[name]
    rng = np.random.default_rng(len(name))
    pool = rng.integers(0, rows, size=7) if name == "duplicates" else np.arange(rows)
    idx = rng.choice(pool, size=(n, s)).astype(np.int32)
    w = rng.standard_normal((n, s)).astype(np.float32)
    values = rng.standard_normal((rows, D)).astype(np.float32)
    cot = rng.standard_normal((n, D)).astype(np.float32)
    return n, rows, idx, w, values, cot


def _reference(rung, n, rows, idx, w, values, cot):
    """(y, dvalues, dweights) of the reference's rung."""
    def loss(v, wt):
        if rung == "einsum":
            y = jnp.einsum("ns,nsd->nd", wt, v[jnp.asarray(idx)])
        elif rung == "dedup":
            plan = jops.make_dedup_gather_plan(jnp.asarray(idx), wt, rows)
            y = jops.gathered_weighted_sum_dedup(v, plan, n, interpret=True)
        else:
            plan = jops.make_gather_plan(jnp.asarray(idx), wt, rows)
            y = jops.gathered_weighted_sum(v, plan, n, interpret=True,
                                           fuse_weights=rung == "fused")
        return jnp.sum(y * cot), y
    (_, y), (dv, dw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(values), jnp.asarray(w))
    return np.asarray(y), np.asarray(dv), np.asarray(dw)


@pytest.mark.parametrize("inputs", sorted(INPUTS))
@pytest.mark.parametrize("rung", ["fused", "unfused", "dedup"])
def test_weighted_sum_matches_reference(rung, inputs):
    n, rows, idx, w, values, cot = _inputs(inputs)
    v = torch.from_numpy(values).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    if rung == "dedup":
        plan = ops.make_dedup_gather_plan(torch.from_numpy(idx), wt, rows)
        y = ops.gathered_weighted_sum_dedup(v, plan, n)
    else:
        plan = ops.make_gather_plan(torch.from_numpy(idx), wt, rows)
        y = ops.gathered_weighted_sum(v, plan, n, fuse_weights=rung == "fused")
    (y * torch.from_numpy(cot)).sum().backward()
    assert y.shape == (n, D) and v.grad.shape == values.shape and wt.grad.shape == w.shape
    for ref in (rung, "einsum"):
        jy, jdv, jdw = _reference(ref, n, rows, idx, w, values, cot)
        np.testing.assert_allclose(y.detach().numpy(), jy, atol=1e-5, rtol=1e-5,
                                   err_msg=ref)
        np.testing.assert_allclose(v.grad.numpy(), jdv, atol=2e-4, rtol=2e-4, err_msg=ref)
        np.testing.assert_allclose(wt.grad.numpy(), jdw, atol=2e-4, rtol=2e-4, err_msg=ref)
    # rows no selection names get no gradient
    unused = np.setdiff1d(np.arange(rows), idx)
    assert not v.grad[torch.from_numpy(unused)].any()
