"""The fused sigma-MoE expert MLP (``ops.moe_mlp_fused``: K1 and K2 forward;
K1, K3 and K4 backward) at the expert geometry of the paper's sigma-MoE
configs (``test_torch_paper_forward_kernels.GEOMETRY``), forward and every
gradient, against the reference's ``moe_mlp_fused`` with its Pallas kernels
in interpret mode. Routings: spread over the experts, one expert with no
rows, one expert chosen by every token (a run over two row tiles), and a
single token.

Tolerance is the reference's own for float32 gradients: 2e-4
(tests/test_kernels_cvmm_fused.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

from test_torch_paper_forward_kernels import GEOMETRY

# The reference's fused kernels raise this deprecation on current jax; it is
# not the port's and not what these tests check.
pytestmark = pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")


def _routing(routing, n, k, e, rng):
    """(tokens, expert choices) for ``routing``; distinct experts per token."""
    if routing == "skewed":
        n = 160                                    # > one 128-row tile on expert 0
        rest = np.stack([1 + rng.permutation(e - 1)[:k - 1] for _ in range(n)])
        return n, np.concatenate([np.zeros((n, 1), int), rest], 1)
    if routing == "one token":
        n = 1
    pool = [x for x in range(e) if routing != "empty expert" or x != 1]
    return n, np.stack([rng.permutation(pool)[:k] for _ in range(n)])


@pytest.mark.parametrize("arch,routing", [
    ("wt103-262m-moe", "spread"), ("wt103-262m-moe", "empty expert"),
    ("wt103-262m-moe", "skewed"), ("wt103-262m-moe", "one token"),
    ("enwik8-41m-moe", "spread"), ("enwik8-41m-moe", "empty expert"),
    ("enwik8-41m-moe", "skewed")])
def test_moe_mlp_fused_matches_reference_at_paper_geometry(arch, routing):
    n, k, e, d, g = GEOMETRY[arch]
    rng = np.random.default_rng(41)
    n, idx = _routing(routing, n, k, e, rng)
    idx = idx.astype(np.int32)
    gates = rng.random((n, k)).astype(np.float32)
    xf = rng.standard_normal((n, d)).astype(np.float32)
    w1 = (rng.standard_normal((e, d, g)) * d ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((e, g, d)) * g ** -0.5).astype(np.float32)
    cot = rng.standard_normal((n, d)).astype(np.float32)

    def jloss(xf, gates, w1, w2):
        plan = jops.make_moe_plan(jnp.asarray(idx), gates, n, e)
        y = jops.moe_mlp_fused(xf, plan, w1, w2, None, activation="relu",
                               interpret=True)
        return jnp.sum(y * cot), y

    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (xf, gates, w1, w2)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (xf, gates, w1, w2)]
    plan = ops.make_moe_plan(torch.from_numpy(idx), e, ins[1])
    y = ops.moe_mlp_fused(ins[0], plan, ins[2], ins[3], None, activation="relu")
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=2e-4, rtol=2e-4)
    for name, t, jg in zip(("x", "gates", "w1", "w2"), ins, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=2e-4,
                                   rtol=2e-4, err_msg=name)
