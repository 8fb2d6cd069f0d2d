"""K1's backward use (t0 = dy W2^T, identity activation) and K3
(dw_streamed: dW1 streaming x, dW2 streaming dy, with and without the
gate), the sigma-MoE backward's kernels, at the expert geometry of the
paper's sigma-MoE configs (``test_torch_paper_forward_kernels.GEOMETRY``),
with one expert that gets no rows. The port's plain versions against the
reference's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerance is the reference's own for float32: 1e-5
(tests/test_kernels_cvmm_fused.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.cvmm import cvmm_dw_streamed_pallas, cvmm_fused_w1_pallas
from repro_torch.kernels import cvmm as K

from test_torch_paper_forward_kernels import GEOMETRY, routed

# The reference's streamed kernels raise this deprecation on current jax; it
# is not the port's and not what these tests check.
pytestmark = pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", GEOMETRY)
def test_t0_plain_matches_pallas_at_paper_geometry(arch):
    plan, rng, (n, e, d, g) = routed(arch, 31)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    w2t = (rng.standard_normal((e, d, g)) * d ** -0.5).astype(np.float32)
    want = cvmm_fused_w1_pallas(jnp.asarray(dy), plan.row_src, plan.run_start,
                                plan.run_off, plan.tile_expert, jnp.asarray(w2t), None,
                                act_name="identity", interpret=True)
    got = K.fused_w1(_t(dy), _t(plan.row_src), _t(plan.tile_expert), _t(w2t),
                     act="identity")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch,variant", [
    ("wt103-262m-moe", "stream_x"), ("wt103-262m-moe", "stream_g"),
    ("wt103-262m-moe", "stream_g_gate"), ("enwik8-41m-moe", "stream_x"),
    ("enwik8-41m-moe", "stream_g_gate")])
def test_dw_streamed_plain_matches_pallas_at_paper_geometry(arch, variant):
    plan, rng, (n, e, d, g) = routed(arch, 32)
    stream_x = variant == "stream_x"
    unsorted = rng.standard_normal((n, d)).astype(np.float32)
    aligned = rng.standard_normal((plan.m_pad, g)).astype(np.float32)
    x, dy = (unsorted, aligned) if stream_x else (aligned, unsorted)
    gate = plan.gate_tiles if variant == "stream_g_gate" else None
    want = jops._mask_empty(cvmm_dw_streamed_pallas(
        jnp.asarray(x), jnp.asarray(dy), plan.row_src, plan.run_start, plan.run_off,
        plan.tile_expert, e, stream_x=stream_x, gate_tiles=gate, interpret=True),
        plan.group_sizes)
    got = K.dw_streamed(_t(x), _t(dy), _t(plan.row_src), _t(plan.tile_expert), e,
                        stream_x=stream_x,
                        gate=None if gate is None else _t(gate).reshape(-1))
    assert got.dtype == torch.float32 and bool((got[1] == 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
