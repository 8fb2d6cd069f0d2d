"""K1 (fused_w1) and K2 (fused_w2), the sigma-MoE forward's kernels, at the
expert geometry of the paper's sigma-MoE configs: wt103-262m-moe (d_model
1024, 32 experts of 128, top-4) and enwik8-41m-moe (d_model 512, 16
experts of 128, top-4), with few tokens and one expert that gets no rows.
The port's plain versions (what the wrappers run on CPU tensors) against
the reference's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances are the reference's own: float32 1e-5, bf16 3e-2
(tests/test_kernels_cvmm.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.cvmm import cvmm_fused_w1_pallas, cvmm_fused_w2_pallas
from repro_torch.kernels import cvmm as K

# The reference's fused kernel raises this deprecation on current jax; it is
# not the port's and not what these tests check.
pytestmark = pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")

# arch: (tokens, top-k, experts, d_model, expert size)
GEOMETRY = {"wt103-262m-moe": (48, 4, 32, 1024, 128),
            "enwik8-41m-moe": (40, 4, 16, 512, 128)}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def routed(arch, seed):
    """Distinct top-k experts per token, never expert 1, random gates: the
    reference's plan and the geometry."""
    n, k, e, d, g = GEOMETRY[arch]
    rng = np.random.default_rng(seed)
    pool = [x for x in range(e) if x != 1]
    idx = np.stack([rng.permutation(pool)[:k] for _ in range(n)]).astype(np.int32)
    gates = rng.random((n, k)).astype(np.float32)
    plan = jops.make_moe_plan(jnp.asarray(idx), jnp.asarray(gates), n, e)
    return plan, rng, (n, e, d, g)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("arch,dtype,save", [
    ("wt103-262m-moe", "float32", True), ("wt103-262m-moe", "bfloat16", True),
    ("wt103-262m-moe", "float32", False), ("enwik8-41m-moe", "float32", True),
    ("enwik8-41m-moe", "bfloat16", True)])
def test_fused_w1_plain_matches_pallas_at_paper_geometry(arch, dtype, save):
    jdt, tdt, tol = DTYPES[dtype]
    plan, rng, (n, e, d, g) = routed(arch, 21)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w1 = (rng.standard_normal((e, d, g)) * d ** -0.5).astype(np.float32)
    want = cvmm_fused_w1_pallas(jnp.asarray(x, jdt), plan.row_src, plan.run_start,
                                plan.run_off, plan.tile_expert, jnp.asarray(w1, jdt),
                                None, act_name="relu", save_preact=save, interpret=True)
    got = K.fused_w1(_t(x, tdt), _t(plan.row_src), _t(plan.tile_expert), _t(w1, tdt),
                     act="relu", save_preact=save)
    want, got = (want, got) if save else ((want,), (got,))
    assert len(got) == len(want) == 1 + save
    for g_, w_ in zip(got, want):
        assert g_.dtype == tdt
        np.testing.assert_allclose(g_.float().numpy(), np.asarray(w_, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", GEOMETRY)
def test_fused_w2_plain_matches_pallas_at_paper_geometry(arch):
    plan, rng, (n, e, d, g) = routed(arch, 22)
    u = rng.standard_normal((plan.m_pad, g)).astype(np.float32)
    w2 = (rng.standard_normal((e, g, d)) * g ** -0.5).astype(np.float32)
    want = cvmm_fused_w2_pallas(jnp.asarray(u), plan.tile_expert, jnp.asarray(w2),
                                plan.gate_tiles, interpret=True)
    got = K.fused_w2(_t(u), _t(plan.tile_expert), _t(w2),
                     _t(plan.gate_tiles).reshape(-1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
