"""The reference's ten assigned architectures in the port's registry:
``ASSIGNED_ARCHS`` and ``list_archs()``, each config equal to the
reference's field by field (full and ``reduced()``, whose SSM,
encoder-decoder and vision branches the port copies), the analytic
``param_counts`` equal, and each arch's parameter count (the port's on the
meta device, the reference's by ``jax.eval_shape`` of its init) equal, so
no full-size parameter is allocated. Then K7 at zamba2-7b's head size 112
on the CPU: ``flash_schedule``'s items and splits, and the plain version
against the reference's pure-JAX ``flash_attention`` (float32 5e-5, bf16
3e-2, the reference oracle's tolerances)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs import reduced as jax_reduced
from repro.models.attention import flash_attention as jax_flash_attention
from repro.models.lm import LM as JaxLM
from repro_torch.common import tree_leaves
from repro_torch.configs import ASSIGNED_ARCHS, get_config, list_archs, reduced
from repro_torch.kernels import flash_attention as K7
from repro_torch.models import LM


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_assigned_archs_equal_the_reference(reduce):
    assert ASSIGNED_ARCHS == JAX_ASSIGNED and list_archs() == jax_list_archs()
    get, jget = (reduced, jax_reduced) if reduce else (get_config, jax_get_config)
    for arch in list_archs():
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), arch
        assert cfg.param_counts() == jcfg.param_counts(), arch
        assert ([dataclasses.asdict(e) for e in cfg.layer_pattern()]
                == [dataclasses.asdict(e) for e in jcfg.layer_pattern()]), arch
        if cfg.ssm is not None:
            assert (cfg.ssm.d_inner(cfg.d_model), cfg.ssm.n_heads(cfg.d_model)) == (
                jcfg.ssm.d_inner(cfg.d_model), jcfg.ssm.n_heads(cfg.d_model))


@pytest.mark.parametrize("archs", [ASSIGNED_ARCHS[:5], ASSIGNED_ARCHS[5:]],
                         ids=["first_five", "last_five"])
def test_parameter_counts_equal_eval_shape(archs):
    for arch in archs:
        shapes = jax.eval_shape(JaxLM(jax_get_config(arch)).init, jax.random.PRNGKey(0))
        want = sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes))
        params = LM(get_config(arch)).init(torch.Generator().manual_seed(0), device="meta")
        assert all(p.is_meta for p in tree_leaves(params))
        assert sum(p.numel() for p in tree_leaves(params)) == want, arch


def test_flash_at_head_size_112_matches_reference():
    """zamba2's 32 heads on 32 KV heads of 112 at a 96-row chunk at
    q_offset 160 over 300 keys with kv_len (256, 300), causal and not; the
    bf16 schedule at 132 SMs of its 600-row prefill and of serve-long's
    256-row chunk at 3,072."""
    rng = np.random.default_rng(112)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 96, 32, 112), (2, 300, 32, 112), (2, 300, 32, 112)))
    kv_len = np.array([256, 300])
    for causal in (True, False):
        kw = dict(causal=causal, scale=112 ** -0.5, q_offset=160)
        for dt, jdt, tol in ((torch.float32, jnp.float32, 5e-5),
                             (torch.bfloat16, jnp.bfloat16, 3e-2)):
            want = jax_flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                       kv_chunk=64, kv_len=jnp.asarray(kv_len), **kw)
            got = K7.flash_attention_plain(*(torch.from_numpy(a).to(dt) for a in (q, k, v)),
                                           kv_chunk=64, kv_len=torch.from_numpy(kv_len), **kw)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       atol=tol, rtol=tol)
    assert 112 in K7.HEAD_DIMS and K7.FLASH_BK[112] == 64
    # 600 rows of one head a KV head: 5 row tiles a KV head, 160 items (more
    # than 132 SMs), so one split; a 256-row chunk at 3,072: 64 items of 2.
    assert K7.flash_schedule(4, 600, 32, 32, 600, 0, True, 132, 64) == (128, 640, 1, 640)
    assert K7.flash_schedule(1, 256, 32, 32, 3328, 3072, True, 132, 64) == (128, 64, 2, 128)
