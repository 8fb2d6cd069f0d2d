"""The port's LM against the reference on reduced granite-moe (sort
dispatch, GLU experts, top-2) in float32: the reference's parameters go
through ``repro_torch.convert``, the same numpy tokens through both.
Tolerance 1e-4 on logits: three layers of float32 arithmetic summed in
another order."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.configs.base import BlockSpecEntry as JaxBlockSpecEntry
from repro.models.lm import LM as JaxLM
from repro_torch.configs import BlockSpecEntry, reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import dispatch
from repro_torch.models import LM
from repro_torch.serving import DecodePlanCache, make_provider

ARCH = "granite-moe-3b-a800m"
TOL = 1e-4


def _local_qk_norm(cfg, entry_cls):
    """Sliding-window layers with qk-norm: attention branches that
    granite-moe itself does not take."""
    return cfg.override(
        attention=dataclasses.replace(cfg.attention, qk_norm=True, window=5),
        pattern=(entry_cls(mixer="attn", ffn="ffn", attn_kind="local"),))


VARIANTS = {"granite": lambda cfg, entry_cls: cfg, "local_qk_norm": _local_qk_norm}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    variant = VARIANTS[request.param]
    jlm = JaxLM(variant(jax_reduced(ARCH).override(dtype="float32"),
                        JaxBlockSpecEntry))
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = LM(variant(reduced(ARCH).override(dtype="float32"), BlockSpecEntry))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), lm.cfg,
                             device="cpu")
    return jlm, jparams, lm, params


def test_convert_unstacks_layers(models):
    jlm, jparams, lm, params = models
    layers = params["stack"]["segments"][0]["e0"]
    assert len(layers) == lm.cfg.n_layers
    np.testing.assert_array_equal(
        layers[2]["ffn"]["we1g"].numpy(),
        np.asarray(jparams["stack"]["segments"][0]["e0"]["ffn"]["we1g"][2]))


@pytest.mark.parametrize("provider", [False, True], ids=["sort_path", "decode_plans"])
def test_paged_prefill_and_decode_logits_match_reference(models, provider):
    jlm, jparams, lm, params = models
    rng = np.random.default_rng(3)
    B, PS, CHUNK = 2, 8, 8
    prompts = rng.integers(1, lm.cfg.vocab_size, size=(B, 11))
    tables = np.arange(1, 1 + B * 3, dtype=np.int32).reshape(B, 3)
    jcache = jlm.init_paged_cache(1 + B * 3, PS)
    tcache = lm.init_paged_cache(1 + B * 3, PS, device="cpu")
    if provider:
        dispatch.set_decode_provider(make_provider(DecodePlanCache(), max_tokens=8))
    try:
        for b in range(B):
            for start in range(0, 11, CHUNK):
                ln = min(CHUNK, 11 - start)
                chunk = np.zeros((1, CHUNK), np.int64)
                chunk[0, :ln] = prompts[b, start:start + ln]
                jl, jcache = jlm.prefill_paged(
                    jparams, jnp.asarray(chunk, jnp.int32), jcache,
                    jnp.asarray(tables[b:b + 1]), jnp.int32(start), jnp.int32(ln))
                tl, tcache = lm.prefill_paged(
                    params, torch.from_numpy(chunk), tcache,
                    torch.from_numpy(tables[b:b + 1]), start, ln)
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           atol=TOL, rtol=TOL)
        tok = np.array([5, 9])
        for step in range(3):
            pos = np.full((B,), 11 + step)
            jl, jcache = jlm.decode_step_paged(
                jparams, jcache, jnp.asarray(tok, jnp.int32),
                jnp.asarray(pos, jnp.int32), jnp.asarray(tables))
            tl, tcache = lm.decode_step_paged(
                params, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
                torch.from_numpy(tables))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                          np.asarray(jl).argmax(-1))
            tok = np.asarray(jl).argmax(-1)
    finally:
        dispatch.set_decode_provider(None)


def test_contiguous_prefill_and_decode_match_reference(models):
    jlm, jparams, lm, params = models
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, lm.cfg.vocab_size, size=(2, 9))
    jcache = jlm.init_cache(2, 32)
    tcache = lm.init_cache(2, 32, device="cpu")
    jl, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(prompts, jnp.int32)},
                             jcache)
    tl, tcache = lm.prefill(params, torch.from_numpy(prompts), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    tok = np.asarray(jl).argmax(-1)
    jl, _ = jlm.decode_step(jparams, jcache, jnp.asarray(tok, jnp.int32),
                            jnp.int32(9))
    tl, _ = lm.decode_step(params, tcache, torch.from_numpy(tok), 9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


def test_serving_params_cast_weights_once_and_keep_norms(models):
    _, _, lm, params = models
    bf = LM(lm.cfg.override(dtype="bfloat16"))
    sp = bf.serving_params(params)
    layer = sp["stack"]["segments"][0]["e0"][0]
    assert layer["ffn"]["we1"].dtype == torch.bfloat16
    assert layer["attn"]["wq"].dtype == torch.bfloat16
    assert sp["emb"].dtype == torch.bfloat16
    assert layer["norm1"]["scale"].dtype == torch.float32
    assert sp["final_norm"]["scale"].dtype == torch.float32
