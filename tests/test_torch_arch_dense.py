"""The reference's dense, MoE and vision-prefix architectures on the port,
each at its ``reduced()`` size in float32 against the reference with the
reference's parameters carried over by ``repro_torch.convert``: logits of
the full forward, the loss, and every parameter's gradient; then prefill
on the contiguous cache and three greedy decode steps, logits against the
reference's. llama3-8b, deepseek-coder-33b and minicpm-2b are llama-like
(GQA or MHA, GLU); gemma3-27b adds 5:1 local:global attention, qk-norm
and a logit softcap; llama4-scout a top-1 sigma-MoE (sort dispatch) with a
shared expert; pixtral-12b an 8-token vision prefix ("patches").

Inputs come from numpy seeds (40 tokens: more than the reduced sliding
window of 32). Tolerances: float32 1e-4 on logits, 2e-4 on gradients
(relative to each leaf's largest, at least 1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models.lm import LM as JaxLM
from repro_torch.common import map_leaves, map_trees
from repro_torch.configs import reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import LM

LOGIT_TOL, GRAD_TOL = 1e-4, 2e-4


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=msg)


def check_arch(arch: str, seed: int = 0, seq: int = 40, decode: bool = True) -> None:
    """The port's reduced ``arch`` against the reference's, as the module
    docstring says."""
    jcfg = jax_reduced(arch).override(dtype="float32")
    cfg = reduced(arch).override(dtype="float32")
    jlm, lm = JaxLM(jcfg), LM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(seed))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(2, seq))}
    if cfg.n_vision_tokens:
        batch["patches"] = rng.standard_normal(
            (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    # forward logits at every position
    jh, _, _ = jlm.forward(jparams, jb["tokens"], prefix_embeds=jb.get("patches"),
                           frames=jb.get("frames"))
    with torch.no_grad():
        th, _, _ = lm.forward(params, tb["tokens"], prefix_embeds=tb.get("patches"),
                              frames=tb.get("frames"))
        _close(lm._unembed(params, th)[..., :cfg.vocab_size],
               np.asarray(jlm._unembed(jparams, jh))[..., :cfg.vocab_size], LOGIT_TOL,
               f"{arch} forward logits")

    # loss and gradients
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jlm.loss(p, jb, train=True), has_aux=True)(jparams)
    tparams = map_leaves(params, lambda path, t: t.clone().requires_grad_())
    tloss, tmet = lm.loss(tparams, tb, train=True)
    tloss.backward()
    _close(tloss, jloss, LOGIT_TOL, f"{arch} loss")
    _close(tmet["moe_reg"], jmet["moe_reg"], LOGIT_TOL, f"{arch} moe_reg")
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads), cfg, device="cpu")

    def grad_close(t, w):
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        scale = max(1.0, w.abs().max().item())
        torch.testing.assert_close(g / scale, w / scale, atol=GRAD_TOL, rtol=GRAD_TOL)
    map_trees(grad_close, tparams, want)

    if not decode:
        return
    # prefill on the contiguous cache, then three greedy decode steps
    max_len = seq + cfg.n_vision_tokens + 4
    jcache, tcache = jlm.init_cache(2, max_len), lm.init_cache(2, max_len, device="cpu")
    jl, jcache = jlm.prefill(jparams, jb, jcache)
    with torch.no_grad():
        tl, tcache = lm.prefill(params, tb["tokens"], tcache, patches=tb.get("patches"),
                                frames=tb.get("frames"))
    _close(tl[:, :cfg.vocab_size], np.asarray(jl)[:, :cfg.vocab_size], LOGIT_TOL,
           f"{arch} prefill logits")
    pos = seq + cfg.n_vision_tokens
    tok = np.asarray(jl)[:, :cfg.vocab_size].argmax(-1)
    for step in range(3):
        jl, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(tok, jnp.int32),
                                     jnp.int32(pos))
        with torch.no_grad():
            tl, tcache = lm.decode_step(params, tcache, torch.from_numpy(tok), pos)
        _close(tl[:, :cfg.vocab_size], np.asarray(jl)[:, :cfg.vocab_size], LOGIT_TOL,
               f"{arch} decode step {step}")
        tok = np.asarray(jl)[:, :cfg.vocab_size].argmax(-1)
        pos += 1


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-coder-33b", "minicpm-2b",
                                  "gemma3-27b", "llama4-scout-17b-a16e", "pixtral-12b"])
def test_reduced_arch_matches_reference(arch):
    check_arch(arch)
