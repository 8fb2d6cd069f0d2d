"""The baselines' routing on the port against the reference, on the CPU:
Sinkhorn (values and marginals), S-BASE's selection in training and in
eval with padded experts, and noisy top-k gating. Seeded numpy inputs,
float32, expert dropout off; tolerances are the reference's (1e-5 for
values, 2e-4 for gradients) and integer fields are bit-equal.

The port draws gating noise from a ``torch.Generator``, JAX from its own
key, so noisy gating in training is held against the reference's selector
on the same noisy logits: the port's draw, re-drawn from the same seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import moe_ffn as jax_moe_ffn
from repro.core import routing as jrouting
from repro_torch.configs import moe_ffn
from repro_torch.core import routing

N, E, VALID, K = 40, 8, 6, 2


def _logits(seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((N, E)) * scale).astype(np.float32)


def _cfgs(**kw):
    return moe_ffn(VALID, 16, K, **kw), jax_moe_ffn(VALID, 16, K, **kw)


def _same_selection(info, jinfo):
    np.testing.assert_array_equal(info.idx.numpy(), np.asarray(jinfo.idx))
    for name in ("gates", "probs", "sel"):
        np.testing.assert_allclose(getattr(info, name).detach().numpy(),
                                   np.asarray(getattr(jinfo, name)), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_sinkhorn_matches_reference():
    """Values within 1e-5 of the reference's, rows summing to 1 and
    columns to N/E, in float32, at 8 and 20 iterations."""
    x = _logits(0)
    for iters in (8, 20):
        pi = routing.sinkhorn(torch.from_numpy(x), iters)
        want = np.asarray(jrouting.sinkhorn(jnp.asarray(x), iters))
        assert pi.dtype == torch.float32
        np.testing.assert_allclose(pi.numpy(), want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(pi.sum(1).numpy(), 1.0, rtol=1e-4)
        np.testing.assert_allclose(pi.sum(0).numpy(), N / E, rtol=0.05 if iters == 8
                                   else 1e-3)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_sbase_selection_matches_reference(train):
    """Experts 6 and 7 are padding (logits -1e9, as ``_route`` pads):
    never chosen; the indices equal the reference's, and the gates
    (sigmoid at the chosen experts) and their gradient match."""
    x = _logits(1)
    x[:, VALID:] = -1e9
    cfg, jcfg = _cfgs(selector_activation="sigmoid")
    cfg, jcfg = (dataclasses.replace(c, kind="sbase") for c in (cfg, jcfg))
    cot = np.random.default_rng(2).standard_normal((N, K)).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_()
    info = routing.select_experts_sbase(t, cfg, train=train, n_valid_experts=VALID)
    (info.gates * torch.from_numpy(cot)).sum().backward()
    jinfo = jrouting.select_experts_sbase(jnp.asarray(x), jcfg, train=train,
                                          n_valid_experts=VALID)
    jgrad = jax.grad(lambda l: jnp.sum(jrouting.select_experts_sbase(
        l, jcfg, train=train, n_valid_experts=VALID).gates * cot))(jnp.asarray(x))
    _same_selection(info, jinfo)
    assert int(info.idx.max()) < VALID
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), atol=2e-4, rtol=2e-4)
    if train:     # balanced routing: no expert takes more than twice its share
        counts = torch.bincount(info.idx.reshape(-1), minlength=E)[:VALID]
        assert int(counts.max()) <= 2 * N * K / VALID


def test_noisy_gating_in_training_matches_reference_on_the_same_noise():
    """select_experts(logits, noise_logits, train=True, gen) equals the
    reference's selector (no noise) on logits + z * softplus(noise_logits),
    z the port's draw from the same seed; gradients in both inputs too."""
    x, nl = _logits(3), _logits(4, scale=1.0)
    x[:, VALID:] = -1e9
    nl[:, VALID:] = 0.0
    cfg, jcfg = _cfgs(selector_activation="softmax", renormalize=True)
    cfg, jcfg = (dataclasses.replace(c, kind="noisy_topk") for c in (cfg, jcfg))
    cot = np.random.default_rng(5).standard_normal((N, K)).astype(np.float32)
    z = torch.randn((N, E), generator=torch.Generator().manual_seed(6)).numpy()
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, nl)]
    info = routing.select_experts(ins[0], cfg, gen=torch.Generator().manual_seed(6),
                                  train=True, noise_logits=ins[1],
                                  n_valid_experts=VALID)
    (info.gates * torch.from_numpy(cot)).sum().backward()

    def jsel(l, n):
        return jrouting.select_experts(l + z * jax.nn.softplus(n), jcfg, train=True,
                                       n_valid_experts=VALID)

    jinfo = jsel(jnp.asarray(x), jnp.asarray(nl))
    jgrads = jax.grad(lambda l, n: jnp.sum(jsel(l, n).gates * cot), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(nl))
    _same_selection(info, jinfo)
    for t, jg in zip(ins, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=2e-4, rtol=2e-4)
    plain = routing.select_experts(torch.from_numpy(x), cfg, train=True,
                                   n_valid_experts=VALID)
    assert not torch.equal(plain.probs, info.probs.detach())     # the noise is there


def test_noisy_gating_in_eval_matches_reference():
    """Outside training the noise logits are ignored, in both packages."""
    x, nl = _logits(7), _logits(8, scale=1.0)
    cfg, jcfg = _cfgs(selector_activation="softmax", renormalize=True)
    info = routing.select_experts(torch.from_numpy(x), cfg, train=False,
                                  gen=torch.Generator().manual_seed(0),
                                  noise_logits=torch.from_numpy(nl), n_valid_experts=VALID)
    jinfo = jrouting.select_experts(jnp.asarray(x), jcfg, train=False,
                                    rng=jax.random.PRNGKey(0), noise_logits=jnp.asarray(nl),
                                    n_valid_experts=VALID)
    _same_selection(info, jinfo)
    np.testing.assert_allclose(info.gates.sum(-1).numpy(), 1.0, atol=1e-5)
