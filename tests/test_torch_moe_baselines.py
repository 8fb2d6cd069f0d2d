"""The paper's MoE baselines (Switch, S-BASE, noisy top-k) through
``apply_moe`` on the port against the reference, on the CPU, under both
dispatches, in training: the output, the regularizer (switch, entropy and
cv) and the dropped fraction, and the gradients of the output and the
regularizer in the tokens and in every parameter, the router's noise
weights and the shared expert's included. The reference's parameters
(``init_moe``) are converted leaf by leaf; float32, expert dropout off;
tolerances 1e-5 for outputs, 2e-4 for gradients. The sort dispatch runs
the reference's "ragged" rung (no Pallas kernel) and the port's plain
grouped matmuls.

Noisy gating draws its noise from the port's ``torch.Generator``; the
reference's draw is replaced, for the test, by that same noise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import moe_ffn as jax_moe_ffn
from repro.core import moe as jmoe
from repro_torch.configs import moe_ffn
from repro_torch.core import moe

D, NE, G = 32, 8, 16
KINDS = {"switch": dict(k=1, selector_activation="softmax", reg_kind="switch",
                        reg_gamma=1e-2),
         "sbase": dict(k=2, selector_activation="sigmoid", reg_kind="entropy",
                       reg_gamma=1e-3),
         "noisy_topk": dict(k=2, selector_activation="softmax", renormalize=True,
                            reg_kind="cv", reg_gamma=1e-2)}
SEED = 5


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_apply_moe_matches_reference(kind, dispatch, monkeypatch):
    kw = dict(KINDS[kind], dispatch=dispatch, impl="ragged", n_shared_experts=1)
    k = kw.pop("k")
    cfg = dataclasses.replace(moe_ffn(NE, G, k, **kw), kind=kind)
    jcfg = dataclasses.replace(jax_moe_ffn(NE, G, k, **kw), kind=kind)
    jp = jmoe.init_moe(jax.random.PRNGKey(1), D, jcfg, n_layers=4)
    assert ("router_noise" in jp) == (kind == "noisy_topk") and "shared_w1" in jp
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 10, D)).astype(np.float32)
    cot = rng.standard_normal((4, 10, D)).astype(np.float32)
    noise = torch.randn((40, NE), generator=torch.Generator().manual_seed(SEED))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise.numpy(), dtype))
    names = sorted(jp)

    def jloss(x, *ws):
        y, aux = jmoe.apply_moe(dict(zip(names, ws)), x, jcfg, rng=jax.random.PRNGKey(3),
                                train=True)
        return jnp.sum(y * cot) + aux["moe_reg"], (y, aux)

    (_, (jy, jaux)), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(1 + len(names))), has_aux=True)(
        jnp.asarray(x), *(jp[n] for n in names))

    ins = [torch.from_numpy(x).requires_grad_()] + [
        torch.from_numpy(np.array(jp[n])).requires_grad_() for n in names]
    y, aux = moe.apply_moe(dict(zip(names, ins[1:])), ins[0], cfg,
                           gen=torch.Generator().manual_seed(SEED), train=True)
    ((y * torch.from_numpy(cot)).sum() + aux["moe_reg"]).backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    reg = float(aux["moe_reg"].detach())
    np.testing.assert_allclose(reg, float(jaux["moe_reg"]), rtol=1e-5, atol=1e-8)
    assert reg != 0.0
    np.testing.assert_allclose(float(aux["moe_dropped"]), float(jaux["moe_dropped"]),
                               rtol=1e-6)
    for name, t, jg in zip(["x"] + names, ins, jgrads):
        assert float(np.abs(np.asarray(jg)).max()) > 0.0, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=2e-4, rtol=2e-4,
                                   err_msg=name)
    shapes = {n: tuple(t.shape) for n, t in moe.init_moe(
        torch.Generator().manual_seed(0), D, cfg, 4, device="cpu").items()}
    assert shapes == {n: tuple(jp[n].shape) for n in names}
