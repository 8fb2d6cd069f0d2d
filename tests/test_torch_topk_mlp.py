"""The top-K-activation MLP (paper Sec. 3.1) on the port against the
reference, on the CPU: ``apply_dense`` of kind "topk" on the "dense" oracle
(the masked full down-projection), the "einsum" rung and the kernel rung
("pallas_fused": W2's rows through ``ops.gathered_weighted_sum_dedup``,
K6's plain version here; the reference's gather kernel in interpret mode),
forward, every gradient and the channel-usage histogram of
``collect_stats``; and ``apply_moe``'s expert usage (``usage_stats``).

ReLU's zeros tie, and the K-th largest activation is positive in every
row here, so no tie decides a selection. Tolerances are the reference's
own: float32 outputs 1e-5, gradients 2e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FFNConfig as JaxFFNConfig
from repro.configs import reduced as jax_reduced
from repro.core import moe as jmoe
from repro.core import topk_mlp as jtopk
from repro_torch.configs import FFNConfig, reduced
from repro_torch.core import moe, topk_mlp

pytestmark = pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")

D = 64
JAX_IMPL = {"dense": "dense", "einsum": "einsum",
            "pallas_fused": "pallas_fused_interpret"}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("impl", ["dense", "einsum", "pallas_fused"])
def test_topk_mlp_matches_reference(impl):
    kw = dict(kind="topk", d_ff=96, topk_k=16, activation="relu")
    cfg, jcfg = FFNConfig(impl=impl, **kw), JaxFFNConfig(impl=JAX_IMPL[impl], **kw)
    jp = jtopk.init_dense(jax.random.PRNGKey(3), D, jcfg, 3)
    names = sorted(jp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 11, D)).astype(np.float32)
    cot = rng.standard_normal((3, 11, D)).astype(np.float32)

    def jloss(x, *leaves):
        y, aux = jtopk.apply_dense(dict(zip(names, leaves)), x, jcfg, collect_stats=True)
        return jnp.sum(y * cot), (y, aux)

    (_, (jy, jaux)), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(1 + len(names))), has_aux=True)(
        jnp.asarray(x), *(jp[n] for n in names))
    ins = [_t(x).requires_grad_()] + [_t(jp[n]).requires_grad_() for n in names]
    y, aux = topk_mlp.apply_dense(dict(zip(names, ins[1:])), ins[0], cfg,
                                  collect_stats=True)
    (y * _t(cot)).sum().backward()
    u = torch.relu(_t(x).reshape(-1, D) @ _t(jp["w1"]))
    assert (torch.sort(u, dim=-1, descending=True).values[:, 15] > 0).all()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    for name, t, jg in zip(["x"] + names, ins, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=2e-4, rtol=2e-4,
                                   err_msg=name)
    usage, jusage = aux["usage"], jaux["usage"]
    np.testing.assert_array_equal(usage["counts"].numpy(), np.asarray(jusage["counts"]))
    for key in ("weight", "usage_entropy"):
        np.testing.assert_allclose(usage[key].detach().numpy(), np.asarray(jusage[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    assert usage["counts"].sum() == 33 * 16
    if impl == "dense":
        # the oracle's mask keeps exactly the K rows the sparse path sums
        ys, _ = topk_mlp.apply_dense({n: t.detach() for n, t in zip(names, ins[1:])},
                                     ins[0].detach(), dataclasses.replace(cfg, impl="einsum"))
        np.testing.assert_allclose(ys.numpy(), y.detach().numpy(), atol=1e-5, rtol=1e-5)


def test_moe_usage_stats_match_reference():
    jcfg = jax_reduced("wt103-262m-moe").ffn
    cfg = dataclasses.replace(reduced("wt103-262m-moe").ffn, impl="ragged")
    jcfg = dataclasses.replace(jcfg, impl="ragged")
    jp = jmoe.init_moe(jax.random.PRNGKey(5), D, jcfg, 3)
    x = np.random.default_rng(6).standard_normal((2, 9, D)).astype(np.float32)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, collect_stats=True)
    y, aux = moe.apply_moe(jax.tree_util.tree_map(_t, jp), _t(x), cfg, collect_stats=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    assert set(aux) == set(jaux) and set(aux["usage"]) == set(jaux["usage"])
    for key, val in aux["usage"].items():
        np.testing.assert_allclose(val.numpy(), np.asarray(jaux["usage"][key]), atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    _, plain = moe.apply_moe(jax.tree_util.tree_map(_t, jp), _t(x), cfg)
    assert "usage" not in plain
