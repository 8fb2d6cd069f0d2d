"""Product-key memories on the port against the reference, on the CPU:
``two_stage_topk`` (exact indices and scores) and its result against the
full score grid of ``pkm_full_scores``, and ``apply_pkm`` with ReLU and
softmax weights on the "dense" oracle, the "einsum" rung and the kernel
rung ("pallas_fused", where the port runs K6's plain version through
``ops.gathered_weighted_sum_dedup`` and the reference its gather kernel in
interpret mode): forward, every gradient and the value-usage histogram of
``collect_stats``. The reference's parameters are converted leaf by leaf.

In float32 the sub-key scores of both packages agree to rounding, so the
selections are the same; in bf16 they round differently and are not held
here. Tolerances are the reference's own: float32 outputs 1e-5, gradients
2e-4 (tests/test_kernels_cvmm_fused.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FFNConfig as JaxFFNConfig
from repro.core import pkm as jpkm
from repro.core import routing as jrouting
from repro_torch.configs import FFNConfig
from repro_torch.core import pkm, routing

pytestmark = pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")

D = 64
JAX_IMPL = {"dense": "dense", "einsum": "einsum",
            "pallas_fused": "pallas_fused_interpret"}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_two_stage_topk_matches_reference_and_full_grid():
    rng = np.random.default_rng(0)
    ua = rng.standard_normal((9, 3, 16)).astype(np.float32)
    ub = rng.standard_normal((9, 3, 16)).astype(np.float32)
    for k, c in ((4, 0), (4, 6), (16, 0)):
        got = routing.two_stage_topk(_t(ua), _t(ub), k, c)
        want = jrouting.two_stage_topk(jnp.asarray(ua), jnp.asarray(ub), k, c)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cfg = FFNConfig(kind="pkm", n_subkeys=8, pkm_heads=2, pkm_knn=4)
    jcfg = JaxFFNConfig(kind="pkm", n_subkeys=8, pkm_heads=2, pkm_knn=4)
    jp = jpkm.init_pkm(jax.random.PRNGKey(0), D, jcfg, 2)
    x = rng.standard_normal((32, D)).astype(np.float32)
    params = jax.tree_util.tree_map(_t, jp)
    full = pkm.pkm_full_scores(params, _t(x), cfg)
    np.testing.assert_allclose(full.numpy(), np.asarray(jpkm.pkm_full_scores(
        jp, jnp.asarray(x), jcfg)), atol=1e-5, rtol=1e-5)
    # the candidate grid holds the true top-K: same scores and value rows
    true_top, true_idx = routing.top_k(full, cfg.pkm_knn)
    sel = pkm.pkm_select(params, _t(x), cfg)
    np.testing.assert_allclose(sel.weights.reshape(32, 2, 4).numpy(),
                               torch.relu(true_top).numpy(), atol=1e-6)
    assert torch.equal(sel.idx.reshape(32, 2, 4), true_idx)


@pytest.mark.parametrize("impl", ["dense", "einsum", "pallas_fused"])
def test_apply_pkm_matches_reference(impl):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    cot = rng.standard_normal((2, 7, D)).astype(np.float32)
    for act in ("relu", "softmax"):
        kw = dict(kind="pkm", n_subkeys=8, pkm_heads=2, pkm_knn=4, activation=act)
        cfg, jcfg = FFNConfig(impl=impl, **kw), JaxFFNConfig(impl=JAX_IMPL[impl], **kw)
        jp = jpkm.init_pkm(jax.random.PRNGKey(2), D, jcfg, 3)
        names = sorted(jp)

        def jloss(x, *leaves):
            y, aux = jpkm.apply_pkm(dict(zip(names, leaves)), x, jcfg, collect_stats=True)
            return jnp.sum(y * cot), (y, aux)

        (_, (jy, jaux)), jgrads = jax.value_and_grad(
            jloss, argnums=tuple(range(1 + len(names))), has_aux=True)(
            jnp.asarray(x), *(jp[n] for n in names))
        ins = [_t(x).requires_grad_()] + [_t(jp[n]).requires_grad_() for n in names]
        y, aux = pkm.apply_pkm(dict(zip(names, ins[1:])), ins[0], cfg, collect_stats=True)
        (y * _t(cot)).sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5, err_msg=act)
        for name, t, jg in zip(["x"] + names, ins, jgrads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=2e-4,
                                       rtol=2e-4, err_msg=f"{act} {name}")
        assert set(aux) == set(jaux) == {"moe_reg", "moe_dropped", "usage"}
        usage, jusage = aux["usage"], jaux["usage"]
        assert set(usage) == set(jusage)
        np.testing.assert_array_equal(usage["counts"].numpy(), np.asarray(jusage["counts"]))
        for key in ("weight", "usage_entropy"):
            np.testing.assert_allclose(usage[key].detach().numpy(), np.asarray(jusage[key]),
                                       atol=1e-5, rtol=1e-5, err_msg=f"{act} {key}")
        assert usage["counts"].sum() == 2 * 7 * 2 * 4
