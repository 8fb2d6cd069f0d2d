"""The paper's dense baseline on the port against the reference, on the CPU,
at small sizes: the dense and GLU FFNs, the FFN registry, the eval step,
and three train steps of the reduced dense and 262M sigma-MoE configs
(3 layers, d_model 64; float32, dropout 0). The same numpy inputs, and the
reference's parameters converted leaf by leaf, go through both packages.

Tolerances are the reference's own: float32 outputs 1e-5, gradients 2e-4
(tests/test_kernels_cvmm_fused.py), model losses and logits 1e-4. The
reference runs only pure-JAX paths here (its einsums and the "ragged"
rung), never a Pallas kernel."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FFNConfig as JaxFFNConfig
from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.configs import reduced as jax_reduced
from repro.core import topk_mlp as jtopk
from repro.data import DataIterator as JaxDataIterator
from repro.data import make_dataset as jax_make_dataset
from repro.models import ffn as jffn
from repro.models.lm import LM as JaxLM
from repro.runtime.steps import init_train_state as jax_init_train_state
from repro.runtime.steps import make_eval_step as jax_make_eval_step
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch.common import map_leaves, tree_leaves
from repro_torch.configs import FFNConfig, OptimizerConfig, reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import topk_mlp
from repro_torch.models import LM, ffn
from repro_torch.optim import adamw_init
from repro_torch.runtime import make_eval_step, make_train_step

D = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(cfg, impl="ragged"):
    """Float32, no dropout; MoE layers on the reference's pure-JAX rung."""
    cfg = cfg.override(dtype="float32", dropout=0.0)
    return cfg.with_ffn(dataclasses.replace(cfg.ffn, impl=impl))


def _models(arch, kind=None):
    """(reference LM, its params, port LM, converted params) of reduced
    ``arch``, with the FFN kind swapped to ``kind`` if given."""
    jcfg, cfg = _f32(jax_reduced(arch)), _f32(reduced(arch))
    if kind:
        jcfg = jcfg.with_ffn(dataclasses.replace(jcfg.ffn, kind=kind))
        cfg = cfg.with_ffn(dataclasses.replace(cfg.ffn, kind=kind))
    jlm = JaxLM(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                             device="cpu")
    return jlm, jparams, LM(cfg), params


@pytest.mark.parametrize("kind,act", [("dense", "relu"), ("glu", "silu")])
def test_dense_ffn_matches_reference_with_gradients(kind, act):
    """apply_dense forward and every gradient on converted parameters, and
    the converted LM's dense leaves (w1, w2, w3) at the port init's paths."""
    jcfg = JaxFFNConfig(kind=kind, d_ff=96, activation=act)
    cfg = FFNConfig(kind=kind, d_ff=96, activation=act)
    jp = jtopk.init_dense(jax.random.PRNGKey(1), D, jcfg, 3)
    assert set(jp) == ({"w1", "w2", "w3"} if kind == "glu" else {"w1", "w2"})
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    cot = rng.standard_normal((2, 7, D)).astype(np.float32)
    names = sorted(jp)

    def jloss(x, *ws):
        y, aux = jtopk.apply_dense(dict(zip(names, ws)), x, jcfg)
        return jnp.sum(y * cot), (y, aux)

    (_, (jy, jaux)), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(1 + len(names))), has_aux=True)(
        jnp.asarray(x), *(jp[n] for n in names))
    ins = [_t(x).requires_grad_()] + [_t(jp[n]).requires_grad_() for n in names]
    y, aux = topk_mlp.apply_dense(dict(zip(names, ins[1:])), ins[0], cfg)
    (y * _t(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    for name, t, jg in zip(["x"] + names, ins, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=2e-4,
                                   rtol=2e-4, err_msg=name)
    assert {k: float(v) for k, v in aux.items()} == {k: float(v) for k, v in jaux.items()}
    assert all(v.dtype == torch.float32 for v in aux.values())

    _, _, lm, params = _models("wt103-47m-dense", kind)
    init = lm.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: map_leaves(tree, lambda path, p: tuple(p.shape))
    assert shapes(init) == shapes(params)
    layer = params["stack"]["segments"][0]["e0"][2]["ffn"]
    assert set(layer) == set(jp) and layer["w1"].shape == (D, 128)


def test_ffn_registry_matches_reference():
    """Every kind gives the reference registry's output and aux on the same
    parameters, the MoE baselines (Switch on the capacity dispatch, S-BASE,
    noisy top-k with its router noise) included."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    moe = _f32(reduced("wt103-262m-moe")).ffn
    cfgs = {"dense": FFNConfig(kind="dense", d_ff=128), "glu":
            FFNConfig(kind="glu", d_ff=128, activation="gelu"),
            "none": FFNConfig(kind="none"), "sigma_moe": moe,
            "topk": FFNConfig(kind="topk", d_ff=128, topk_k=16, impl="einsum"),
            "pkm": FFNConfig(kind="pkm", n_subkeys=8, pkm_heads=2, pkm_knn=4,
                             impl="einsum"),
            "switch": dataclasses.replace(moe, kind="switch", k=1, dispatch="einsum",
                                          selector_activation="softmax",
                                          reg_kind="switch"),
            "sbase": dataclasses.replace(moe, kind="sbase"),
            "noisy_topk": dataclasses.replace(moe, kind="noisy_topk", reg_kind="cv",
                                              selector_activation="softmax",
                                              renormalize=True)}
    assert set(cfgs) == set(ffn.FFN_REGISTRY) == set(jffn.FFN_REGISTRY)
    for kind, cfg in cfgs.items():
        jcfg = JaxFFNConfig(**dataclasses.asdict(cfg))
        jp = jffn.init_ffn(jax.random.PRNGKey(4), D, jcfg, 3)
        jy, jaux = jffn.apply_ffn(jp, jnp.asarray(x), jcfg)
        y, aux = ffn.apply_ffn(jax.tree_util.tree_map(_t, jp), _t(x), cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5,
                                   err_msg=kind)
        assert set(aux) == set(jaux) == {"moe_reg", "moe_dropped"}, kind
        for key in aux:
            np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{kind} {key}")
        shapes = lambda tree: map_leaves(tree, lambda path, p: tuple(p.shape))
        got = ffn.init_ffn(torch.Generator().manual_seed(0), D, cfg, 3, device="cpu")
        assert shapes(got) == shapes(jax.tree_util.tree_map(np.asarray, jp)), kind


def test_eval_step_matches_reference():
    """The eval step's loss and metrics (no dropout, no memories, no
    gradients) on the reduced 262M sigma-MoE, against the reference's."""
    jlm, jparams, lm, params = _models("wt103-262m-moe")
    params = map_leaves(params, lambda path, p: p.requires_grad_())
    tokens = np.random.default_rng(5).integers(0, 256, size=(2, 17)).astype(np.int32)
    jloss, jm = jax_make_eval_step(jlm)(jparams, {"tokens": jnp.asarray(tokens)})
    loss, m = make_eval_step(lm)(params, {"tokens": _t(tokens)})
    assert loss.grad_fn is None and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-4, rtol=1e-4)
    for key in ("ce", "moe_reg", "moe_dropped", "tokens"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), atol=1e-6, rtol=1e-4,
                                   err_msg=key)
    assert float(m["moe_reg"]) != 0.0


@pytest.mark.parametrize("arch", ["wt103-47m-dense", "wt103-262m-moe"])
def test_three_train_steps_match_reference(arch):
    """Three train steps with XL memories on the reference's synthetic
    stream: losses, gradient norms and every parameter after the steps."""
    jlm, jparams, lm, params = _models(arch)
    B, S = 2, 12
    jopt = JaxOptimizerConfig(total_steps=3)
    jstate = jax_init_train_state(jlm, jax.random.PRNGKey(0), jopt, use_mems=True,
                                  batch=B)
    jstep = jax.jit(jax_make_train_step(jlm, jopt))
    tparams = map_leaves(params, lambda path, p: p.clone().requires_grad_())
    state = {"params": tparams, "opt": adamw_init(tparams),
             "mems": lm.init_mems(B, device="cpu")}
    step = make_train_step(lm, OptimizerConfig(total_steps=3))
    it = JaxDataIterator(jax_make_dataset("synthetic", lm.cfg.vocab_size), B, S, seed=7)
    for _ in range(3):
        tokens = it.next()["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)}, jax.random.PRNGKey(1))
        state, m = step(state, {"tokens": _t(tokens)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["moe_reg"].detach()), float(jm["moe_reg"]),
                                   atol=1e-6, rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-3)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                           lm.cfg, device="cpu")
    for got, w in zip(tree_leaves(state["params"]), tree_leaves(want)):
        np.testing.assert_allclose(got.detach().numpy(), w.numpy(), atol=2e-4, rtol=2e-4)
    assert state["opt"].step == int(jstate["opt"].step) == 3
