"""The port's training slice against the reference, on the CPU, at small
sizes (reduced wt103-47m-moe: 3 layers, d_model 64, 4 experts of 32, top-2;
float32, dropout 0): the same numpy inputs, and the reference's parameters
converted leaf by leaf, go through both packages.

Tolerances are the reference's own: float32 kernel outputs 1e-5, gradients
2e-4 (tests/test_kernels_cvmm_fused.py), three-layer model outputs 1e-4.
The reference's kernels run in Pallas interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.configs import reduced as jax_reduced
from repro.data import DataIterator as JaxDataIterator
from repro.data import make_dataset as jax_make_dataset
from repro.kernels import ops as jops
from repro.kernels.cvmm import (cvmm_dw_streamed_pallas, cvmm_fused_w1_pallas,
                                cvmm_fused_w2_pallas)
from repro.models import attention as jattention
from repro.models.lm import LM as JaxLM
from repro.optim import make_schedule as jax_make_schedule
from repro.runtime.loss import chunked_cross_entropy as jax_chunked_cross_entropy
from repro.runtime.steps import init_train_state as jax_init_train_state
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch.common import map_leaves, tree_leaves
from repro_torch.configs import OptimizerConfig, reduced
from repro_torch.convert import from_jax_params
from repro_torch.data import DataIterator, make_dataset
from repro_torch.kernels import cvmm as K
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import LM, attention
from repro_torch.optim import adamw_init, make_schedule
from repro_torch.runtime import chunked_cross_entropy, make_train_step

# The reference's streamed kernels raise this deprecation on current jax; it
# is not the port's and not what these tests check.
pytestmark = pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")

ARCH = "wt103-47m-moe"
N, TOPK, E, D, G = 40, 2, 4, 64, 32        # reduced wt103-47m-moe's MoE layer


def _t(a):
    return torch.from_numpy(np.array(a))


def _routing(seed, n=N, k=TOPK, e=E, skip=None):
    """Distinct experts per token, optionally never choosing ``skip``, and
    random float32 gates."""
    rng = np.random.default_rng(seed)
    pool = [x for x in range(e) if x != skip]
    idx = np.stack([rng.permutation(pool)[:k] for _ in range(n)]).astype(np.int32)
    return idx, rng.random((n, k)).astype(np.float32)


def _jplan(idx, gates, e=E):
    return jops.make_moe_plan(jnp.asarray(idx), jnp.asarray(gates), idx.shape[0], e)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("glu,save", [(False, False), (False, True),
                                      (True, False), (True, True)],
                         ids=["w1", "w1_save", "w1_glu", "w1_glu_save"])
def test_fused_w1_plain_matches_pallas(glu, save, act):
    rng = np.random.default_rng(11)
    idx, gates = _routing(1, skip=2)                   # expert 2 has no rows
    plan = _jplan(idx, gates)
    x = rng.standard_normal((N, 128)).astype(np.float32)
    w1, w1g = (rng.standard_normal((E, 128, 128)).astype(np.float32) / 8
               for _ in range(2))
    want = cvmm_fused_w1_pallas(jnp.asarray(x), plan.row_src, plan.run_start,
                                plan.run_off, plan.tile_expert, jnp.asarray(w1),
                                jnp.asarray(w1g) if glu else None, act_name=act,
                                save_preact=save, interpret=True)
    got = K.fused_w1(_t(x), _t(plan.row_src), _t(plan.tile_expert), _t(w1),
                     _t(w1g) if glu else None, act=act, save_preact=save)
    want = want if save else (want,)
    got = got if save else (got,)
    assert len(got) == len(want) == (1 + save + (save and glu))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-5, rtol=1e-5)


def test_fused_w2_plain_matches_pallas():
    rng = np.random.default_rng(12)
    idx, gates = _routing(2)
    plan = _jplan(idx, gates)
    u = rng.standard_normal((plan.m_pad, 128)).astype(np.float32)
    w2 = rng.standard_normal((E, 128, 128)).astype(np.float32) / 8
    want = cvmm_fused_w2_pallas(jnp.asarray(u), plan.tile_expert, jnp.asarray(w2),
                                plan.gate_tiles, interpret=True)
    got = K.fused_w2(_t(u), _t(plan.tile_expert), _t(w2),
                     _t(plan.gate_tiles).reshape(-1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", ["stream_x", "stream_g", "stream_g_gate"])
def test_dw_streamed_plain_matches_pallas(variant):
    rng = np.random.default_rng(13)
    idx, gates = _routing(3, skip=1)                   # expert 1 has no rows
    plan = _jplan(idx, gates)
    unsorted = rng.standard_normal((N, 128)).astype(np.float32)
    aligned = rng.standard_normal((plan.m_pad, 256)).astype(np.float32)
    stream_x = variant == "stream_x"
    gate = plan.gate_tiles if variant == "stream_g_gate" else None
    x, g = (unsorted, aligned) if stream_x else (aligned, unsorted)
    want = jops._mask_empty(cvmm_dw_streamed_pallas(
        jnp.asarray(x), jnp.asarray(g), plan.row_src, plan.run_start, plan.run_off,
        plan.tile_expert, E, stream_x=stream_x, gate_tiles=gate, interpret=True),
        plan.group_sizes)
    got = K.dw_streamed(_t(x), _t(g), _t(plan.row_src), _t(plan.tile_expert), E,
                        stream_x=stream_x,
                        gate=None if gate is None else _t(gate).reshape(-1))
    assert got.dtype == torch.float32 and bool((got[1] == 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_moe_plan_row_src_and_gate_tiles_equal_reference():
    idx, gates = _routing(4)
    jp = _jplan(idx, gates)
    tp = ops.make_moe_plan(_t(idx), E, _t(gates))
    np.testing.assert_array_equal(tp.row_src.numpy(), np.asarray(jp.row_src))
    np.testing.assert_array_equal(tp.tile_expert.numpy(), np.asarray(jp.tile_expert))
    np.testing.assert_array_equal(tp.gate_tiles.numpy(), np.asarray(jp.gate_tiles))
    assert tp.row_src.dtype == torch.int32 and tp.m_pad == jp.m_pad


# ---------------------------------------------------------------------------
# The fused expert MLP, forward and every gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act,glu", [("relu", False), ("silu", True)])
def test_moe_mlp_fused_matches_reference_with_gradients(act, glu):
    rng = np.random.default_rng(21)
    idx, gates = _routing(5, skip=3)
    xf = rng.standard_normal((N, D)).astype(np.float32)
    w1, w1g = (rng.standard_normal((E, D, G)).astype(np.float32) * D ** -0.5
               for _ in range(2))
    w2 = rng.standard_normal((E, G, D)).astype(np.float32) * G ** -0.5
    cot = rng.standard_normal((N, D)).astype(np.float32)

    def jloss(xf, gates, w1, w1g, w2):
        plan = jops.make_moe_plan(jnp.asarray(idx), gates, N, E)
        y = jops.moe_mlp_fused(xf, plan, w1, w2, w1g if glu else None,
                               activation=act, interpret=True)
        return jnp.sum(y * cot), y

    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in (xf, gates, w1, w1g, w2)))
    ins = [_t(a).requires_grad_() for a in (xf, gates, w1, w1g, w2)]
    plan = ops.make_moe_plan(_t(idx), E, ins[1])
    y = ops.moe_mlp_fused(ins[0], plan, ins[2], ins[4], ins[3] if glu else None,
                          activation=act)
    (y * _t(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=2e-4, rtol=2e-4)
    for name, t, jg in zip(("x", "gates", "w1", "w1g", "w2"), ins, jgrads):
        if name == "w1g" and not glu:
            assert t.grad is None
            continue
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=2e-4,
                                   rtol=2e-4, err_msg=name)
    assert float(ins[1].grad.abs().sum()) > 0          # the router gets a gradient


def test_moe_mlp_fused_inference_saves_nothing_and_matches_ragged_rung():
    idx, gates = _routing(6)
    rng = np.random.default_rng(6)
    xf = _t(rng.standard_normal((N, D)).astype(np.float32))
    w1 = _t(rng.standard_normal((E, D, G)).astype(np.float32) * D ** -0.5)
    w2 = _t(rng.standard_normal((E, G, D)).astype(np.float32) * G ** -0.5)
    plan = ops.make_moe_plan(_t(idx), E, _t(gates))
    y = ops.moe_mlp_fused(xf, plan, w1, w2)
    assert y.grad_fn is None
    e_flat = _t(idx).reshape(-1).long()
    perm = torch.argsort(e_flat, stable=True)
    src = torch.arange(N).repeat_interleave(TOPK)[perm]
    h = ops.cvmm(xf[src], torch.bincount(e_flat, minlength=E), w1, impl="ragged")
    ys = ops.cvmm(torch.relu(h), torch.bincount(e_flat, minlength=E), w2, impl="ragged")
    want = torch.zeros_like(xf).index_add_(0, src, ys * _t(gates).reshape(-1)[perm][:, None])
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The guard: a kernel's output never leaves autograd behind
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["cvmm", "gather_rows", "fused_w1", "fused_w2",
                                  "dw_streamed", "cvmm_dw"])
def test_kernel_wrappers_refuse_inputs_that_need_grad(call, monkeypatch):
    monkeypatch.setattr(K, "_use_plain", lambda t: False)   # as if on a card
    x = torch.randn(128, 128, requires_grad=True)
    te = torch.zeros(1, dtype=torch.int32)
    rs = torch.arange(128, dtype=torch.int32)
    w = torch.randn(1, 128, 128)
    gate = torch.ones(128)
    calls = {"cvmm": lambda: K.cvmm(x, te, w),
             "gather_rows": lambda: K.gather_rows(x, rs),
             "fused_w1": lambda: K.fused_w1(x, rs, te, w),
             "fused_w2": lambda: K.fused_w2(x, te, w, gate),
             "dw_streamed": lambda: K.dw_streamed(x, x, rs, te, 1, stream_x=True),
             "cvmm_dw": lambda: K.cvmm_dw(x, te, x, 1)}
    with pytest.raises(RuntimeError, match="no autograd history"):
        calls[call]()
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):
        calls[call]()                                   # past the guard


# ---------------------------------------------------------------------------
# The model: XL attention, the loss with memories, three train steps
# ---------------------------------------------------------------------------

def _with_impl(cfg, impl):
    return cfg.with_ffn(dataclasses.replace(cfg.ffn, impl=impl))


@pytest.fixture(scope="module")
def models():
    jcfg = _with_impl(jax_reduced(ARCH).override(dtype="float32", dropout=0.0),
                      "ragged")
    cfg = reduced(ARCH).override(dtype="float32", dropout=0.0)
    jlm = JaxLM(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                             device="cpu")
    return jlm, jparams, cfg, params


def test_convert_carries_xl_attention_norm_and_router_leaves(models):
    jlm, jparams, cfg, params = models
    jl = jparams["stack"]["segments"][0]["e0"]
    layer = params["stack"]["segments"][0]["e0"][1]
    for path in (("attn", "w_r"), ("attn", "u_bias"), ("attn", "v_bias"),
                 ("norm1", "bias"), ("norm2", "scale"), ("ffn", "router")):
        np.testing.assert_array_equal(layer[path[0]][path[1]].numpy(),
                                      np.asarray(jl[path[0]][path[1]][1]))
    lm = LM(cfg)
    init = lm.init(torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        out = {}
        map_leaves(tree, lambda path, p: out.setdefault(path, tuple(p.shape)))
        return out
    assert shapes(init) == shapes(params)


def test_rel_shift_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 9)).astype(np.float32)
    np.testing.assert_array_equal(attention._rel_shift(_t(x)).numpy(),
                                  np.asarray(jattention._rel_shift(jnp.asarray(x))))


def test_xl_attention_with_memory_matches_reference(models):
    jlm, jparams, cfg, params = models
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, cfg.xl_memory, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["stack"]["segments"][0]["e0"]["attn"])
    jp = {**jp, "u_bias": jp["u_bias"] + 0.1, "v_bias": jp["v_bias"] - 0.2}
    want, _ = jattention.apply_attention(jp, jnp.asarray(x), jlm.cfg,
                                         memory=jnp.asarray(mem))
    got, _ = attention.apply_attention({k: _t(v) for k, v in jp.items()}, _t(x), cfg,
                                       memory=_t(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["ragged", "pallas_fused", "pallas"])
def test_loss_with_mems_matches_reference(models, impl):
    jlm, jparams, cfg, params = models
    lm = LM(_with_impl(cfg, impl))
    rng = np.random.default_rng(32)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    mems = rng.standard_normal((3, 2, cfg.xl_memory, cfg.d_model)).astype(np.float32)
    jmems = {"segments": [{"e0": jnp.asarray(mems)}]}
    tmems = {"segments": [{"e0": [_t(m) for m in mems]}]}
    jloss, (jmetrics, jnew) = jlm.loss(jparams, {"tokens": jnp.asarray(tokens)},
                                       train=True, mems=jmems)
    loss, (metrics, new) = lm.loss(params, {"tokens": _t(tokens)}, train=True,
                                   mems=tmems)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(metrics["moe_reg"].detach()), float(jmetrics["moe_reg"]),
                               atol=1e-6, rtol=1e-4)
    for r in range(3):
        np.testing.assert_allclose(new["segments"][0]["e0"][r].numpy(),
                                   np.asarray(jnew["segments"][0]["e0"][r]),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl", ["pallas_fused", "ragged", "pallas"])
def test_three_train_steps_match_reference(models, impl):
    jlm, jparams, cfg, params = models
    B, S = 2, 12
    jopt = JaxOptimizerConfig(total_steps=3)
    jstate = jax_init_train_state(jlm, jax.random.PRNGKey(0), jopt, use_mems=True,
                                  batch=B)
    jstep = jax.jit(jax_make_train_step(jlm, jopt))
    lm = LM(_with_impl(cfg, impl))
    tparams = map_leaves(params, lambda path, p: p.clone().requires_grad_())
    state = {"params": tparams, "opt": adamw_init(tparams),
             "mems": lm.init_mems(B, device="cpu")}
    step = make_train_step(lm, OptimizerConfig(total_steps=3))
    it = JaxDataIterator(jax_make_dataset("synthetic", cfg.vocab_size), B, S, seed=7)
    for _ in range(3):
        tokens = it.next()["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)},
                           jax.random.PRNGKey(1))
        state, m = step(state, {"tokens": _t(tokens)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-3)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                           cfg, device="cpu")
    for got, w in zip(tree_leaves(state["params"]), tree_leaves(want)):
        np.testing.assert_allclose(got.detach().numpy(), w.numpy(), atol=2e-4, rtol=2e-4)
    assert state["opt"].step == int(jstate["opt"].step) == 3


@pytest.mark.parametrize("chunks", [0, 3])
def test_chunked_cross_entropy_matches_reference(chunks):
    rng = np.random.default_rng(41)
    h = rng.standard_normal((2, 7, 16)).astype(np.float32)
    w = rng.standard_normal((16, 512)).astype(np.float32) / 4
    labels = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.2).astype(np.float32)

    def jloss(h, w):
        return jax_chunked_cross_entropy(h, w, jnp.asarray(labels), chunks=chunks,
                                         mask=jnp.asarray(mask), n_valid_vocab=500)[0]

    jl, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    tl, n_tok = chunked_cross_entropy(th, tw, _t(labels), chunks=chunks, mask=_t(mask),
                                      n_valid_vocab=500)
    tl.backward()
    assert float(n_tok) == mask.sum()
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedule_matches_reference(schedule):
    kw = dict(schedule=schedule, warmup_steps=4, total_steps=40, final_lr_ratio=0.1)
    want = jax_make_schedule(JaxOptimizerConfig(**kw))
    got = make_schedule(OptimizerConfig(**kw))
    for step in (0, 2, 4, 20, 37, 39, 45):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))), rtol=1e-6)


def test_synthetic_stream_equals_reference():
    for seed in (0, 5):
        j = JaxDataIterator(jax_make_dataset("synthetic", 8000), 4, 33, seed=seed)
        t = DataIterator(make_dataset("synthetic", 8000), 4, 33, seed=seed)
        for _ in range(3):
            np.testing.assert_array_equal(t.next()["tokens"], j.next()["tokens"])
        assert t.step == j.step == 3


def test_trainer_cli_runs_reduced_on_the_cpu(capsys):
    out = train_cli.main(["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
                          "--seq", "16", "--device", "cpu"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["launches"] == [dict.fromkeys(K.LAUNCHES, 0)] * 3   # plain on CPU
    assert "step     2 loss" in capsys.readouterr().out
