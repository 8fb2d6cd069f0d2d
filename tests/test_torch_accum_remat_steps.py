"""The train step's options on the port against the reference, on the CPU,
at the reduced wt103-47m-moe (3 layers, d_model 64; float32, dropout 0;
XL memories): three steps with gradient accumulation over two
microbatches, whose XL memories of B/2 rows carry from each microbatch to
the next (losses, parameters and memories); three steps with int8
error-feedback compression (parameters and residuals); and three steps
with ``remat`` "full" and "dots", whose gradients with dropout, expert
dropout and gating noise on equal the plain step's bit for bit, with the
generator left where the plain step leaves it. The reference's parameters
are converted leaf by leaf; tolerances: losses and memories 1e-4,
parameters 2e-4. With the sort path pinned to the fused kernels' rung
(their plain versions here), remat relaunches each MoE layer's forward
kernels in the backward: the wrapper calls are counted."""
import collections
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
from repro.models.registry import build_model as jax_build_model
from repro.runtime.steps import init_train_state as jax_init_train_state
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch.common import map_leaves, tree_leaves
from repro_torch.configs import OptimizerConfig, reduced
from repro_torch.convert import from_jax_params
from repro_torch.kernels import cvmm as K
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.optim import OptState
from repro_torch.optim.compress import stacked_path
from repro_torch.runtime import init_train_state, make_train_step

ARCH = "wt103-47m-moe"
B, S = 4, 12


def _f32(cfg):
    cfg = cfg.override(dtype="float32", dropout=0.0)
    return cfg.with_ffn(dataclasses.replace(cfg.ffn, impl="ragged"))


def _stream():
    return JaxDataIterator(jax_make_dataset("synthetic", 256), B, S, seed=7)


def _port_state(jstate, lm):
    """The reference's train state as the port's: parameters, AdamW
    moments, residuals and XL memories, leaf by leaf."""
    conv = lambda tree: from_jax_params(jax.tree_util.tree_map(np.asarray, tree), lm.cfg,
                                        device="cpu")
    params = map_leaves(conv(jstate["params"]), lambda path, p: p.requires_grad_())
    opt = jstate["opt"]
    state = {"params": params, "opt": OptState(int(opt.step), conv(opt.mu), conv(opt.nu)),
             "mems": {"segments": [{name: [torch.from_numpy(np.array(m[r]))
                                           for r in range(m.shape[0])]
                                    for name, m in seg.items()}
                                   for seg in jstate["mems"]["segments"]]}}
    if "err" in jstate:
        state["err"] = conv(jstate["err"])
    return state


def _run_both(opt_kw, grad_accum=1, mem_rows=B, remat="none"):
    """Three steps of the reference and of the port from the reference's
    init, losses and every parameter held to the reference's after each.
    Returns the per-step (port's state, reference's state, port's metrics,
    reference's metrics) and the port's model."""
    jlm = jax_build_model(_f32(jax_reduced(ARCH)), remat=remat)
    lm = build_model(_f32(reduced(ARCH)), remat=remat)
    jopt = JaxOptimizerConfig(total_steps=3, **opt_kw)
    jstate = jax_init_train_state(jlm, jax.random.PRNGKey(0), jopt, use_mems=True,
                                  batch=mem_rows)
    state = _port_state(jstate, lm)
    jstep = jax.jit(jax_make_train_step(jlm, jopt, grad_accum=grad_accum))
    step = make_train_step(lm, OptimizerConfig(total_steps=3, **opt_kw),
                           grad_accum=grad_accum)
    it, steps = _stream(), []
    for _ in range(3):
        tokens = it.next()["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)}, jax.random.PRNGKey(1))
        state, m = step(state, {"tokens": torch.from_numpy(np.array(tokens))})
        steps.append((state, jstate, m, jm))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
        for got, w in zip(tree_leaves(state["params"]), tree_leaves(
                from_jax_params(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                                lm.cfg, device="cpu"))):
            np.testing.assert_allclose(got.detach().numpy(), w.numpy(), atol=2e-4,
                                       rtol=2e-4)
    assert state["opt"].step == int(jstate["opt"].step) == 3
    return steps, lm


def test_grad_accum_steps_match_reference():
    """grad_accum=2 with memories of B/2 rows: losses (the mean over the
    microbatches), every parameter, and the memories after each step. The
    reference's own trainer sizes the memories for the whole batch, on
    which its scan fails; the port's step refuses that, and a batch that
    does not split."""
    steps, lm = _run_both({}, grad_accum=2, mem_rows=B // 2)
    for state, jstate, m, jm in steps:
        jmems = jstate["mems"]["segments"][0]["e0"]
        for r, got in enumerate(state["mems"]["segments"][0]["e0"]):
            assert got.shape == (B // 2, lm.cfg.xl_memory, lm.cfg.d_model)
            np.testing.assert_allclose(got.numpy(), np.asarray(jmems[r]), atol=1e-4,
                                       rtol=1e-4)
        for key in ("ce", "moe_reg", "tokens"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), atol=1e-6, rtol=1e-4)
    step = make_train_step(lm, OptimizerConfig(), grad_accum=2)
    tokens = torch.from_numpy(np.array(_stream().next()["tokens"]))
    with pytest.raises(ValueError, match="size them for one microbatch"):
        step(dict(state, mems=lm.init_mems(B, device="cpu")), {"tokens": tokens})
    with pytest.raises(ValueError, match="do not split"):
        make_train_step(lm, OptimizerConfig(), grad_accum=3)(state, {"tokens": tokens})
    jlm = jax_build_model(_f32(jax_reduced(ARCH)))
    jopt = JaxOptimizerConfig()
    jwhole = jax_init_train_state(jlm, jax.random.PRNGKey(0), jopt, use_mems=True, batch=B)
    with pytest.raises(TypeError):          # the reference's caveat, recorded
        jax_make_train_step(jlm, jopt, grad_accum=2)(jwhole, {"tokens": jnp.asarray(
            tokens.numpy())}, jax.random.PRNGKey(1))


def test_int8_compression_steps_match_reference():
    """int8 error feedback: losses and every parameter as in the other
    steps, and every residual within one quantization step of the
    reference's (the two packages' float32 gradients may straddle a
    rounding boundary), 99 % of them within a thousandth of a step. The
    int8 scale spans a stacked leaf's layers, as the reference's does."""
    steps, lm = _run_both({"grad_compression": "int8"})
    for state, jstate, _, _ in steps:
        got = {}
        map_leaves(state["err"], lambda path, t: got.setdefault(path, t))
        want = {}
        map_leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, jstate["err"]),
                                   lm.cfg, device="cpu"),
                   lambda path, t: want.setdefault(path, t))
        step = {}                 # a stacked leaf's quantization step: |err| <= step / 2
        for path, t in list(got.items()) + list(want.items()):
            key = stacked_path(path)
            step[key] = max(step.get(key, 0.0), 2 * float(t.abs().max()))
        close = 0
        for path, w in want.items():
            assert got[path].dtype == torch.float32 and got[path].shape == w.shape
            diff = (got[path] - w).abs()
            assert float(diff.max()) <= step[stacked_path(path)] * (1 + 1e-5) + 1e-12
            close += int((diff <= 1e-3 * step[stacked_path(path)]).sum())
        total = sum(w.numel() for w in want.values())
        assert close >= 0.99 * total, (close, total)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gradients_equal_the_plain_steps(remat):
    """With dropout 0.1, expert dropout 0.1 and noisy top-k's gating noise
    all drawn from one generator, a step's gradients under ``remat`` equal
    the plain step's bit for bit and the generator ends in the same state;
    with dropout off, three steps match the reference's step under the
    same remat."""
    cfg = reduced(ARCH).override(dtype="float32", dropout=0.1)
    cfg = cfg.with_ffn(dataclasses.replace(cfg.ffn, kind="noisy_topk", expert_dropout=0.1,
                                           selector_activation="softmax"))
    tokens = {"tokens": torch.from_numpy(np.array(_stream().next()["tokens"]))}
    runs = {}
    for mode in ("none", remat):
        lm = build_model(cfg, remat=mode)
        state = init_train_state(lm, torch.Generator().manual_seed(0), OptimizerConfig(),
                                 use_mems=True, batch=B, device="cpu")
        gen = torch.Generator().manual_seed(1)
        loss, _ = lm.loss(state["params"], tokens, gen=gen, train=True, mems=state["mems"])
        loss.backward()
        grads = [p.grad.clone() for p in tree_leaves(state["params"])]
        state, m = make_train_step(lm, OptimizerConfig())(state, tokens, gen)
        runs[mode] = (float(loss.detach()), grads, gen.get_state(), float(m["loss"]),
                      tree_leaves(state["params"]))
    (l0, g0, s0, m0, p0), (l1, g1, s1, m1, p1) = runs["none"], runs[remat]
    assert l0 == l1 and m0 == m1 and torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    _run_both({}, remat=remat)


def test_remat_relaunches_the_forward_kernels():
    """Wrapper calls a MoE layer makes in one step on the fused rung: 2 K1,
    1 K2, 2 K3 and 1 K4 plainly; under "full" and "dots" the backward
    recomputes the forward's K1 and K2 (3 K1, 2 K2, 2 K3, 1 K4); with
    grad_accum=2, twice each."""
    calls = collections.Counter()
    names = ("fused_w1", "fused_w2", "dw_streamed", "cvmm", "cvmm_dw", "gather_rows")
    real = {name: getattr(K, name) for name in names}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return call

    cfg = reduced(ARCH).override(dropout=0.1)
    tokens = {"tokens": torch.from_numpy(np.array(_stream().next()["tokens"]))}
    plain = {"fused_w1": 2, "fused_w2": 1, "dw_streamed": 2, "cvmm": 1}
    want = {"none": plain, "full": dict(plain, fused_w1=3, fused_w2=2)}
    want["dots"] = want["full"]
    ops.set_default_impl("pallas_fused")
    try:
        for name in names:
            setattr(K, name, counted(name))
        for remat, per_layer in want.items():
            for accum in (1, 2):
                lm = build_model(cfg, remat=remat)
                state = init_train_state(lm, torch.Generator().manual_seed(0),
                                         OptimizerConfig(), use_mems=True,
                                         batch=B // accum, device="cpu")
                calls.clear()
                make_train_step(lm, OptimizerConfig(), grad_accum=accum)(
                    state, tokens, torch.Generator().manual_seed(1))
                assert dict(calls) == {k: v * accum * cfg.n_layers
                                       for k, v in per_layer.items()}, (remat, accum)
    finally:
        ops.set_default_impl(None)
        for name in names:
            setattr(K, name, real[name])
