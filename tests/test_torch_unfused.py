"""The port's unfused planned rung against the reference, on the CPU: K5's
plain version against ``cvmm_dw_pallas`` in interpret mode, ``cvmm_planned``
and the bare ``cvmm`` with their gradients, the sort path on the "pallas"
rung, and the rung resolution (``plan_sort_kernels``), on the same numpy
inputs.

Tolerances are the reference's own (tests/test_kernels_cvmm_fused.py):
float32 kernel outputs 1e-5, gradients 2e-4. K5's outputs are float32 sums
of the same products in either input type, so bf16 inputs get 1e-5 too.
The reference's kernels run in Pallas interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import moe_ffn as jax_moe_ffn
from repro.core import dispatch as jdispatch
from repro.core import routing as jrouting
from repro.kernels import ops as jops
from repro.kernels.cvmm import cvmm_dw_pallas
from repro_torch.configs.base import moe_ffn
from repro_torch.core import dispatch, routing
from repro_torch.kernels import cvmm as K
from repro_torch.kernels import ops

pytestmark = pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")

N, TOPK, E, D, G = 40, 2, 4, 64, 32        # reduced wt103-47m-moe's MoE layer
ACTIVATIONS = ("relu", "gelu", "silu", "softmax", "identity")


def _t(a):
    return torch.from_numpy(np.array(a))


def _routing(seed, n=N, k=TOPK, e=E, skip=None):
    """Distinct experts per token, optionally never choosing ``skip``."""
    rng = np.random.default_rng(seed)
    pool = [x for x in range(e) if x != skip]
    return np.stack([rng.permutation(pool)[:k] for _ in range(n)]).astype(np.int32)


def _weights(rng, d=D, g=G, e=E):
    w1, w1g = ((rng.standard_normal((e, d, g)) * d ** -0.5).astype(np.float32)
               for _ in range(2))
    w2 = (rng.standard_normal((e, g, d)) * g ** -0.5).astype(np.float32)
    return w1, w1g, w2


# ---------------------------------------------------------------------------
# K5's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [(jnp.float32, torch.float32),
                                   (jnp.bfloat16, torch.bfloat16)],
                         ids=["float32", "bfloat16"])
def test_cvmm_dw_plain_matches_pallas(dtype):
    jdt, tdt = dtype
    rng = np.random.default_rng(51)
    idx = _routing(51, skip=1)                         # expert 1 has no rows
    plan = jops.make_moe_plan(jnp.asarray(idx), jnp.ones(idx.shape), N, E)
    m_pad, rows = plan.m_pad, idx.size
    new_pos = np.asarray(plan.new_pos)
    # tile-aligned operands, slack rows zero; sums of ~N*K/E rows stay O(1)
    x_pad = np.zeros((m_pad, 128), np.float32)
    g_pad = np.zeros((m_pad, 256), np.float32)
    x_pad[new_pos] = rng.standard_normal((rows, 128))
    g_pad[new_pos] = rng.standard_normal((rows, 256)) * (rows / E) ** -0.5
    te = np.asarray(plan.tile_expert)
    assert te[-1] == E - 1 and (te == 1).sum() == 0    # clamped slack, empty expert
    want = jops._mask_empty(
        cvmm_dw_pallas(jnp.asarray(x_pad, jdt), plan.tile_expert,
                       jnp.asarray(g_pad, jdt), E, interpret=True),
        plan.group_sizes)
    got = K.cvmm_dw(_t(x_pad).to(tdt), _t(te), _t(g_pad).to(tdt), E)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool((got[1] == 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The unfused grouped matmul with its backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["cvmm_planned", "cvmm"])
def test_unfused_cvmm_matches_reference_with_gradients(entry):
    rng = np.random.default_rng(52)
    idx = _routing(52, skip=3)
    w1, _, _ = _weights(rng)
    e_flat = idx.reshape(-1)
    x = rng.standard_normal((e_flat.size, D)).astype(np.float32)   # sorted rows
    cot = rng.standard_normal((e_flat.size, G)).astype(np.float32)
    gs = np.bincount(e_flat, minlength=E).astype(np.int32)

    if entry == "cvmm_planned":
        jplan = jops.make_moe_plan(jnp.asarray(idx), jnp.ones(idx.shape), N, E)
        tplan = ops.make_moe_plan(_t(idx), E)

        def jfn(x, w):
            return jops.cvmm_planned(x, jplan, w, interpret=True)

        def tfn(x, w):
            return ops.cvmm_planned(x, tplan, w)
    else:
        def jfn(x, w):
            return jops.cvmm(x, jnp.asarray(gs), w, impl="pallas_interpret")

        def tfn(x, w):
            return ops.cvmm(x, _t(gs), w, impl="pallas")

    jy, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w1))
    jdx, jdw = vjp(jnp.asarray(cot))
    tx, tw = _t(x).requires_grad_(), _t(w1).requires_grad_()
    y = tfn(tx, tw)
    (y * _t(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=2e-4, rtol=2e-4)
    assert bool((tw.grad[3] == 0).all())                # the expert with no rows


def test_cvmm_accepts_every_kernel_name_and_rejects_others():
    rng = np.random.default_rng(53)
    x = _t(rng.standard_normal((9, D)).astype(np.float32))
    w = _t(rng.standard_normal((E, D, G)).astype(np.float32))
    gs = torch.tensor([2, 0, 4, 3])
    want = ops.cvmm(x, gs, w, impl="ragged")
    for impl in ("pallas", "pallas_interpret", "pallas_fused",
                 "pallas_fused_interpret", None):
        torch.testing.assert_close(ops.cvmm(x, gs, w, impl=impl), want,
                                   atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown cvmm impl"):
        ops.cvmm(x, gs, w, impl="triton")


# ---------------------------------------------------------------------------
# The sort path on the unfused rung, and the rung resolution
# ---------------------------------------------------------------------------

def _sort_path_pair(impl, glu, act, seed):
    """Output and gradients (x, router logits, w1, w2[, w1g]) of one sort-path
    call in both packages, on the same inputs."""
    n, k, e, d, g = 16, TOPK, E, D, G
    rng = np.random.default_rng(seed)
    xf = rng.standard_normal((n, d)).astype(np.float32)
    logits = rng.standard_normal((n, e)).astype(np.float32)
    w1, w1g, w2 = _weights(rng, d, g, e)
    cot = rng.standard_normal((n, d)).astype(np.float32)
    kw = dict(selector_activation="sigmoid", glu_experts=glu, activation=act,
              dispatch="sort")
    cfg = dataclasses.replace(moe_ffn(e, g, k, **kw), impl=impl)
    jcfg = dataclasses.replace(jax_moe_ffn(e, g, k, **kw), impl=impl)
    names = ("we1", "we2") + (("we1g",) if glu else ())
    ws = dict(zip(("we1", "we2", "we1g"), (w1, w2, w1g)))

    def jfn(xf, logits, *w):
        info = jrouting.select_experts(logits, jcfg)
        return jdispatch._sort_path(dict(zip(names, w)), xf, jcfg, info, e)

    jy, vjp = jax.vjp(jfn, jnp.asarray(xf), jnp.asarray(logits),
                      *(jnp.asarray(ws[k_]) for k_ in names))
    jgrads = vjp(jnp.asarray(cot))
    ins = [_t(a).requires_grad_() for a in (xf, logits, *(ws[k_] for k_ in names))]
    info = routing.select_experts(ins[1], cfg)
    y = dispatch._sort_path(dict(zip(names, ins[2:])), ins[0], cfg, info, e)
    (y * _t(cot)).sum().backward()
    return (y.detach(), [t.grad for t in ins]), (jy, jgrads)


def _assert_pair(got, want):
    (y, grads), (jy, jgrads) = got, want
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    for i, (g_, jg) in enumerate(zip(grads, jgrads)):
        np.testing.assert_allclose(g_.numpy(), np.asarray(jg), atol=2e-4, rtol=2e-4,
                                   err_msg=f"gradient {i}")
    assert float(grads[1].abs().sum()) > 0             # the router gets a gradient


@pytest.mark.parametrize("glu", [False, True], ids=["plain", "glu"])
def test_sort_path_on_the_unfused_rung_matches_reference(glu):
    _assert_pair(*_sort_path_pair("pallas", glu, "relu", seed=54 + glu))


def test_softmax_activation_under_pallas_fused_runs_the_unfused_rung():
    """A non-tile-local activation degrades "pallas_fused" to "pallas" in
    both packages, and the port's call runs and matches the reference."""
    want = jops.plan_sort_kernels("pallas_fused", D, G, "softmax").rung
    got = ops.plan_sort_kernels("pallas_fused", D, G, "softmax").rung
    assert got == want == "pallas"
    _assert_pair(*_sort_path_pair("pallas_fused", False, "softmax", seed=56))


def test_pinned_default_impl_reaches_the_sort_path(monkeypatch):
    calls, planned = [], ops.cvmm_planned
    monkeypatch.setattr(ops, "cvmm_planned",
                        lambda *a: calls.append(1) or planned(*a))
    cfg = moe_ffn(E, G, TOPK, dispatch="sort")
    assert cfg.impl == "auto" and ops.default_impl("cpu") == "ragged"
    xf, logits = torch.randn(8, D), torch.randn(8, E)
    params = {"we1": torch.randn(E, D, G), "we2": torch.randn(E, G, D)}
    info = routing.select_experts(logits, cfg)
    want = dispatch._sort_path(params, xf, cfg, info, E)
    ops.set_default_impl("pallas")
    try:
        assert ops.default_impl("cpu") == ops.default_impl("cuda") == "pallas"
        got = dispatch._sort_path(params, xf, cfg, info, E)
    finally:
        ops.set_default_impl(None)
    assert len(calls) == 2 and ops.default_impl("cuda") == "pallas_fused"
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["pallas_fused", "pallas_fused_interpret", "pallas",
                                  "pallas_interpret", "ragged", "ref", "auto"])
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_plan_sort_kernels_rung_equals_reference(act, impl):
    for d, g in ((D, G), (412, 128)):                  # reduced and full widths
        for glu in (False, True):
            for jdt, tdt in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, torch.bfloat16)):
                want = jops.plan_sort_kernels(impl, d, g, act, jdt, glu=glu).rung
                got = ops.plan_sort_kernels(impl, d, g, act, tdt, glu=glu).rung
                assert got == want, (d, g, glu, tdt)
                assert (ops.fused_supported(0, d, g, act, tdt, glu)
                        == jops.fused_supported(0, d, g, act, jdt, glu))
                assert (ops.pallas_supported(d, g, tdt)
                        == jops.pallas_supported(d, g, jdt))
