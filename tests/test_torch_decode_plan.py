"""The port's plan layer and expert MLP against the reference: integer plan
fields must be equal, float outputs equal at float32 1e-5 (the reference's
kernel tolerance), on the same numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import moe_ffn as jax_moe_ffn
from repro.core import dispatch as jdispatch
from repro.core import routing as jrouting
from repro.kernels import ops as jops
from repro_torch.configs.base import moe_ffn
from repro_torch.core import dispatch, routing
from repro_torch.kernels import ops

pytestmark = pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("gs", [[5, 0, 130, 1], [0, 0, 0, 9], [128, 128, 0]])
def test_tile_layout_equals_reference(gs):
    m, e = sum(gs), len(gs)
    jn, jt, jm = jops._tile_layout(jnp.asarray(gs, jnp.int32), m, e)
    tn, tt, tm = ops._tile_layout(torch.tensor(gs), m, e)
    assert tm == jm
    np.testing.assert_array_equal(_np(tn), _np(jn))
    np.testing.assert_array_equal(_np(tt), _np(jt))


@pytest.mark.parametrize("n_rows", [7, 64, 300])
def test_dedup_gather_plan_equals_reference(n_rows):
    rng = np.random.default_rng(n_rows)
    idx = rng.integers(0, n_rows, size=(10, 4))
    w = rng.random((10, 4)).astype(np.float32)
    jp = jops.make_dedup_gather_plan(jnp.asarray(idx), jnp.asarray(w), n_rows)
    tp = ops.make_dedup_gather_plan(torch.from_numpy(idx), torch.from_numpy(w),
                                    n_rows)
    for f in ("row_src", "sel_pos", "tok_src"):
        np.testing.assert_array_equal(_np(getattr(tp, f)), _np(getattr(jp, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(_np(tp.weights), _np(jp.weights))


@pytest.mark.parametrize("n,k,e", [(1, 8, 40), (8, 8, 40), (5, 2, 4), (32, 8, 40)])
def test_decode_plan_and_slots_equal_reference(n, k, e):
    jp = jops.make_decode_plan(n, k, e, 128, 128)
    tp = ops.make_decode_plan(n, k, e, device="cpu")
    assert (tp.cap, tp.m_pad) == (jp.cap, jp.m_pad)
    np.testing.assert_array_equal(_np(tp.tile_expert), _np(jp.tile_expert))
    for f in ("row_src", "sel_pos", "tok_src"):
        np.testing.assert_array_equal(_np(getattr(tp.gather, f)),
                                      _np(getattr(jp.gather, f)), err_msg=f)
    rng = np.random.default_rng(n * k)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(n)]).astype(np.int32)
    np.testing.assert_array_equal(
        _np(ops.decode_slots(tp, torch.from_numpy(idx))),
        _np(jops.decode_slots(jp, jnp.asarray(idx))))


def _moe_inputs(n, k, e, d, g, seed):
    rng = np.random.default_rng(seed)
    xf = rng.standard_normal((n, d)).astype(np.float32)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(n)]).astype(np.int32)
    gates = rng.random((n, k)).astype(np.float32)
    w1 = (rng.standard_normal((e, d, g)) * d ** -0.5).astype(np.float32)
    w1g = (rng.standard_normal((e, d, g)) * d ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((e, g, d)) * g ** -0.5).astype(np.float32)
    return xf, idx, gates, w1, w2, w1g


@pytest.mark.parametrize("n,glu,act", [(3, True, "relu"), (8, False, "gelu"),
                                       (16, True, "silu")])
def test_moe_mlp_decode_matches_reference(n, glu, act):
    k, e, d, g = 2, 4, 64, 32
    arrs = _moe_inputs(n, k, e, d, g, seed=n)
    w1g = arrs[5] if glu else None
    jplan = jops.make_decode_plan(n, k, e, d, g)
    want = jops.moe_mlp_decode(*map(jnp.asarray, arrs[:3]), jplan,
                               jnp.asarray(arrs[3]), jnp.asarray(arrs[4]),
                               None if w1g is None else jnp.asarray(w1g),
                               activation=act, interpret=True)
    t = [torch.from_numpy(a) for a in arrs]
    got = ops.moe_mlp_decode(t[0], t[1], t[2],
                             ops.make_decode_plan(n, k, e, device="cpu"),
                             t[3], t[4], None if w1g is None else t[5],
                             activation=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_selection_matches_reference_with_ties():
    cfg = moe_ffn(6, 8, 3, selector_activation="softmax", renormalize=True,
                  glu_experts=True, dispatch="sort")
    jcfg = jax_moe_ffn(6, 8, 3, selector_activation="softmax", renormalize=True,
                       glu_experts=True, dispatch="sort")
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 6)).astype(np.float32)
    logits[:4, 1] = logits[:4, 4] = logits[:4, 2]          # exact ties
    want = jrouting.select_experts(jnp.asarray(logits), jcfg, n_valid_experts=5)
    got = routing.select_experts(torch.from_numpy(logits), cfg, n_valid_experts=5)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.gates.numpy(), np.asarray(want.gates),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("impl", ["ragged", "ref", "pallas"])
def test_sort_path_rungs_match_reference(impl):
    import dataclasses
    n, k, e, d, g = 11, 2, 4, 64, 32
    xf, _, _, w1, w2, w1g = _moe_inputs(n, k, e, d, g, seed=5)
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((n, e)).astype(np.float32)
    cfg = dataclasses.replace(moe_ffn(e, g, k, selector_activation="softmax",
                                      renormalize=True, glu_experts=True,
                                      dispatch="sort"), impl=impl)
    jcfg = dataclasses.replace(jax_moe_ffn(e, g, k, selector_activation="softmax",
                                           renormalize=True, glu_experts=True,
                                           dispatch="sort"), impl="ragged")
    jinfo = jrouting.select_experts(jnp.asarray(logits), jcfg)
    info = routing.select_experts(torch.from_numpy(logits), cfg)
    params = {"we1": w1, "we2": w2, "we1g": w1g}
    want = jdispatch._sort_path({k_: jnp.asarray(v) for k_, v in params.items()},
                                jnp.asarray(xf), jcfg, jinfo, e)
    got = dispatch._sort_path({k_: torch.from_numpy(v) for k_, v in params.items()},
                              torch.from_numpy(xf), cfg, info, e)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_moe_plan_equals_reference():
    rng = np.random.default_rng(9)
    idx = np.stack([rng.permutation(6)[:3] for _ in range(50)]).astype(np.int32)
    jp = jops.make_moe_plan(jnp.asarray(idx), jnp.ones((50, 3)), 50, 7)
    tp = ops.make_moe_plan(torch.from_numpy(idx), 7)
    for f in ("perm", "group_sizes", "new_pos", "tile_expert"):
        np.testing.assert_array_equal(_np(getattr(tp, f)), _np(getattr(jp, f)),
                                      err_msg=f)


@pytest.mark.parametrize("shared", [0, 1])
def test_apply_moe_matches_reference(shared):
    from repro.core.moe import apply_moe as jax_apply_moe
    from repro_torch.core.moe import apply_moe
    kw = dict(selector_activation="softmax", renormalize=True, glu_experts=True,
              n_shared_experts=shared, reg_kind="switch", reg_gamma=0.01,
              dispatch="sort")
    e, g, d = 4, 32, 64
    rng = np.random.default_rng(shared)
    params = {"we1": rng.standard_normal((e, d, g)) * d ** -0.5,
              "we1g": rng.standard_normal((e, d, g)) * d ** -0.5,
              "we2": rng.standard_normal((e, g, d)) * g ** -0.5,
              "router": rng.standard_normal((d, e)) * d ** -0.5}
    if shared:
        params.update(shared_w1=rng.standard_normal((1, d, g)) * d ** -0.5,
                      shared_w1g=rng.standard_normal((1, d, g)) * d ** -0.5,
                      shared_w2=rng.standard_normal((1, g, d)) * g ** -0.5)
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    want, jaux = jax_apply_moe({k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(x), jax_moe_ffn(e, g, 2, **kw))
    got, aux = apply_moe({k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(x), moe_ffn(e, g, 2, **kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux["moe_reg"]), float(jaux["moe_reg"]),
                               rtol=1e-5)
