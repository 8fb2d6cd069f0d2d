"""The decode plan's second level against the reference: the full
``CvmmPlan`` a skeleton and a routing assemble into, the assembled cache's
counters, the grouped GEMM on it against the decode path, and the plans'
row counts (``plan_dma_stats``). Integer fields must be equal, gates
within 1e-6, float32 outputs within 1e-5, on the same numpy routings.

The reference's skeletons for ``assemble_decode_plan`` are built from its
``DecodePlan`` fields as its ``make_decode_plan`` builds them (the gather
plan, which assembly does not read, left out); the skeletons themselves
are held equal in ``tests/test_torch_decode_plan.py``. The reference's
plan builders run under ``jax.jit``, one compile a shape, which costs a
fraction of their eager ops' compiles; its assembled cache is given the
same jitted ``assemble_decode_plan``."""
import functools

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.serving.decode_plan import DecodePlanCache as JaxDecodePlanCache
from repro_torch.common import act_fn
from repro_torch.kernels import ops
from repro_torch.serving import DecodePlanCache

pytestmark = pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")

E, K_TOP = 40, 8            # granite-moe-3b-a800m's routing: top-8 of 40


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _jax_skeleton(n, k=K_TOP, e=E):
    cap = -(-n * k // 128) * 128
    return jops.DecodePlan(n_tokens=n, k=k, n_experts=e, cap=cap,
                           tile_expert=jnp.repeat(jnp.arange(e, dtype=jnp.int32), cap // 128),
                           gather=None, gather_nb=None, w1_tn=128, w2_tn=128,
                           provenance="heuristic")


@functools.lru_cache(maxsize=None)
def _jax_assemble(n):
    """The reference's ``assemble_decode_plan`` over ``n`` tokens' skeleton,
    jitted: fn(idx, gates) -> CvmmPlan."""
    skel = _jax_skeleton(n)
    return jax.jit(lambda idx, gates: jops.assemble_decode_plan(skel, idx, gates))


def _routing(n, seed, e=E, k=K_TOP):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(n)]).astype(np.int32)
    return idx, rng.random((n, k)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 8, 32])
def test_assembled_plan_equals_reference(n):
    idx, gates = _routing(n, seed=n)
    jfull = _jax_assemble(n)(jnp.asarray(idx), jnp.asarray(gates))
    tfull = ops.assemble_decode_plan(ops.make_decode_plan(n, K_TOP, E, device="cpu"),
                                     torch.from_numpy(idx), torch.from_numpy(gates))
    for f in ("perm", "group_sizes", "new_pos", "row_src", "tile_expert"):
        np.testing.assert_array_equal(_np(getattr(tfull, f)), _np(getattr(jfull, f)),
                                      err_msg=f)
    np.testing.assert_allclose(_np(tfull.gate_tiles), _np(jfull.gate_tiles), atol=1e-6,
                               rtol=0)
    assert ops.plan_dma_stats(tfull, n, verify=True) == {"per_row": n * K_TOP}


def test_assembled_cache_counters_follow_reference(monkeypatch):
    # the skeleton level's counters are held in tests/test_torch_serving.py
    monkeypatch.setattr(jops, "assemble_decode_plan",
                        lambda plan, idx, gates: _jax_assemble(plan.n_tokens)(idx, gates))
    jcache, tcache = JaxDecodePlanCache(), DecodePlanCache()
    jskel, tskel = _jax_skeleton(8), ops.make_decode_plan(8, K_TOP, E, device="cpu")
    idx, gates = _routing(8, seed=0)
    calls = [(idx, gates), (idx, gates), ((idx + 1) % E, gates), (idx, gates),
             ((idx + 1) % E, gates * 0.5)]
    for i, g in calls:
        ja = jcache.assembled(jskel, jnp.asarray(i), jnp.asarray(g))
        ta = tcache.assembled(tskel, torch.from_numpy(i), torch.from_numpy(g))
        np.testing.assert_array_equal(_np(ta.row_src), _np(ja.row_src))
        assert tcache.counters() == jcache.counters()
    assert tcache.counters() == {"rebuilds": 0, "hits": 0, "assembles": 3,
                                 "assembled_hits": 2}


def test_cvmm_planned_on_assembled_plan_equals_moe_mlp_decode():
    n, k, e, d, g = 8, 2, 4, 64, 32
    rng = np.random.default_rng(7)
    xf = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    idx, gates = (torch.from_numpy(a) for a in _routing(n, seed=7, e=e, k=k))
    w1 = torch.from_numpy((rng.standard_normal((e, d, g)) * d ** -0.5).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((e, g, d)) * g ** -0.5).astype(np.float32))
    skel = ops.make_decode_plan(n, k, e, d, g, torch.float32, device="cpu")
    want = ops.moe_mlp_decode(xf, idx, gates, skel, w1, w2, activation="gelu")
    full = ops.assemble_decode_plan(skel, idx, gates)
    tok = torch.arange(n).repeat_interleave(k)[full.perm]
    u = act_fn("gelu")(ops.cvmm_planned(xf[tok], full, w1))
    y_sorted = ops.cvmm_planned(u, full, w2) * gates.reshape(-1)[full.perm][:, None]
    got = torch.zeros_like(xf).index_add_(0, tok, y_sorted)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_plan_dma_stats_equal_reference():
    # a dedup plan of 8 tokens x 8 selections of a table of 8 rows (colliding
    # selections), and the decode layout assembled for 8 tokens
    rng = np.random.default_rng(11)
    idx, gates = _routing(8, seed=11)
    w = rng.random((8, K_TOP)).astype(np.float32)
    t_idx, t_w = torch.from_numpy(idx), torch.from_numpy(w)
    pairs = [
        (jax.jit(lambda i, ww: jops.make_dedup_gather_plan(i, ww, 8))(
            jnp.asarray(idx % 8), jnp.asarray(w)),
         ops.make_dedup_gather_plan(t_idx % 8, t_w, 8), 8),
        (_jax_assemble(8)(jnp.asarray(idx), jnp.asarray(gates)),
         ops.assemble_decode_plan(ops.make_decode_plan(8, K_TOP, E, device="cpu"), t_idx,
                                  torch.from_numpy(gates)), 8)]
    for jplan, tplan, n_rows in pairs:
        want = jops.plan_dma_stats(jplan, n_rows, verify=True)
        got = ops.plan_dma_stats(tplan, n_rows, verify=True)
        assert got == {key: want[key] for key in ("per_row", "unique_rows") if key in want}
