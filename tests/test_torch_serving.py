"""The port's continuous-batching Engine against the reference's Engine:
the same converted parameters and the same mixed requests must give the
same greedy tokens (float32, reduced granite-moe, decode plans on)."""
import numpy as np
import jax
import pytest

from repro.configs import reduced as jax_reduced
from repro.models.lm import LM as JaxLM
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import reduced
from repro_torch.convert import from_jax_params
from repro_torch.kernels import cvmm as K
from repro_torch.models import LM
from repro_torch.serving import (DecodePlanCache, Engine, PagedKVCache, Request,
                                 capture_sizes, pick_capture)

pytestmark = pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")

ARCH = "granite-moe-3b-a800m"
ENGINE_KW = dict(max_batch=2, max_len=32, page_size=8, burst_steps=3,
                 prefill_chunk=8)


def _requests():
    rng = np.random.default_rng(1)
    return [(i, rng.integers(1, 256, size=int(rng.integers(3, 14))).tolist(),
             int(rng.integers(2, 8))) for i in range(4)]


@pytest.fixture(scope="module")
def reference():
    """The reference engine's outputs, computed once per module (its jit
    compile is most of this file's time)."""
    jlm = JaxLM(jax_reduced(ARCH).override(dtype="float32"))
    jparams = jlm.init(jax.random.PRNGKey(0))
    eng = JaxEngine(jlm, jparams, **ENGINE_KW)
    try:
        outs = eng.run([JaxRequest(rid=i, prompt=p, max_new=m)
                        for i, p, m in _requests()])
    finally:
        eng.close()
    lm = LM(reduced(ARCH).override(dtype="float32"))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), lm.cfg,
                             device="cpu")
    return outs, lm, params


@pytest.mark.parametrize("decode_plans", [True, False])
def test_engine_greedy_matches_reference_engine(reference, decode_plans):
    want, lm, params = reference
    with Engine(lm, params, use_decode_plans=decode_plans, device="cpu",
                **ENGINE_KW) as eng:
        got = eng.run([Request(rid=i, prompt=p, max_new=m)
                       for i, p, m in _requests()])
        assert eng.stats["completed"] == 4 and not eng.kv._owned
        if decode_plans:
            assert eng.plan_cache.rebuilds >= 1 and eng.plan_cache.hits > 0
    assert got == want


def test_engine_runs_on_cpu_without_kernel_launches(reference):
    _, lm, params = reference
    K.reset_launch_counts()
    with Engine(lm, params, device="cpu", **ENGINE_KW) as eng:
        eng.run([Request(rid="a", prompt=[3, 4, 5], max_new=3)])
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)


def test_engine_eos_and_cancel(reference):
    _, lm, params = reference
    with Engine(lm, params, device="cpu", **ENGINE_KW) as eng:
        t0 = eng.run([Request(rid="probe", prompt=[5, 9, 2], max_new=1)])["probe"][0]
        outs = eng.run([Request(rid="eos0", prompt=[5, 9, 2], max_new=6, eos=t0)])
        assert outs["eos0"] == [t0]
        eng.submit(Request(rid="keep", prompt=[2, 4, 6], max_new=6))
        eng.submit(Request(rid="evict", prompt=[1, 3, 5], max_new=6))
        while eng.sched or eng._partial is not None:
            eng.step()
        assert eng.cancel("evict") and not eng.cancel("evict")
        while eng.has_work():
            eng.step()
        assert len(eng.outputs["keep"]) == 6 and len(eng.outputs["evict"]) < 6
        assert not eng.kv._owned


def test_allocator_capture_sizes_and_plan_cache():
    kv = PagedKVCache(n_pages=8, page_size=4)
    a = kv.alloc("a", 9)
    assert len(a) == 3 and 0 not in a and kv.free_pages == 4
    kv.free("a")
    assert kv.alloc("c", 12) == a                     # LIFO reuse
    assert capture_sizes(6) == (1, 2, 4, 6) and pick_capture(3, (1, 2, 4, 8)) == 4
    cache = DecodePlanCache()
    p1 = cache.skeleton(4, 2, 4, "cpu")
    assert cache.skeleton(4, 2, 4, "cpu") is p1
    cache.skeleton(8, 2, 4, "cpu")
    assert cache.counters() == {"rebuilds": 2, "hits": 1, "assembles": 0,
                                "assembled_hits": 0}
