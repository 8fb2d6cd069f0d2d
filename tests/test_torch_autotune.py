"""The port's tile layer: the autotuner's heuristic is the schedule the
kernels launched before it existed (frozen copies below, at the main paths'
shapes on 132 SMs), its tuned mode and cache behave as the reference's
(``tests/test_autotune.py``), and the hardware model's ``model_flops``
equals the reference's.

Nothing is timed here: tuned mode runs on injected timings
(``autotune.set_benchmark_override``), counted by
``STATS["microbench_calls"]``, on CPU tensors' decisions."""
import json
import os
import re
from pathlib import Path

import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.roofline import analysis as jax_roofline
from repro_torch.configs import get_config
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import cvmm as K
from repro_torch.kernels import flash_attention as K7
from repro_torch.roofline import analysis as roofline

CSRC = Path(K.__file__).resolve().parent / "csrc"
SMS = 132


# Frozen copies of the four schedule formulas as the kernels launched them
# before the tuner: any drift of the heuristic fails the first test.

def frozen_row_gemm_bn(m_pad, k_pad, n_pad, n_sms, glu=False, save=False):
    n_tiles = m_pad // 128
    shallow = k_pad < 512
    widest = 64 if glu else 128 if save or shallow else 256
    bn = 64
    for width in (256, 128):
        if (width <= widest and n_pad % width == 0
                and n_tiles * (n_pad // width) >= 2 * n_sms):
            bn = width
            break
    return bn


def frozen_gather_rows(m_pad, row_bytes, n_sms):
    nvec = row_bytes // 16
    vpl = 2 if nvec > 32 else 1
    slices = -(-nvec // (32 * vpl))
    for rows in (8, 4, 2):
        if m_pad // rows * slices >= n_sms:
            return rows, vpl
    return 1, vpl


FROZEN_DW_CHUNK = 5


def frozen_flash_splits(b, sq, h, kvh, sk, q_offset, causal, n_sms, bk):
    grp = h // kvh
    n_rt = -(-sq * grp // 128)
    items = b * kvh * n_rt
    last = min(sq - 1, ((n_rt - 1) * 128 + 127) // grp)
    keys = min(sk, q_offset + last + 1) if causal else sk
    longest = -(-max(keys, 0) // bk)
    return max(1, min(longest // 4, n_sms // items))


GRANITE = (1536, 512, 40)                         # d_model, expert_size, experts
M47 = ops.plan_m_pad(32 * 256 * 4, 16)            # wt103-47m-moe, batch 32 x 256
M262 = ops.plan_m_pad(16 * 512 * 4, 32)           # wt103-262m-moe, batch 16 x 512
# (kernel, M_pad, K_pad, N_pad, glu, save): serve decode at 1 and 2 tiles an
# expert, serve-long's prefill chunk on the decode plan, the 47M and 262M
# fused steps (K1 forward with and without saved pre-activations, t0, K2,
# dX) and the unfused rung's K4, GLU and save_preact variants
ROW_GEMM_SHAPES = [
    ("cvmm", 5120, 1536, 512, False, False), ("cvmm", 5120, 512, 1536, False, False),
    ("cvmm", 10240, 1536, 512, False, False), ("cvmm", 10240, 512, 1536, False, False),
    ("cvmm", 81920, 1536, 512, False, False), ("cvmm", 81920, 512, 1536, False, False),
    ("fused_w1", M47, 512, 128, False, False), ("fused_w1", M47, 512, 128, False, True),
    ("fused_w1", M47, 512, 128, True, False), ("fused_w1", M47, 512, 128, True, True),
    ("fused_w2", M47, 128, 512, False, False), ("cvmm", M47, 128, 512, False, False),
    ("cvmm", M47, 512, 128, False, False), ("fused_w1", M262, 1024, 128, False, True),
    ("fused_w2", M262, 128, 1024, False, False), ("cvmm", M262, 128, 1024, False, False),
    ("fused_w1", 5120, 1536, 512, True, True), ("fused_w1", 1024, 256, 512, False, True)]
# (M_pad, row bytes): decode's token gather (1-32 tokens in 128 rows), the
# prefill chunk's 256 rows, PKM's and top-K's value rows, a short row
GATHER_SHAPES = [(128, 3072), (256, 3072), (128, 1536), (2048, 824), (16384, 824),
                 (384, 16)]
# (B, Sq, H, KV, Sk, q_offset, causal, D): serve-long's chunks at three
# offsets, serve's 32-token chunk, zamba2's D 112 prefill, a full-mask case
FLASH_SHAPES = [(1, 256, 24, 8, 4096, 3840, True, 64), (1, 256, 24, 8, 256, 0, True, 64),
                (1, 256, 24, 8, 2048, 1792, True, 64), (8, 32, 24, 8, 96, 64, True, 64),
                (4, 600, 32, 32, 600, 0, True, 112), (2, 128, 4, 2, 128, 0, False, 128)]


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    """A private cache directory and a clean tuner, off unless a test turns
    it on."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    autotune.reset()
    autotune.enable(False)
    yield tmp_path
    autotune.enable(None)
    autotune.set_benchmark_override(None)
    autotune.reset()


def test_heuristic_is_the_frozen_schedules_and_model_flops_the_references(tuner):
    for kernel, m_pad, k_pad, n_pad, glu, save in ROW_GEMM_SHAPES:
        bn, items, grid = K.row_gemm_schedule(m_pad, k_pad, n_pad, SMS, glu, save,
                                              kernel=kernel)
        want = frozen_row_gemm_bn(m_pad, k_pad, n_pad, SMS, glu, save)
        assert bn == want, (kernel, m_pad, k_pad, n_pad, glu, save)
        assert (items, grid) == (m_pad // 128 * (n_pad // bn),
                                 min(m_pad // 128 * (n_pad // bn), SMS))
        assert bn in autotune.ROW_GEMM_WIDTHS[(glu, save)]
    for m_pad, row_bytes in GATHER_SHAPES:
        assert K.gather_rows_schedule(m_pad, row_bytes, SMS) == frozen_gather_rows(
            m_pad, row_bytes, SMS)
    for m_pad, e, k_pad, n_pad in ((M47, 16, 512, 128), (M47, 16, 128, 512),
                                   (M262, 32, 1024, 128), (81920, 40, 1536, 512)):
        for kernel in ("dw_streamed", "cvmm_dw"):
            assert K.dw_chunk(kernel, m_pad, e, k_pad, n_pad, 2) == FROZEN_DW_CHUNK
    for b, sq, h, kvh, sk, off, causal, d in FLASH_SHAPES:
        bk = K7.FLASH_BK[d]
        _, items, splits, grid = K7.flash_schedule(b, sq, h, kvh, sk, off, causal, SMS, bk,
                                                   d=d)
        assert splits == frozen_flash_splits(b, sq, h, kvh, sk, off, causal, SMS, bk)
        assert grid == items * splits
    # the decisions the ops layer threads: the decode skeleton's and the fused rung's
    d, g, e = GRANITE
    plan = ops.make_decode_plan(8, 8, e, d, g, torch.bfloat16, device="cpu")
    assert (plan.w1_bn, plan.w2_bn) == (frozen_row_gemm_bn(plan.m_pad, d, g, SMS),
                                        frozen_row_gemm_bn(plan.m_pad, g, d, SMS))
    assert plan.gather_schedule == frozen_gather_rows(128, d * 2, SMS)
    assert plan.provenance == "heuristic"
    ft = ops.fused_mlp_tiles(M47, 412, 128, 16, torch.bfloat16, False, "cpu")
    assert (ft.w1_bn, ft.w1_train_bn, ft.w2_bn, ft.dx_bn, ft.dw1_chunk) == (
        frozen_row_gemm_bn(M47, 512, 128, SMS), frozen_row_gemm_bn(M47, 512, 128, SMS,
                                                                   save=True),
        frozen_row_gemm_bn(M47, 128, 512, SMS), frozen_row_gemm_bn(M47, 128, 512, SMS),
        FROZEN_DW_CHUNK)
    assert autotune.STATS["microbench_calls"] == 0
    # the instantiated widths the candidates read are the sources'
    row_gemm = (CSRC / "row_gemm.cuh").read_text()
    assert {int(w) for w in re.findall(r"integral_constant<int, (\d+)>", row_gemm)} == {
        w for ws in autotune.ROW_GEMM_WIDTHS.values() for w in ws}
    gather = (CSRC / "gather_rows.cu").read_text()
    assert set(map(int, re.findall(r"rows != (\d+)", gather))) == set(autotune.GATHER_ROWS)
    assert set(map(int, re.findall(r"vpl != (\d+)", gather))) == set(autotune.GATHER_VPL)
    # the hardware model and the useful operation count
    assert (roofline.H100.n_sms, roofline.H100.smem_block_bytes) == (132, 232448)
    assert roofline.hardware_for("cpu") is roofline.CPU_STANDIN
    for name in ("wt103-47m-dense", "wt103-47m-moe", "wt103-262m-dense", "wt103-262m-moe",
                 "enwik8-41m-dense", "enwik8-41m-moe"):
        for shape in JAX_SHAPES.values():
            assert roofline.model_flops(get_config(name), shape) == \
                jax_roofline.model_flops(jax_get_config(name), shape), (name, shape.name)


def _spy(calls, time_of=None):
    def fn(family, shape, tiles):
        calls.append((family, dict(shape), dict(tiles)))
        return 100.0 if time_of is None else time_of(tiles)
    return fn


ROW_47M = {"kernel": "fused_w2", "m_pad": M47, "k_pad": 128, "n_pad": 512, "glu": False,
           "save": False, "n_experts": 16, "b": 2, "sms": SMS}


def test_tuned_winner_cache_schema_merge_and_budget(tuner):
    autotune.enable(True)
    calls = []
    # the narrowest width times fastest; the heuristic (128) would not be it
    autotune.set_benchmark_override(_spy(calls, lambda t: {64: 10.0}.get(t.get("bn"), 50.0)))
    d = autotune.decide("row_gemm", ROW_47M, device="cpu")
    assert d == autotune.TileDecision({"bn": 64}, "tuned")
    assert 2 <= autotune.STATS["microbench_calls"] == len(calls) <= autotune.TUNE_TOP_K + 1
    assert {c[2]["bn"] for c in calls} <= set(autotune.ROW_GEMM_WIDTHS[(False, False)])
    # timed at the call's own shape, the heuristic's width among the timed
    assert [c[1] for c in calls] == [ROW_47M] * len(calls)
    assert calls[0][2] == {"bn": frozen_row_gemm_bn(M47, 128, 512, SMS)}
    # the reference's schema, published atomically
    path = autotune.cache_path("cpu")
    data = json.load(open(path))
    assert (data["schema"], data["backend"], data["hardware"]) == (
        autotune.SCHEMA_VERSION, "cpu", "cpu_standin")
    (key, entry), = data["entries"].items()
    assert key.startswith("row_gemm|") and f"|m_pad={M47}|" in key and "sms" not in key
    assert entry["tiles"] == {"bn": 64} and entry["provenance"] == "tuned"
    assert entry["us"] == 10.0 and entry["estimate_s"] > 0
    assert not [f for f in os.listdir(tuner) if f.startswith(".tune-")]
    # a warm cache (a new process: memory dropped) times nothing
    autotune.reset()
    assert autotune.decide("row_gemm", ROW_47M, device="cpu").tiles == {"bn": 64}
    assert autotune.STATS["microbench_calls"] == 0 and autotune.STATS["cache_hits"] == 1
    # a second writer, cold, keeps the first writer's entry; K3's dW2 is
    # keyed and timed as the gated variant it runs, with DW_CHUNK among the timed
    autotune.reset(memory_only=True)
    del calls[:]
    dw2 = {"kernel": "dw_streamed", "m_pad": M47, "n_experts": 16, "k_pad": 128,
           "n_pad": 512, "b": 2, "stream_x": 0, "gated": 1}
    autotune.decide("dw_split", dw2, device="cpu")
    assert [c[1] for c in calls] == [dw2] * len(calls)
    assert calls[0][2] == {"chunk": FROZEN_DW_CHUNK}
    entries = json.load(open(path))["entries"]
    assert len(entries) == 2 and any("|gated=1|" in k and "|stream_x=0" in k for k in entries)
    # a near-tie (1.5 %, within the timings' noise) keeps the heuristic's width
    autotune.set_benchmark_override(_spy(calls, lambda t: {64: 98.5}.get(t.get("bn"), 100.0)))
    assert autotune.decide("row_gemm", dict(ROW_47M, kernel="cvmm"),
                           device="cpu").tiles == {"bn": 128}
    # an entry that a smaller budget makes illegal is tuned again
    autotune.reset()
    autotune.set_benchmark_override(_spy(calls, lambda t: {256: 1.0}.get(t["bn"], 5.0)))
    wide = dict(ROW_47M, kernel="cvmm", k_pad=512)
    assert autotune.decide("row_gemm", wide, device="cpu").tiles == {"bn": 256}
    tuned = autotune.STATS["tuned"]
    d = autotune.decide("row_gemm", wide, device="cpu",
                        budget=autotune.smem_bytes("row_gemm", wide, {"bn": 128}))
    assert d.tiles["bn"] != 256 and d.provenance == "tuned"
    assert autotune.STATS["tuned"] == tuned + 1
    d = autotune.decide("row_gemm", wide, device="cpu",
                        budget=autotune.smem_bytes("row_gemm", wide, {"bn": 64}) - 1)
    assert d == autotune.TileDecision(None, "none")           # nothing fits at all
    # K7's splits, tuned for a class of 8 key tiles, cut to a 6-tile call's 1
    short = {"b": 1, "sq": 256, "h": 24, "kvh": 8, "sk": 384, "q_offset": 128,
             "causal": True, "d": 64, "bk": 64, "sms": SMS}
    autotune.set_benchmark_override(_spy(calls, lambda t: -t["splits"]))
    assert autotune.decide("flash", short, device="cpu").tiles == {"splits": 1}
    flash = [e for k, e in json.load(open(path))["entries"].items() if k.startswith("flash|")]
    assert [e["tiles"] for e in flash] == [{"splits": 2}]
    # a class not yet in the cache is not timed inside a profiler's region
    with torch.autograd.profiler.profile():
        with pytest.raises(RuntimeError, match="profiler"):
            autotune.decide("row_gemm", dict(ROW_47M, n_pad=1024), device="cpu")


@pytest.mark.parametrize("payload", [
    "{ not json at all",                                 # corrupt
    json.dumps({"schema": 999, "entries": {}}),          # another schema
    json.dumps({"schema": autotune.SCHEMA_VERSION}),     # no entries
    json.dumps([1, 2, 3]),                               # wrong type
])
def test_invalid_cache_discarded_and_rebuilt(tuner, payload):
    autotune.enable(True)
    autotune.set_benchmark_override(_spy([]))
    path = autotune.cache_path("cpu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(payload)
    d = autotune.decide("row_gemm", ROW_47M, device="cpu")
    assert d.tiles is not None and d.provenance == "tuned"     # never raises
    assert autotune.STATS["cache_invalid"] >= 1
    rebuilt = json.load(open(path))
    assert rebuilt["schema"] == autotune.SCHEMA_VERSION
    assert len(rebuilt["entries"]) == 1
