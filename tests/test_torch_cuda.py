"""Card-only checks of the port's CUDA kernels against their plain
versions. They skip without a CUDA card. This file imports no jax, so it
also runs on a GPU machine without the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.kernels import cvmm as K
from repro_torch.kernels import flash_attention as K7
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_cvmm_kernel_matches_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    te = torch.tensor([0, 0, 3, 1, 3], dtype=torch.int32, device=cuda)
    x = torch.randn((5 * 128, 384), generator=g, device=cuda).to(dtype)
    w = (torch.randn((4, 384, 256), generator=g, device=cuda) / 384 ** 0.5).to(dtype)
    before = K.LAUNCHES["cvmm"]
    got = K.cvmm(x, te, w)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cvmm"] == before + 1
    torch.testing.assert_close(got.float(), K.cvmm_plain(x, te, w).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_rows_kernel_matches_plain(cuda, dtype, weighted):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((8, 640), generator=g, device=cuda).to(dtype)
    rs = ops.make_decode_plan(8, 4, 3, device=cuda).gather.row_src
    wt = torch.rand(rs.shape, generator=g, device=cuda) if weighted else None
    got = K.gather_rows(x, rs, wt)
    torch.cuda.synchronize()
    assert torch.equal(got, K.gather_rows_plain(x, rs, wt))


def test_moe_mlp_decode_kernels_match_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    n, k, e, d, gsz = 6, 2, 4, 192, 96
    xf = torch.randn((n, d), generator=g, device=cuda).to(torch.bfloat16)
    idx = torch.stack([torch.randperm(e, generator=g, device=cuda)[:k]
                       for _ in range(n)])
    gates = torch.rand((n, k), generator=g, device=cuda)
    w1, w1g = (torch.randn((e, d, gsz), generator=g, device=cuda).bfloat16() / 14
               for _ in range(2))
    w2 = torch.randn((e, gsz, d), generator=g, device=cuda).bfloat16() / 10
    plan = ops.make_decode_plan(n, k, e, device=cuda)
    got = ops.moe_mlp_decode(xf, idx, gates, plan, w1, w2, w1g)
    cpu = [t.cpu() for t in (xf, idx, gates, w1, w2, w1g)]
    want = ops.moe_mlp_decode(*cpu[:3], ops.make_decode_plan(n, k, e, device="cpu"),
                              *cpu[3:5], cpu[5])
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=3e-2, rtol=3e-2)


def _fused_case(dev, n=300, k=4, e=5, d=412, g=128, seed=3):
    """Routing over ``e`` experts that never picks expert 1, so one expert
    has no rows and the plan ends in all-sentinel slack tiles."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    pool = torch.tensor([x for x in range(e) if x != 1])
    idx = torch.stack([pool[torch.randperm(len(pool), generator=gen)[:k]]
                       for _ in range(n)])
    gates = torch.rand((n, k), generator=gen)
    xf = torch.randn((n, d), generator=gen)
    w1, w1g = (torch.randn((e, d, g), generator=gen) / d ** 0.5 for _ in range(2))
    w2 = torch.randn((e, g, d), generator=gen) / g ** 0.5
    return [t.to(dev) for t in (idx, gates, xf, w1, w1g, w2)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("glu,save", [(False, False), (False, True),
                                      (True, False), (True, True)])
def test_fused_w1_kernel_matches_plain(cuda, dtype, tol, glu, save):
    idx, gates, xf, w1, w1g, _ = _fused_case(cuda)
    plan = ops.make_moe_plan(idx, w1.shape[0], gates)
    x = ops._pad_lane(xf, 1).to(dtype)
    args = (x, plan.row_src, plan.tile_expert, ops._pad_w(w1).to(dtype),
            ops._pad_w(w1g).to(dtype) if glu else None)
    got = K.fused_w1(*args, act="relu", save_preact=save)
    want = K.fused_w1_plain(*args, act="relu", save_preact=save)
    torch.cuda.synchronize()
    for g_, w_ in zip(got if save else (got,), want if save else (want,)):
        torch.testing.assert_close(g_.float(), w_.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_fused_w2_kernel_matches_plain(cuda, dtype, tol):
    idx, gates, _, _, _, w2 = _fused_case(cuda)
    plan = ops.make_moe_plan(idx, w2.shape[0], gates)
    g = torch.Generator(device=cuda).manual_seed(4)
    u = torch.randn((plan.m_pad, 128), generator=g, device=cuda).to(dtype)
    args = (u, plan.tile_expert, ops._pad_w(w2).to(dtype), plan.gate_tiles.reshape(-1))
    torch.testing.assert_close(K.fused_w2(*args).float(),
                               K.fused_w2_plain(*args).float(), atol=tol, rtol=tol)


# K1 and K4 on the persistent row-tile walk (csrc/row_gemm.cuh): shapes whose
# grid is below and above the SM count, items 64, 128 and 256 columns wide,
# K_pad 128 (two 64-deep slices, fewer than the ring's stages), N_pad 128 and
# 1,536, and tile_expert entries outside [0, E), whose tiles must be zeros. (expert of each tile, K_pad,
# N_pad); K1 gathers its rows from a routing with an expert that gets none.
def _tiles_of(counts):
    return [e for e, c in enumerate(counts) for _ in range(c)]


K4_LAYOUTS = {
    # serving decode at full width: 40 experts of one tile; 160 items of 128
    # columns for w1, so 64-wide ones (320 items, one per SM and more)
    "decode_e40": (list(range(40)), 1536, 512),
    "decode_e40_w2": (list(range(40)), 512, 1536),
    # a decode plan for E 4 at a few tokens: a grid of 32 blocks
    "decode_e4_small_grid": (list(range(4)), 1536, 512),
    # training's dX: K_pad 128, 273 tiles over 16 experts, 1,092 items
    "training_dx_kpad128": (_tiles_of([17, 18, 16, 17, 19, 15, 17, 18, 16, 17, 18, 17, 16,
                                       17, 18, 13]), 128, 512),
    "n_pad_128": (_tiles_of([30, 0, 41, 60, 9]), 512, 128),
    # expert 1 without tiles, a tile of expert E and one of -1: zeros
    "experts_out_of_range": ([0, 0, 5, 2, 2, 3, -1, 4, 4], 256, 384),
}


def _bf16_norm_close(got, want) -> bool:
    """chip_smoke.close's bf16 gate without the ulp bound: allclose at 3e-2
    and ||got - want|| <= 1e-2 ||want||."""
    g, w = got.float(), want.float()
    rel = (torch.linalg.norm(g - w) / torch.linalg.norm(w).clamp_min(1e-30)).item()
    return torch.allclose(g, w, atol=3e-2, rtol=3e-2) and rel <= 1e-2


def _row_gemm_check(got, want, again, dtype, zero_rows):
    """Against the plain version (want; rows of out-of-range tiles zero),
    and the same bits on a second call."""
    for g_, w_, a_ in zip(got, want, again):
        assert torch.equal(g_.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           a_.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
        assert bool((g_[zero_rows] == 0).all())
        if dtype == torch.bfloat16:
            assert _bf16_norm_close(g_, w_)
        else:
            torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4)


def _out_of_range(te, n_experts):
    """Rows of tiles whose expert lies outside [0, E), and tile_expert with
    those entries set to 0 for the plain version, which cannot index them."""
    bad = (te < 0) | (te >= n_experts)
    return bad.repeat_interleave(128), torch.where(bad, torch.zeros_like(te), te)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", K4_LAYOUTS)
def test_cvmm_row_walk_matches_plain(cuda, layout, dtype):
    tiles, k_pad, n_pad = K4_LAYOUTS[layout]
    te = torch.tensor(tiles, dtype=torch.int32, device=cuda)
    e = 40 if layout.startswith("decode_e40") else max(tiles) + (layout != "experts_out_of_range")
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((len(tiles) * 128, k_pad), generator=g, device=cuda).to(dtype)
    w = (torch.randn((e, k_pad, n_pad), generator=g, device=cuda) * k_pad ** -0.5).to(dtype)
    zero_rows, te_plain = _out_of_range(te, e)
    assert bool(zero_rows.any()) == (layout == "experts_out_of_range")
    before = K.LAUNCHES["cvmm"]
    got, again = K.cvmm(x, te, w), K.cvmm(x, te, w)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cvmm"] == before + 2
    want = K.cvmm_plain(x, te_plain, w)
    want[zero_rows] = 0
    _row_gemm_check((got,), (want,), (again,), dtype, zero_rows)


def test_row_gemm_schedule_covers_both_sides_of_the_sm_count(cuda):
    sms = K._sm_count(cuda)
    grids = {name: K.row_gemm_schedule(len(t) * 128, k, n, sms)[2]
             for name, (t, k, n) in K4_LAYOUTS.items()}
    assert grids["decode_e4_small_grid"] < sms <= grids["training_dx_kpad128"]


def _k1_inputs(dev, dtype, n, k, e, d, g, seed=13):
    """K1's operands on a plan over ``e`` experts that never picks expert
    1, with the first tile's expert set to E (out of range)."""
    idx, gates, xf, w1, w1g, _ = _fused_case(dev, n=n, k=k, e=e, d=d, g=g, seed=seed)
    plan = ops.make_moe_plan(idx, e, gates)
    te = plan.tile_expert.clone()
    te[0] = e
    return (ops._pad_lane(xf, 1).to(dtype), plan.row_src, te, ops._pad_w(w1).to(dtype),
            ops._pad_w(w1g).to(dtype))


K1_SHAPES = {
    # (tokens, top-k, experts, d_model, expert size): the training shape's
    # widths on a small routing (grid < SMs), at 8,192 tokens (grid = SMs,
    # several items a block; 128 columns wide), t0's widths there (N_pad
    # 512: 256 columns wide without save_preact), and expert sizes 1,536
    # and 384 (N_pad 1,536 and 384) from K_pad 128
    "small": (300, 4, 5, 412, 128),
    "training_widths_8k_tokens": (8192, 4, 16, 412, 128),
    "t0_widths_8k_tokens": (8192, 4, 16, 412, 412),
    "n_pad_1536": (600, 2, 6, 100, 1536),
    "k_pad_128_n_pad_384": (900, 3, 7, 128, 300),
}


def _k1_check(cuda, dtype, shape, act, glu, save):
    x, rs, te, w1, w1g = _k1_inputs(cuda, dtype, *K1_SHAPES[shape])
    args = (x, rs, te, w1, w1g if glu else None)
    zero_rows, te_plain = _out_of_range(te, w1.shape[0])
    assert bool((rs.view(-1, 128) >= x.shape[0]).all(1).any())   # all-sentinel tiles
    got = K.fused_w1(*args, act=act, save_preact=save)
    again = K.fused_w1(*args, act=act, save_preact=save)
    want = K.fused_w1_plain(x, rs, te_plain, *args[3:], act=act, save_preact=save)
    torch.cuda.synchronize()
    as_tuple = (lambda t: t if save else (t,))
    want = as_tuple(want)
    for w_ in want:
        w_[zero_rows] = 0
    _row_gemm_check(as_tuple(got), want, as_tuple(again), dtype, zero_rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["identity", "relu", "gelu", "silu"])
@pytest.mark.parametrize("glu,save", [(False, False), (False, True),
                                      (True, False), (True, True)])
def test_fused_w1_row_walk_variants_match_plain(cuda, dtype, act, glu, save):
    _k1_check(cuda, dtype, "small", act, glu, save)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("glu,save", [(False, False), (False, True), (True, True)])
@pytest.mark.parametrize("shape", [s for s in K1_SHAPES if s != "small"])
def test_fused_w1_row_walk_shapes_match_plain(cuda, dtype, shape, glu, save):
    _k1_check(cuda, dtype, shape, "silu" if glu else "relu", glu, save)


@pytest.mark.parametrize("fault", ["slice dropped", "slice read twice"])
def test_cvmm_bf16_check_rejects_a_ring_fault(cuda, fault):
    """The bf16 check (allclose 3e-2 and 1e-2 normwise) sees a K4 that
    drops one 64-deep ring stage or adds it twice: the kernel's result on
    x with that slice of K zeroed or doubled is exactly such a K4's."""
    tiles, k_pad, n_pad = K4_LAYOUTS["decode_e40"]
    te = torch.tensor(tiles, dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn((len(tiles) * 128, k_pad), generator=g, device=cuda).bfloat16()
    w = (torch.randn((40, k_pad, n_pad), generator=g, device=cuda) * k_pad ** -0.5).bfloat16()
    bad = x.clone()
    bad[:, 768:832] *= 0 if fault == "slice dropped" else 2      # the middle stage
    assert _bf16_norm_close(K.cvmm(x, te, w), K.cvmm_plain(x, te, w))
    assert not _bf16_norm_close(K.cvmm(bad, te, w), K.cvmm_plain(x, te, w))


# K2 on the persistent row-tile walk with the gate as a compile-time flag:
# K1's shapes at K2's widths (expert size -> d_model), the first tile's
# expert out of range (zeros), slack rows (gate 0) zero.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_fused_w2_row_walk_matches_plain(cuda, dtype, shape):
    n, k, e, d, g = K1_SHAPES[shape]
    idx, gates, _, _, _, w2 = _fused_case(cuda, n=n, k=k, e=e, d=d, g=g, seed=16)
    plan = ops.make_moe_plan(idx, e, gates)
    te = plan.tile_expert.clone()
    te[0] = e
    w2p = ops._pad_w(w2).to(dtype)
    gen = torch.Generator(device=cuda).manual_seed(16)
    u = torch.randn((plan.m_pad, w2p.shape[1]), generator=gen, device=cuda).to(dtype)
    gate = plan.gate_tiles.reshape(-1)
    zero_rows, te_plain = _out_of_range(te, e)
    before = K.LAUNCHES["fused_w2"]
    got, again = K.fused_w2(u, te, w2p, gate), K.fused_w2(u, te, w2p, gate)
    want = K.fused_w2_plain(u, te_plain, w2p, gate)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_w2"] == before + 2
    want[zero_rows] = 0
    _row_gemm_check((got,), (want,), (again,), dtype, zero_rows | (plan.row_src >= n))


def test_fused_w2_bf16_check_rejects_exchanged_gate_rows(cuda):
    """The bf16 check (allclose 3e-2 and 1e-2 normwise) sees a K2 whose
    epilogue applies row r + 8's gate to row r and r's to r + 8 in every
    16-row group: the kernel on gates exchanged so is exactly such a K2."""
    idx, gates, _, _, _, w2 = _fused_case(cuda)
    plan = ops.make_moe_plan(idx, w2.shape[0], gates)
    g = torch.Generator(device=cuda).manual_seed(17)
    u = torch.randn((plan.m_pad, 128), generator=g, device=cuda).bfloat16()
    w2p, te = ops._pad_w(w2).bfloat16(), plan.tile_expert
    gate = plan.gate_tiles.reshape(-1)
    exchanged = gate.reshape(-1, 2, 8).flip(1).reshape(-1)
    want = K.fused_w2_plain(u, te, w2p, gate)
    assert _bf16_norm_close(K.fused_w2(u, te, w2p, gate), want)
    assert not _bf16_norm_close(K.fused_w2(u, te, w2p, exchanged), want)


# K6 split over the card (csrc/gather_rows.cu): (rows of x, K_pad, slots) of
# an unsorted row_src that mixes both kinds of sentinel (-1 and N + 5) over
# several row groups, granite-moe's decode gather (8 tokens) and serve-long's
# prefill chunk (256), and one 16-byte vector a row (K_pad 8 in bf16), where
# one lane of a warp covers the row.
K6_CASES = {
    "unsorted_sentinels": (200, 640, 512),
    "decode_n8_d1536": (8, 1536, 128),
    "prefill_chunk_n256_d1536": (256, 1536, 256),
    "one_vector_a_row": (50, 8, 384),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", K6_CASES)
def test_gather_rows_split_matches_plain(cuda, case, weighted, dtype):
    n, k_pad, m_pad = K6_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn((n, k_pad), generator=g, device=cuda).to(dtype)
    if case.startswith(("decode", "prefill")):
        rs = ops.make_decode_plan(n, 8, 40, device=cuda).gather.row_src
    else:
        rs = torch.randint(0, n, (m_pad,), generator=g, device=cuda, dtype=torch.int32)
        rs[1::5], rs[3::7] = -1, n + 5
    assert rs.shape == (m_pad,)
    wt = torch.rand((m_pad,), generator=g, device=cuda) if weighted else None
    before = K.LAUNCHES["gather_rows"]
    got = K.gather_rows(x, rs, wt)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gather_rows"] == before + 1
    assert torch.equal(got, K.gather_rows_plain(x, rs, wt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["stream_x", "stream_g", "stream_g_gate"])
def test_dw_streamed_kernel_matches_plain(cuda, dtype, variant):
    idx, gates, xf, _, _, _ = _fused_case(cuda)
    e = 5
    plan = ops.make_moe_plan(idx, e, gates)
    g = torch.Generator(device=cuda).manual_seed(5)
    # the aligned operand carries (rows per expert)^-0.5, so the float32
    # sums stay O(1) and the tolerance bounds summation-order differences
    rows = idx.numel() / (e - 1)
    aligned = (torch.randn((plan.m_pad, 128), generator=g, device=cuda)
               * rows ** -0.5).to(dtype)
    unsorted = ops._pad_lane(xf, 1).to(dtype)
    stream_x = variant == "stream_x"
    x, gr = (unsorted, aligned) if stream_x else (aligned, unsorted)
    gate = plan.gate_tiles.reshape(-1) if variant == "stream_g_gate" else None
    args = (x, gr, plan.row_src, plan.tile_expert, e)
    got = K.dw_streamed(*args, stream_x=stream_x, gate=gate)
    want = K.dw_streamed_plain(*args, stream_x=stream_x, gate=gate)
    assert bool((got[1] == 0).all())                   # the expert with no rows
    # float32 sums of identical operands in either input type
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# K3 and K5 on plans with set rows per expert: (rows per expert, K_pad, N_pad).
DW_LAYOUTS = {
    # one expert with 3x the mean rows (12 tiles: several chunks), one empty
    "skewed": ([1500, 375, 375, 375, 375, 0], 512, 128),
    # experts of exactly one tile (128 rows, 5 rows) and of 5, 11 and 2
    # tiles, counts that are not multiples of the chunk
    "one_tile_and_ragged": ([128, 5, 640, 1300, 130], 128, 512),
    # the first, a middle and the last expert without rows
    "empty_experts": ([0, 200, 333, 0, 700, 50, 0], 128, 128),
    # granite-moe's 40 experts at K_pad = N_pad = 512, expert 0 empty
    "granite_e40": ([37 * e % 290 for e in range(40)], 512, 512),
}
DW_VARIANTS = ["stream_x", "stream_g", "stream_g_gate", "cvmm_dw"]


def _dw_case(dev, layout, variant, dtype, seed=11):
    """(kernel, plain, args, kwargs, rows per expert) of one K3 variant or K5
    on a top-1 plan with DW_LAYOUTS[layout]'s rows per expert, tokens in
    random order. The aligned operand carries (largest expert's rows)^-0.5,
    so the float32 sums stay O(1) and 1e-4 bounds summation-order
    differences."""
    rows, k_pad, n_pad = DW_LAYOUTS[layout]
    gen = torch.Generator().manual_seed(seed)
    e_of = torch.repeat_interleave(torch.arange(len(rows)), torch.tensor(rows))
    idx = e_of[torch.randperm(len(e_of), generator=gen)][:, None].to(dev)
    plan = ops.make_moe_plan(idx, len(rows), torch.rand(idx.shape, generator=gen).to(dev))
    n, m_pad, e = idx.shape[0], plan.m_pad, len(rows)
    g = torch.Generator(device=dev).manual_seed(seed)
    valid = (plan.row_src < n)[:, None]
    scale = max(rows) ** -0.5
    if variant == "cvmm_dw":
        x = torch.randn((m_pad, k_pad), generator=g, device=dev) * valid
        gp = torch.randn((m_pad, n_pad), generator=g, device=dev) * valid * scale
        return (K.cvmm_dw, K.cvmm_dw_plain,
                (x.to(dtype), plan.tile_expert, gp.to(dtype), e), {}, rows)
    stream_x = variant == "stream_x"
    unsorted = torch.randn((n, k_pad if stream_x else n_pad), generator=g, device=dev)
    aligned = torch.randn((m_pad, n_pad if stream_x else k_pad), generator=g,
                          device=dev) * scale
    x, gr = (unsorted, aligned) if stream_x else (aligned, unsorted)
    gate = plan.gate_tiles.reshape(-1) if variant == "stream_g_gate" else None
    return (K.dw_streamed, K.dw_streamed_plain,
            (x.to(dtype), gr.to(dtype), plan.row_src, plan.tile_expert, e),
            dict(stream_x=stream_x, gate=gate), rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", DW_VARIANTS)
@pytest.mark.parametrize("layout", DW_LAYOUTS)
def test_dw_split_matches_plain(cuda, layout, variant, dtype):
    kernel, plain, args, kw, rows = _dw_case(cuda, layout, variant, dtype)
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    for e, r in enumerate(rows):
        if r == 0:
            assert bool((got[e] == 0).all())          # exactly zero
    # float32 sums of identical operands in either input type
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", DW_VARIANTS)
def test_dw_kernels_give_the_same_bits_every_call(cuda, variant, dtype):
    kernel, _, args, kw, rows = _dw_case(cuda, "skewed", variant, dtype)
    assert -(-max(rows) // 128) > 2 * K.DW_CHUNK          # several chunks
    first, again = kernel(*args, **kw), kernel(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("glu", [False, True])
def test_moe_mlp_fused_gradients_match_plain(cuda, glu):
    """float32 on the card (kernels) against float32 on the CPU (plain)."""
    outs = []
    for dev in (cuda, torch.device("cpu")):
        idx, gates, xf, w1, w1g, w2 = _fused_case(dev)
        ins = [t.requires_grad_() for t in (xf, gates, w1, w1g, w2)]
        plan = ops.make_moe_plan(idx, w1.shape[0], ins[1])
        y = ops.moe_mlp_fused(ins[0], plan, ins[2], ins[4], ins[3] if glu else None)
        (y * torch.linspace(-1, 1, y.shape[1], device=dev)).sum().backward()
        outs.append([y.detach().cpu()] + [t.grad.cpu() for t in ins
                                          if t.grad is not None])
    assert len(outs[0]) == len(outs[1]) == 5 + glu
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cvmm_dw_kernel_matches_plain(cuda, dtype):
    idx, gates, _, _, _, _ = _fused_case(cuda)
    e = 5
    plan = ops.make_moe_plan(idx, e, gates)
    g = torch.Generator(device=cuda).manual_seed(6)
    rows = idx.numel() / (e - 1)
    valid = (plan.row_src < idx.shape[0])[:, None]        # slack rows stay zero
    x_pad = torch.randn((plan.m_pad, 512), generator=g, device=cuda) * valid
    g_pad = torch.randn((plan.m_pad, 128), generator=g, device=cuda) * valid * rows ** -0.5
    args = (x_pad.to(dtype), plan.tile_expert, g_pad.to(dtype), e)
    before = K.LAUNCHES["cvmm_dw"]
    got = K.cvmm_dw(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cvmm_dw"] == before + 1
    assert bool((got[1] == 0).all())                     # the expert with no rows
    # float32 sums of identical operands in either input type
    torch.testing.assert_close(got, K.cvmm_dw_plain(*args), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("entry", ["cvmm_planned", "cvmm"])
def test_unfused_gradients_match_plain(cuda, entry):
    """float32 on the card (K4, K5) against float32 on the CPU (plain)."""
    outs = []
    for dev in (cuda, torch.device("cpu")):
        idx, gates, xf, w1, _, _ = _fused_case(dev)
        plan = ops.make_moe_plan(idx, w1.shape[0])
        x = xf[torch.arange(xf.shape[0], device=dev).repeat_interleave(
            idx.shape[1])[plan.perm]].requires_grad_()
        w = w1.requires_grad_()
        y = (ops.cvmm_planned(x, plan, w) if entry == "cvmm_planned" else
             ops.cvmm(x, plan.group_sizes, w, impl="pallas"))
        (y * torch.linspace(-1, 1, y.shape[1], device=dev)).sum().backward()
        outs.append([t.detach().cpu() for t in (y, x.grad, w.grad)])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert bool((outs[0][2][1] == 0).all())              # the expert with no rows


def _value_sum(dev, rung, dtype, n=300, s=12, rows=2053, d=412):
    """The weighted value sum of ``rung`` on ``dev`` (K6 on the card, its
    plain version on the CPU) over a table of W2's 47M shape, every token
    sharing row 5: (y, dvalues, dweights) in float32 on the CPU."""
    gen = torch.Generator().manual_seed(7)
    idx = torch.randint(0, rows, (n, s), generator=gen)
    idx[:, 0] = 5
    w = torch.rand((n, s), generator=gen).to(dev).requires_grad_()
    v = (torch.randn((rows, d), generator=gen) / 20).to(dev, dtype).requires_grad_()
    cot = torch.randn((n, d), generator=gen).to(dev)
    if rung == "dedup":
        y = ops.gathered_weighted_sum_dedup(
            v, ops.make_dedup_gather_plan(idx.to(dev), w, rows), n)
    else:
        y = ops.gathered_weighted_sum(v, ops.make_gather_plan(idx.to(dev), w, rows), n,
                                      fuse_weights=rung == "fused")
    (y.float() * cot).sum().backward()
    return [t.detach().float().cpu() for t in (y, v.grad, w.grad)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("rung", ["dedup", "fused", "unfused"])
def test_weighted_value_sum_kernels_match_plain(cuda, rung, dtype, tol):
    """One K6 launch forward and one backward, against the plain versions
    on the CPU."""
    before = K.LAUNCHES["gather_rows"]
    got = _value_sum(cuda, rung, dtype)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gather_rows"] == before + 2
    for g_, w_ in zip(got, _value_sum(torch.device("cpu"), rung, dtype)):
        torch.testing.assert_close(g_, w_, atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["pkm", "topk"])
def test_swapped_ffn_runs_k6_forward_and_backward(cuda, kind):
    """A PKM or top-K layer of wt103-47m-dense's width on the kernel rung:
    two K6 launches, none of K1-K5, and float32 output and gradients
    within 1e-4 of the plain versions on the CPU."""
    from repro_torch.models import build_model, ffn
    cfg = build_model("wt103-47m-dense", ffn=kind).cfg.ffn
    init = ffn.init_ffn(torch.Generator().manual_seed(8), 412, cfg, 16, device="cpu")
    outs = []
    for dev in (cuda, torch.device("cpu")):
        params = {k: v.to(dev).requires_grad_() for k, v in init.items()}
        x = torch.randn((64, 412), generator=torch.Generator().manual_seed(9)).to(dev)
        x.requires_grad_()
        K.reset_launch_counts()
        ops.set_default_impl("pallas_fused")
        try:
            y, _ = ffn.apply_ffn(params, x, cfg)
            (y * torch.linspace(-1, 1, 412, device=dev)).sum().backward()
        finally:
            ops.set_default_impl(None)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | {"gather_rows": 2}
        outs.append([t.detach().cpu() for t in [y, x.grad] + [params[k].grad
                                                               for k in sorted(params)]])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["pkm", "topk"])
def test_swapped_ffn_plain_rungs_raise_on_the_card(cuda, kind):
    """A float16 table, or a pin to the "einsum" or "dense" rung, raises on
    the card instead of gathering the value rows without K6."""
    from repro_torch.models import build_model, ffn
    cfg = build_model("wt103-47m-dense", ffn=kind).cfg.ffn
    params = {k: v.to(cuda) for k, v in ffn.init_ffn(
        torch.Generator().manual_seed(8), 412, cfg, 16, device="cpu").items()}
    x = torch.randn((64, 412), device=cuda)
    cases = [(cfg, x.half())] + [(dataclasses.replace(cfg, impl=impl), x)
                                 for impl in ("einsum", "dense")]
    K.reset_launch_counts()
    for c, xc in cases:
        with pytest.raises(NotImplementedError, match="plain CPU rung"):
            ffn.apply_ffn(params, xc, c)
    assert K.LAUNCHES["gather_rows"] == 0


def test_unfused_kernel_raises_under_grad(cuda):
    x = torch.randn((128, 128), device=cuda, requires_grad=True)
    te = torch.zeros(1, dtype=torch.int32, device=cuda)
    w = torch.randn((1, 128, 128), device=cuda)
    with pytest.raises(RuntimeError, match="no autograd history"):
        K.cvmm(x, te, w)
    with torch.no_grad():
        assert K.cvmm(x, te, w).shape == (128, 128)


# K7 cases: (B, Sq, Sk, H, KV, D, causal, q_offset, kv_len); the oracle's
# five (tests/test_kernels_flash.py), granite-moe's heads at a 256-row
# prefill chunk against a 1,552-key pool and at a 3,500-token prompt's last
# two chunks against a 4,096-key pool, two batch rows with different
# kv_len, a lane with kv_len 0, and the reduced config's D 16. Then the
# cases the split-KV schedule exposes (kernels.flash_attention.
# flash_schedule at 132 SMs): a kv_len 0 lane on items of 8 splits, a
# batch row whose later splits are all empty (kv_len 300 of 2,048 keys),
# one query head per KV head (grp 1) and four (grp 4) at D 64, and Sq 100
# at grp 3 (a row tile ending inside a position's heads).
FLASH_CASES = [
    (2, 128, 128, 4, 2, 128, True, 0, None),
    (1, 256, 256, 2, 2, 128, True, 0, None),
    (1, 100, 100, 4, 4, 128, True, 0, None),
    (2, 128, 128, 4, 2, 128, False, 0, None),
    (1, 384, 384, 8, 2, 128, True, 0, None),
    (1, 256, 1552, 24, 8, 64, True, 0, (256,)),
    (1, 256, 1552, 24, 8, 64, True, 256, (512,)),
    (1, 256, 1552, 24, 8, 64, True, 1280, (1536,)),
    (1, 256, 4096, 24, 8, 64, True, 3072, (3328,)),
    (1, 256, 4096, 24, 8, 64, True, 3328, (3500,)),
    (2, 50, 261, 24, 8, 64, True, 77, (37, 200)),
    (2, 130, 261, 4, 2, 16, False, 128, (0, 200)),
    (1, 9, 40, 4, 2, 16, True, 31, None),
    (2, 128, 4096, 8, 2, 64, True, 3072, (0, 3200)),
    (2, 128, 2048, 4, 1, 64, True, 1920, (2048, 300)),
    (1, 256, 1024, 8, 8, 64, True, 768, None),
    (1, 100, 1024, 24, 8, 64, True, 900, (1000,)),
]
# serve-long's last full prefill chunk: 48 items of 2 splits at 132 SMs.
SPLIT_CASE = (1, 256, 4096, 24, 8, 64, True, 3072, (3328,))


def _bf16_close(got, want) -> bool:
    """Within 4 bf16 ulps of max|want| elementwise and 1e-2 normwise: both
    round the same float32 result to bf16 once (chip_smoke.py's gate)."""
    g, w = got.float(), want.float()
    top = w.abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    rel = (torch.linalg.norm(g - w) / torch.linalg.norm(w).clamp_min(1e-30)).item()
    return (g - w).abs().max().item() <= 4 * ulp and rel <= 1e-2


def _flash_inputs(cuda, dtype, case):
    b, sq, sk, h, kvh, d, causal, q_offset, kv_len = case
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    kl = None if kv_len is None else torch.tensor(kv_len, device=cuda)
    return q, k, v, dict(causal=causal, scale=d ** -0.5, q_offset=q_offset, kv_len=kl)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, tol, case):
    kv_len = case[-1]
    q, k, v, kw = _flash_inputs(cuda, dtype, case)
    before = K.LAUNCHES["flash_attention"]
    got = K7.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    again = K7.flash_attention(q, k, v, **kw)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    want = K7.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        assert _bf16_close(got, want)
    if kv_len is not None and 0 in kv_len:
        assert bool((got[kv_len.index(0)] == 0).all())


# K7 at zamba2-7b's head size 112 (32 query heads on 32 KV heads): a
# 600-row causal prefill, a 256-row chunk at q_offset 512 over a longer
# cache with kv_len, a long chunk whose keys split over the card, and two
# KV heads of a group of 2 (packed rows of two heads) across a kv_len of 0.
D112_CASES = [
    (1, 600, 600, 32, 32, 112, True, 0, None),
    (2, 256, 1024, 32, 32, 112, True, 512, (768, 700)),
    (1, 128, 4096, 32, 32, 112, True, 3968, (4096,)),
    (2, 77, 300, 4, 2, 112, False, 0, (0, 300)),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", D112_CASES)
def test_flash_attention_kernel_head_size_112(cuda, dtype, tol, case):
    """D 112 pads each row to two 64-column atoms in shared memory; the
    pad is zero and the output's chunks stay inside their row."""
    q, k, v, kw = _flash_inputs(cuda, dtype, case)
    got = K7.flash_attention(q, k, v, **kw)
    again = K7.flash_attention(q, k, v, **kw)
    want = K7.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(ints), again.view(ints))
    if dtype == torch.bfloat16:
        assert _bf16_close(got, want)


def _split_boundary(case) -> int:
    """The first key of the second split of SPLIT_CASE's last item."""
    b, sq, sk, h, kvh, d, causal, q_offset, _ = case
    bk = K7.FLASH_BK[d]
    _, items, splits, _ = K7.flash_schedule(b, sq, h, kvh, sk, q_offset, causal, 132, bk)
    n_rt = -(-sq * (h // kvh) // K7.ROW_TILE)
    n = K7.flash_item_tiles(n_rt - 1, sq, sk, h // kvh, causal, q_offset, bk)
    ranges = K7.flash_split_ranges(n, splits)
    assert len(ranges) > 1
    return ranges[1][0] * bk


def _tile_fault(k, v, kw, start, twice):
    """K/V and arguments that emulate a merge that drops the 64 keys at
    ``start`` or counts them twice: the keys removed (or repeated in place),
    with kv_len and q_offset moved by 64 so the causal mask is unchanged."""
    if twice:
        k, v = (torch.cat([t[:, :start + 64], t[:, start:]], 1)[:, :t.shape[1]] for t in (k, v))
        shift = 64
    else:
        k, v = (torch.cat([t[:, :start], t[:, start + 64:], t[:, :64]], 1) for t in (k, v))
        shift = -64
    return k.contiguous(), v.contiguous(), dict(kw, q_offset=kw["q_offset"] + shift,
                                                 kv_len=kw["kv_len"] + shift)


@pytest.mark.parametrize("fault", ["scale", "kv_len", "drop_tile", "twice_tile"])
def test_flash_attention_bf16_check_rejects_a_faulty_kernel(cuda, fault):
    """The bf16 check is tight enough to see a softmax scale 10 % off, three
    keys read past kv_len, or a split merge that drops the 64-key tile at a
    split boundary or counts it twice (both emulated through the inputs)."""
    if fault in ("scale", "kv_len"):
        q, k, v, kw = _flash_inputs(cuda, torch.bfloat16,
                                    (2, 256, 1552, 24, 8, 64, True, 512, (300, 768)))
        bad = (dict(kw, scale=kw["scale"] * 1.1) if fault == "scale"
               else dict(kw, kv_len=kw["kv_len"] + 3))
        got = K7.flash_attention(q, k, v, **bad)
    else:
        q, k, v, kw = _flash_inputs(cuda, torch.bfloat16, SPLIT_CASE)
        kb, vb, bad = _tile_fault(k, v, kw, _split_boundary(SPLIT_CASE), fault == "twice_tile")
        got = K7.flash_attention(q, kb, vb, **bad)
    assert not _bf16_close(got, K7.flash_attention_plain(q, k, v, **kw))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("scale", [-0.2, 0.0])
def test_flash_attention_kernel_takes_any_scale(cuda, dtype, tol, scale):
    """A negative softmax scale (the bf16 kernel negates Q for it) and a
    zero one (a uniform average over the visible keys)."""
    q, k, v, kw = _flash_inputs(cuda, dtype, (2, 50, 261, 24, 8, 64, True, 77, (37, 200)))
    kw = dict(kw, scale=scale)
    got, want = K7.flash_attention(q, k, v, **kw), K7.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        assert _bf16_close(got, want)


def test_flash_attention_kernel_raises_under_grad(cuda):
    q = torch.randn((1, 8, 4, 64), device=cuda, requires_grad=True)
    k = torch.randn((1, 8, 2, 64), device=cuda)
    with pytest.raises(RuntimeError, match="forward only"):
        K7.flash_attention(q, k, k, causal=True, scale=0.125)
    with torch.no_grad():
        assert K7.flash_attention(q, k, k, causal=True, scale=0.125).shape == q.shape
    with pytest.raises(ValueError, match="head size"):
        K7.flash_attention(q[..., :48].contiguous().detach(), k[..., :48].contiguous(),
                           k[..., :48].contiguous(), causal=True, scale=0.125)


def _baseline_layer(kind, dev, dispatch="sort"):
    """One wt103-47m-moe FFN layer made the ``kind`` baseline
    (chip_smoke.BASELINES), its parameters and 300 tokens, float32."""
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.core import moe
    f = get_config("wt103-47m-moe").ffn
    cfg = dataclasses.replace(f, **chip_smoke.BASELINES.get(kind, {}), dispatch=dispatch)
    params = moe.init_moe(torch.Generator().manual_seed(4), 412, cfg, 16, device="cpu")
    x = torch.randn((300, 412), generator=torch.Generator().manual_seed(5))
    return cfg, {k: v.to(dev).requires_grad_() for k, v in params.items()}, \
        x.to(dev).requires_grad_()


def _layer_outputs(cfg, params, x, seed=6):
    from repro_torch.core import moe
    y, aux = moe.apply_moe(params, x, cfg, train=True,
                           gen=torch.Generator(device=x.device).manual_seed(seed))
    ((y * torch.linspace(-1, 1, y.shape[1], device=x.device)).sum()
     + aux["moe_reg"]).backward()
    return [y.detach(), x.grad] + [params[k].grad for k in sorted(params)]


@pytest.mark.parametrize("kind", ["sbase", "noisy_topk"])
def test_baseline_layers_run_the_kernels_and_match_plain(cuda, kind):
    """S-BASE and noisy top-k layers on the card: forward K1 and K2,
    backward K1, two K3 and K4, and float32 output and gradients within
    1e-4 of the same layer on the kernels' plain versions (same generator,
    so the same gating noise)."""
    import chip_smoke
    K.reset_launch_counts()
    got = _layer_outputs(*_baseline_layer(kind, cuda))
    torch.cuda.synchronize()
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0) | {
        "fused_w1": 2, "fused_w2": 1, "dw_streamed": 2, "cvmm": 1}
    with chip_smoke.plain_kernels(K):
        want = _layer_outputs(*_baseline_layer(kind, cuda))
    assert len(got) == len(want) == 5 + (kind == "noisy_topk")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_capacity_dispatch_matches_the_sort_kernels(cuda, dtype, tol):
    """The capacity dispatch at a capacity that drops nothing against the
    sort path's kernels, on the card, same routing: output (and in float32
    the gradients); it launches no kernel."""
    cfg, params, x = _baseline_layer("sigma_moe", cuda)
    x = x.detach().to(dtype).requires_grad_()
    outs = []
    for dispatch, factor in (("sort", 1.25), ("einsum", 16.0)):
        c = dataclasses.replace(cfg, dispatch=dispatch, capacity_factor=factor)
        for p in params.values():
            p.grad = None
        x.grad = None
        K.reset_launch_counts()
        outs.append(_layer_outputs(c, params, x))
        torch.cuda.synchronize()
        if dispatch == "einsum":
            assert not any(K.LAUNCHES.values())
    for g, w in zip(*outs) if dtype == torch.float32 else [(outs[1][0], outs[0][0])]:
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
