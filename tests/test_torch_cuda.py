"""Card-only checks of the port's CUDA kernels against their plain
versions. They skip without a CUDA card. This file imports no jax, so it
also runs on a GPU machine without the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import cvmm as K
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


def test_unfused_kernel_raises_under_grad(cuda):
    x = torch.randn((128, 128), device=cuda, requires_grad=True)
    te = torch.zeros(1, dtype=torch.int32, device=cuda)
    w = torch.randn((1, 128, 128), device=cuda)
    with pytest.raises(RuntimeError, match="no autograd history"):
        K.cvmm(x, te, w)
    with torch.no_grad():
        assert K.cvmm(x, te, w).shape == (128, 128)
