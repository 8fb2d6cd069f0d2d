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
