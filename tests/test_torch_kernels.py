"""The port's K4 (grouped GEMM) and K6 (row gather) plain versions against
the reference's Pallas kernels in interpret mode, on the same numpy inputs,
and the wrappers' CPU routing and argument checks.

Tolerances: float32 1e-5 and bf16 3e-2, the reference's own
(tests/test_kernels_cvmm.py). The gather is a copy (and an f32 multiply),
so it must agree exactly."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.cvmm import cvmm_gather_rows_pallas, cvmm_pallas
from repro_torch.kernels import cvmm as K

# The reference's gather kernel raises this deprecation on current jax; it
# is not the port's and not what these tests check.
pytestmark = pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}

# (tile_expert, K_pad, N_pad, E): non-decreasing, shuffled, experts unused
LAYOUTS = {
    "sorted": ([0, 0, 1, 2], 128, 256, 3),
    "shuffled_empty": ([3, 0, 3, 1], 256, 128, 5),
    "single_tile": ([2], 128, 128, 4),
}


def _to(a: np.ndarray, jdt, tdt):
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_cvmm_plain_matches_pallas(layout, dtype):
    te, k, n, e = LAYOUTS[layout]
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(len(te) * 31 + k)
    x = rng.standard_normal((len(te) * 128, k)).astype(np.float32)
    w = (rng.standard_normal((e, k, n)) * k ** -0.5).astype(np.float32)
    te = np.asarray(te, np.int32)
    jx, tx = _to(x, jdt, tdt)
    jw, tw = _to(w, jdt, tdt)
    want = cvmm_pallas(jx, jnp.asarray(te), jw, interpret=True)
    got = K.cvmm(tx, torch.from_numpy(te), tw)
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_rows_plain_matches_pallas(weighted, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(7)
    n_rows, k_pad = 40, 256
    idx = rng.integers(0, n_rows, size=(12, 3))          # duplicates -> dedup
    plan = jops.make_dedup_gather_plan(jnp.asarray(idx),
                                       jnp.ones((12, 3), jnp.float32), n_rows)
    row_src = np.array(plan.row_src)
    assert (row_src >= n_rows).any()                     # sentinel slack
    x = rng.standard_normal((n_rows, k_pad)).astype(np.float32)
    jx, tx = _to(x, jdt, tdt)
    wt = rng.random(row_src.shape[0]).astype(np.float32) if weighted else None
    want = cvmm_gather_rows_pallas(
        jx, plan.row_src, plan.run_start, plan.run_off,
        None if wt is None else jnp.asarray(wt.reshape(-1, 128)),
        interpret=True)
    got = K.gather_rows(tx, torch.from_numpy(row_src),
                        None if wt is None else torch.from_numpy(wt))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    K.reset_launch_counts()
    x = torch.randn(256, 128)
    te = torch.tensor([1, 0], dtype=torch.int32)
    w = torch.randn(2, 128, 128)
    torch.testing.assert_close(K.cvmm(x, te, w), K.cvmm_plain(x, te, w))
    rs = torch.tensor([3, 256] + [5] * 126, dtype=torch.int32)
    torch.testing.assert_close(K.gather_rows(x, rs), K.gather_rows_plain(x, rs))
    assert K.gather_rows(x, rs)[1].abs().sum() == 0       # sentinel row
    torch.testing.assert_close(K.cvmm_dw(x, te, x, 3), K.cvmm_dw_plain(x, te, x, 3))
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)


@pytest.mark.parametrize("call", [
    lambda: K.cvmm(torch.randn(100, 128), torch.zeros(1, dtype=torch.int32),
                   torch.randn(1, 128, 128)),                   # M not tiled
    lambda: K.cvmm(torch.randn(128, 128), torch.zeros(1, dtype=torch.int32),
                   torch.randn(1, 128, 128).double()),          # dtypes differ
    lambda: K.gather_rows(torch.randn(4, 128), torch.zeros(100, dtype=torch.int32)),
    lambda: K.gather_rows(torch.randn(4, 128).half(),
                          torch.zeros(128, dtype=torch.int32)),
    lambda: K.cvmm_dw(torch.randn(128, 128), torch.zeros(1, dtype=torch.int32),
                      torch.randn(256, 128), 1),                # rows differ
    lambda: K.cvmm_dw(torch.randn(128, 128), torch.zeros(1, dtype=torch.int32),
                      torch.randn(128, 128).bfloat16(), 1),     # dtypes differ
], ids=["cvmm_rows", "cvmm_dtype", "gather_rows", "gather_dtype", "cvmm_dw_rows",
        "cvmm_dw_dtype"])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()
