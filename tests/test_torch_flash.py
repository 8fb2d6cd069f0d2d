"""K7 on the CPU: the port's ``flash_attention_plain`` (the chunked core,
K7's plain version) against the reference's Pallas kernel (interpret mode)
and its pure-JAX ``models.attention.flash_attention`` with ``q_offset`` and
``kv_len``; the routing of ``models.attention.attend``; and a reduced
granite-moe paged prefill over several chunks against the reference's
``prefill_paged``.

Inputs come from numpy seeds; weights cross over through
``repro_torch.convert``. Tolerances: the reference oracle's
(``tests/test_kernels_flash.py``: float32 5e-5, bf16 3e-2) for attention,
1e-4 for three layers of float32 model logits."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import flash_attention as jax_flash_attention
from repro.models.lm import LM as JaxLM
from repro_torch.configs import reduced
from repro_torch.convert import from_jax_params
from repro_torch.kernels import cvmm as K
from repro_torch.kernels import flash_attention as K7
from repro_torch.models import LM
from repro_torch.models import attention as attn

ORACLE_CASES = [
    # (b, sq, sk, h, kv, d, causal), as tests/test_kernels_flash.py
    (2, 128, 128, 4, 2, 128, True),
    (1, 256, 256, 2, 2, 128, True),
    (1, 100, 100, 4, 4, 128, True),
    (2, 128, 128, 4, 2, 128, False),
    (1, 384, 384, 8, 2, 128, True),
]
TOL = {"float32": 5e-5, "bfloat16": 3e-2}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, b, sq, sk, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


def _torch(arrs, dtype="float32"):
    return [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ORACLE_CASES)
def test_plain_matches_pallas_kernel(case, dtype):
    b, sq, sk, h, kv, d, causal = case
    arrs = _qkv(b * 31 + sq, b, sq, sk, h, kv, d)
    want = flash_attention_pallas(*(jnp.asarray(a, JAX_DTYPE[dtype]) for a in arrs),
                                  causal=causal, scale=d ** -0.5, interpret=True)
    got = K7.flash_attention_plain(*_torch(arrs, dtype), causal=causal, scale=d ** -0.5)
    assert got.dtype == TORCH_DTYPE[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("sq", [1, 50, 130])
@pytest.mark.parametrize("q_offset", [0, 77, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("heads", [(24, 8, 64), (4, 2, 16)], ids=["gqa24_8_d64", "gqa4_2_d16"])
def test_plain_matches_pure_jax_with_offset_and_kv_len(heads, causal, q_offset, sq):
    """Sk = 261 (not a multiple of 128); two batch rows with kv_len 37 and
    200. The plain version in 64-key chunks, and K7's wrapper (its plain
    version in one chunk on the CPU)."""
    h, kv, d = heads
    arrs = _qkv(q_offset + sq, 2, sq, 261, h, kv, d)
    kv_len = np.array([37, 200])
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=q_offset)
    want = np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in arrs), kv_chunk=64,
                                          kv_len=jnp.asarray(kv_len), **kw))
    q, k, v = _torch(arrs)
    got = K7.flash_attention_plain(q, k, v, kv_chunk=64, kv_len=torch.from_numpy(kv_len), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=5e-5)
    wrapped = K7.flash_attention(q, k, v, kv_len=torch.from_numpy(kv_len), **kw)
    np.testing.assert_allclose(wrapped.numpy(), want, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_kv_len_zero_lane_is_zero_as_in_pure_jax(causal):
    arrs = _qkv(5, 2, 40, 100, 4, 2, 16)
    kv_len = np.array([0, 60])
    kw = dict(causal=causal, scale=0.25, q_offset=20)
    want = np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in arrs), kv_chunk=64,
                                          kv_len=jnp.asarray(kv_len), **kw))
    got = K7.flash_attention_plain(*_torch(arrs), kv_len=torch.from_numpy(kv_len), **kw)
    assert not want[0].any() and not got[0].any()
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=5e-5)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = _torch(_qkv(6, 2, 50, 261, 24, 8, 64), "bfloat16")
    kv_len = torch.tensor([37, 200])
    K.reset_launch_counts()
    got = K7.flash_attention(q, k, v, causal=True, scale=0.125, q_offset=77, kv_len=kv_len)
    assert torch.equal(got, K7.flash_attention_plain(q, k, v, causal=True, scale=0.125,
                                                     q_offset=77, kv_len=kv_len))
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)


@pytest.mark.parametrize("bad", ["kv_heads", "head_dim", "dtype", "kv_len_shape",
                                 "kv_len_float", "rank"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = _torch(_qkv(7, 2, 8, 16, 4, 2, 16))
    kv_len = torch.tensor([3, 16])
    if bad == "kv_heads":
        k = v = k[:, :, :1].expand(2, 16, 3, 16)
    elif bad == "head_dim":
        k = v = k[..., :8]
    elif bad == "dtype":
        k = k.bfloat16()
    elif bad == "kv_len_shape":
        kv_len = kv_len[:1]
    elif bad == "kv_len_float":
        kv_len = kv_len.float()
    else:
        q = q[0]
    with pytest.raises(ValueError, match="flash_attention"):
        K7.flash_attention(q, k, v, causal=True, scale=0.25, kv_len=kv_len)


def _spy(monkeypatch, run=K7.flash_attention):
    """Record every call that reaches the K7 wrapper, then hand it to ``run``
    (the wrapper itself by default)."""
    calls = []

    def spy(q, k, v, **kw):
        calls.append(dict(kw, shape=tuple(q.shape)))
        return run(q, k, v, **kw)

    monkeypatch.setattr(K7, "flash_attention", spy)
    return calls


def test_cpu_calls_take_the_chunked_path(monkeypatch):
    """A CPU call reaches K7's wrapper, which runs the chunked core (its plain
    version) and launches nothing."""
    calls = _spy(monkeypatch)
    q, k, v = _torch(_qkv(8, 1, 20, 20, 4, 2, 16))
    K.reset_launch_counts()
    with torch.no_grad():
        got = attn.attend(q, k, v, causal=True, window=0, scale=0.25, kv_chunk=8)
    assert len(calls) == 1 and K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)
    assert torch.equal(got, attn.flash_attention(q, k, v, causal=True, scale=0.25))


@pytest.mark.parametrize("window,grad,to_k7", [(0, False, True), (5, False, False),
                                               (0, True, False)],
                         ids=["no_grad", "window", "needs_grad"])
def test_k7_takes_only_calls_without_window_or_grad(monkeypatch, window, grad, to_k7):
    """The routing is the same on the CPU as on CUDA."""
    calls = _spy(monkeypatch)
    q, k, v = _torch(_qkv(9, 1, 20, 20, 4, 2, 16))
    q.requires_grad_(grad)
    out = attn.attend(q, k, v, causal=True, window=window, scale=0.25, q_offset=0,
                      kv_chunk=8)
    assert bool(calls) == to_k7
    want = attn.flash_attention(q, k, v, causal=True, window=window, scale=0.25,
                                kv_chunk=8)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)
    if grad:
        out.sum().backward()
        assert q.grad is not None


ARCH = "granite-moe-3b-a800m"


@pytest.fixture(scope="module")
def granite():
    jlm = JaxLM(jax_reduced(ARCH).override(dtype="float32"))
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = LM(reduced(ARCH).override(dtype="float32"))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), lm.cfg,
                             device="cpu")
    return jlm, jparams, lm, params


@pytest.mark.parametrize("route", ["chunked", "k7"])
def test_paged_prefill_over_chunks_matches_reference(granite, monkeypatch, route):
    """A 300-token prompt in 128-token chunks (the last one padded), pages of
    16: each chunk's logits against the reference's at 1e-4. Every chunk's
    attention reaches K7's wrapper, whose calls are checked; "k7" lets the
    wrapper run (its plain version on the CPU), "chunked" hands each call to
    the chunked core at the config's ``kv_chunk``, as training runs it."""
    jlm, jparams, lm, params = granite
    run = K7.flash_attention
    if route == "chunked":
        def run(q, k, v, **kw):
            return attn.flash_attention(q, k, v, kv_chunk=lm.cfg.attention.kv_chunk, **kw)
    calls = _spy(monkeypatch, run)
    n, chunk, ps = 300, 128, 16
    prompt = np.random.default_rng(10).integers(1, lm.cfg.vocab_size, size=n)
    n_pages = -(-3 * chunk // ps)
    table = np.arange(1, 1 + n_pages, dtype=np.int32)[None]
    jcache = jlm.init_paged_cache(1 + n_pages, ps)
    tcache = lm.init_paged_cache(1 + n_pages, ps, device="cpu")
    starts = range(0, n, chunk)
    with torch.no_grad():
        for start in starts:
            ln = min(chunk, n - start)
            tokens = np.zeros((1, chunk), np.int64)
            tokens[0, :ln] = prompt[start:start + ln]
            jl, jcache = jlm.prefill_paged(jparams, jnp.asarray(tokens, jnp.int32), jcache,
                                           jnp.asarray(table), jnp.int32(start),
                                           jnp.int32(ln))
            tl, tcache = lm.prefill_paged(params, torch.from_numpy(tokens), tcache,
                                          torch.from_numpy(table), start, ln)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    want = [(start, min(start + chunk, n)) for start in starts
            for _ in range(lm.cfg.n_layers)]
    assert [(c["q_offset"], int(c["kv_len"][0])) for c in calls] == want
    assert all(c["shape"] == (1, chunk, 4, 16) and c["causal"] for c in calls)
