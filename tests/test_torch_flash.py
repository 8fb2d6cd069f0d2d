"""K7 on the CPU: the port's ``flash_attention_plain`` (the chunked core,
K7's plain version) against the reference's Pallas kernel (interpret mode)
and its pure-JAX ``models.attention.flash_attention`` with ``q_offset`` and
``kv_len``; the routing of ``models.attention.attend``; a reduced
granite-moe paged prefill over several chunks against the reference's
``prefill_paged``; and the bf16 kernel's split-KV schedule
(``flash_schedule``) with a plain-torch emulation of its split partials and
their merge against ``flash_attention_plain``.

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
from test_torch_cuda import FLASH_CASES

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


# ---------------------------------------------------------------------------
# The bf16 kernel's schedule (csrc/flash_attention.cu): packed GQA row tiles,
# split-KV over the card, and the merge of the splits' partials.
# ---------------------------------------------------------------------------
SCHEDULE_SHAPES = [case[:8] for case in FLASH_CASES] + [
    (1, 32, 128, 24, 8, 64, True, 64),        # serve's prefill chunk
    (4, 32, 4096, 24, 8, 64, True, 3456),     # four lanes, a short chunk, a long cache
    (1, 1, 4096, 24, 8, 64, True, 4095),      # one row
    (1, 256, 4096, 24, 8, 64, False, 0),      # no causal mask
]


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_flash_schedule_covers_each_items_keys_once(shape):
    """Every item's host-known key tiles, [0, min(Sk, q_offset + its last
    position + 1)) in BK-key tiles, are covered once, in order, in whole
    tiles, by at most ``splits`` runs of at least MIN_TILES tiles each (one
    run when the item is shorter)."""
    b, sq, sk, h, kvh, d, causal, q_offset = shape
    grp, bk = h // kvh, K7.FLASH_BK[d]
    row_tile, items, splits, grid = K7.flash_schedule(b, sq, h, kvh, sk, q_offset, causal,
                                                      132, bk)
    n_rt = -(-sq * grp // row_tile)
    assert row_tile == 128 and items == b * kvh * n_rt and grid == items * splits
    for rt in range(n_rt):
        last = min(sq - 1, (rt * row_tile + row_tile - 1) // grp)
        keys = min(sk, q_offset + last + 1) if causal else sk
        n = K7.flash_item_tiles(rt, sq, sk, grp, causal, q_offset, bk)
        assert n == -(-keys // bk) and (n - 1) * bk < keys <= n * bk
        ranges = K7.flash_split_ranges(n, splits)
        assert 1 <= len(ranges) <= splits
        assert [lo for lo, _ in ranges] == [0] + [hi for _, hi in ranges[:-1]]
        assert ranges[-1][1] == n
        assert len(ranges) == 1 or all(hi - lo >= K7.MIN_TILES for lo, hi in ranges)
        sizes = [hi - lo for lo, hi in ranges]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("grp,sq", [(1, 100), (2, 100), (3, 100), (4, 50), (3, 256)])
def test_flash_packed_rows_map_one_to_one(grp, sq):
    """Packed row r of a KV head is position r // grp of head r % grp of the
    group: the row tiles cover every (position, head) once, Sq not a
    multiple of 128 / grp included."""
    n_rt = -(-sq * grp // K7.ROW_TILE)
    seen = []
    for rt in range(n_rt):
        pos, head = K7.flash_packed_rows(rt, sq, grp)
        assert len(pos) == len(head) <= K7.ROW_TILE
        seen += list(zip(pos, head))
    assert sorted(seen) == [(p, j) for p in range(sq) for j in range(grp)]
    assert len(seen) == len(set(seen)) == sq * grp


def test_flash_schedule_fills_a_wave_at_serve_long_and_one_split_at_serve():
    """At serve-long's last full chunk on 132 SMs the most splits that keep
    one block an SM (48 items of 2: a third split would need 144 blocks, two
    waves); serve's chunks (at most 32 tokens over at most 128 keys) take
    one split and so no scratch."""
    row_tile, items, splits, grid = K7.flash_schedule(1, 256, 24, 8, 4096, 3072, True, 132)
    assert (items, splits, grid) == (48, 2, 96)
    assert items * splits <= 132 < items * (splits + 1)
    for sq, q_offset in ((32, 0), (32, 64), (17, 96), (1, 127)):
        assert K7.flash_schedule(1, sq, 24, 8, 128, q_offset, True, 132)[2] == 1
    # FLASH_CASES' split cases: the kv_len 0 lane's items take several
    # splits, and kv_len 300 ends inside the first split of its items.
    assert K7.flash_schedule(2, 128, 8, 2, 4096, 3072, True, 132)[2] > 1
    splits = K7.flash_schedule(2, 128, 4, 1, 2048, 1920, True, 132)[2]
    ranges = K7.flash_split_ranges(K7.flash_item_tiles(0, 128, 2048, 4, True, 1920, 128), splits)
    assert len(ranges) > 1 and 300 < ranges[0][1] * 128


def _split_emulation(q, k, v, *, causal, scale, q_offset, kv_len, bk, splits):
    """The bf16 kernel's arithmetic in float32 plain torch, split by split:
    each split's partial (m in the exp2 domain, l, unnormalised O) over its
    key tiles cut at kv_len and each row's causal limit, then the merge in
    split order, 2^(m_k - max m) weights, out = sum w O / max(sum w l,
    1e-20); one split writes O / max(l, 1e-20)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    grp, c = h // kvh, abs(scale) * 1.4426950408889634
    out = torch.zeros_like(q)
    n_rt = -(-sq * grp // K7.ROW_TILE)
    for bi in range(b):
        kvl = max(0, min(sk, sk if kv_len is None else int(kv_len[bi])))
        for kv in range(kvh):
            for rt in range(n_rt):
                pos, head = (torch.tensor(x) for x in K7.flash_packed_rows(rt, sq, grp))
                rows = q[bi, pos, kv * grp + head] * (1 if scale >= 0 else -1)
                lim = torch.full_like(pos, kvl - 1)
                if causal:
                    lim = torch.minimum(lim, q_offset + pos)
                n = K7.flash_item_tiles(rt, sq, sk, grp, causal, q_offset, bk)
                parts = []
                for lo, hi in K7.flash_split_ranges(n, splits):
                    hi = max(lo, min(hi, -(-kvl // bk)))
                    keys = torch.arange(lo * bk, min(hi * bk, sk))
                    s = rows @ k[bi, keys, kv].T
                    s = s.masked_fill(keys[None, :] > lim[:, None], float("-inf"))
                    m = (s.amax(1) if keys.numel() else
                         torch.full((len(pos),), float("-inf"))) * c
                    base = torch.where(torch.isneginf(m), 0.0, m)
                    p = torch.exp2(s * c - base[:, None])
                    parts.append((m, p.sum(1), p @ v[bi, keys, kv]))
                if len(parts) == 1:
                    m, l, o = parts[0]
                    res = o / l.clamp_min(1e-20)[:, None]
                else:
                    top = torch.stack([m for m, _, _ in parts]).amax(0)
                    top = torch.where(torch.isneginf(top), 0.0, top)
                    w = [torch.exp2(m - top) for m, _, _ in parts]
                    l = sum(wk * lk for wk, (_, lk, _) in zip(w, parts))
                    o = sum(wk[:, None] * ok for wk, (_, _, ok) in zip(w, parts))
                    res = o / l.clamp_min(1e-20)[:, None]
                out[bi, pos, kv * grp + head] = res
    return out


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_merge_emulation_matches_plain(case):
    """The kernel's split partials and merge, emulated in float32 over the
    schedule's splits at 132 SMs, equal flash_attention_plain within 1e-6:
    among them a kv_len 0 lane on items of several splits (all partials
    empty) and a lane whose kv_len (300) ends inside the first split."""
    b, sq, sk, h, kvh, d, causal, q_offset, kv_len = case
    q, k, v = _torch(_qkv(sq + sk, b, sq, sk, h, kvh, d))
    kl = None if kv_len is None else torch.tensor(kv_len)
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=q_offset, kv_len=kl)
    bk = K7.FLASH_BK[d]
    splits = K7.flash_schedule(b, sq, h, kvh, sk, q_offset, causal, 132, bk)[2]
    got = _split_emulation(q, k, v, bk=bk, splits=splits, **kw)
    torch.testing.assert_close(got, K7.flash_attention_plain(q, k, v, **kw),
                               atol=1e-6, rtol=1e-6)
    if kv_len is not None and 0 in kv_len:
        assert not got[kv_len.index(0)].any()
