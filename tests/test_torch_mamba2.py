"""Mamba2's SSD block on the port (``models/mamba2.py``) against the
reference's pure-JAX ``models/mamba2.py``: the chunked scan with padding
(a length that is not a multiple of the chunk), a carried ``init_state``
and B/C groups of 1 and 2 (``repeat_interleave``, not ``Tensor.repeat``);
the one-token recurrence; the causal depthwise conv with its cache; the
full block's output, cache and gradients; and the chunked form against
the recurrence on the port alone.

Inputs and weights come from numpy seeds. Tolerances: float32 1e-5 for
one scan (sums in another order), 1e-4 for the block's output and 2e-4
for its gradients (a projection, a conv and a scan in float32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import mamba2 as jm
from repro_torch.configs import reduced
from repro_torch.models import mamba2 as tm

TOL = 1e-5


def _scan_inputs(seed, b=2, s=45, h=4, p=8, g=2, n=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)   # softplus
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, st


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_reference_with_padding_and_state(groups):
    """45 tokens in chunks of 16 (three chunks, the last one padded), from
    zero and from a carried state; with 2 groups, heads 0-1 read group 0
    and heads 2-3 group 1."""
    x, dt, A, B, C, st = _scan_inputs(groups, g=groups)
    for init in (None, st):
        jy, jst = jm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), 16,
                                 None if init is None else jnp.asarray(init))
        ty, tst = tm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)), 16,
                                 None if init is None else torch.from_numpy(init))
        assert ty.shape == x.shape and tst.shape == st.shape
        _close(ty, jy)
        _close(tst, jst)


def test_decode_step_and_causal_conv_match_reference():
    """One recurrence step; the conv over a whole sequence from zeros,
    then over its last token from the cache the first 44 tokens left, with
    w[:, K-1] multiplying the current token."""
    x, dt, A, B, C, st = _scan_inputs(3, g=4)          # one group a head
    jy, jst = jm.ssd_decode_step(*(jnp.asarray(a) for a in
                                   (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], st)))
    ty, tst = tm.ssd_decode_step(*(torch.from_numpy(a) for a in
                                   (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], st)))
    _close(ty, jy)
    _close(tst, jst)

    rng = np.random.default_rng(4)
    seq = rng.standard_normal((2, 45, 10)).astype(np.float32)
    w = rng.standard_normal((10, 4)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    jy, jc = jm._conv1d_causal(jnp.asarray(seq), jnp.asarray(w), jnp.asarray(b))
    ty, tc = tm._conv1d_causal(torch.from_numpy(seq), torch.from_numpy(w), torch.from_numpy(b))
    _close(ty, jy)
    _close(tc, jc)
    np.testing.assert_allclose(ty[:, 0].numpy(), seq[:, 0] * w[:, 3] + b, atol=TOL, rtol=TOL)
    _, cache = tm._conv1d_causal(torch.from_numpy(seq[:, :44]), torch.from_numpy(w),
                                 torch.from_numpy(b))
    last, _ = tm._conv1d_causal(torch.from_numpy(seq[:, 44:]), torch.from_numpy(w),
                                torch.from_numpy(b), cache)
    _close(last[:, 0], np.asarray(jy)[:, 44])


def _block(groups):
    """Reduced mamba2-370m (d 64, 8 heads of 16, d_state 16, chunk 32) with
    ``groups`` B/C groups; the reference's init, carried to the port."""
    jcfg = jax_reduced("mamba2-370m")
    jcfg = jcfg.override(ssm=dataclasses.replace(jcfg.ssm, n_groups=groups))
    cfg = reduced("mamba2-370m")
    cfg = cfg.override(ssm=dataclasses.replace(cfg.ssm, n_groups=groups))
    jp = jm.init_ssm(jax.random.PRNGKey(groups), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("groups", [1, 2])
def test_apply_ssm_forward_cache_and_gradients_match_reference(groups):
    """The block over 70 tokens (three chunks of 32, padded), the same
    tokens as a 69-token prefill into a cache then one decode step, and the
    gradients of a scalar of the output by every parameter and the input."""
    jcfg, cfg, jp, tp = _block(groups)
    x = np.random.default_rng(5 + groups).standard_normal((2, 70, 64)).astype(np.float32)
    jy, _ = jm.apply_ssm(jp, jnp.asarray(x), jcfg)
    ty, _ = tm.apply_ssm(tp, torch.from_numpy(x), cfg)
    _close(ty, jy, 1e-4)

    jcache = jm.init_ssm_cache(jcfg, 2)
    _, jcache = jm.apply_ssm(jp, jnp.asarray(x[:, :69]), jcfg, cache=jcache)
    jlast, jcache = jm.apply_ssm(jp, jnp.asarray(x[:, 69:]), jcfg, cache=jcache)
    tcache = tm.init_ssm_cache(cfg, 2, device="cpu")
    _, tcache = tm.apply_ssm(tp, torch.from_numpy(x[:, :69]), cfg, cache=tcache)
    tlast, tcache = tm.apply_ssm(tp, torch.from_numpy(x[:, 69:]), cfg, cache=tcache)
    _close(tlast, jlast, 1e-4)
    _close(tlast[:, 0], np.asarray(jy)[:, 69], 1e-4)
    for key in ("conv", "state"):
        _close(tcache[key], jcache[key], 1e-4)

    probe = np.random.default_rng(9).standard_normal((2, 70, 64)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jm.apply_ssm(p, xx, jcfg)[0] * probe)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (tm.apply_ssm(tp, tx, cfg)[0] * torch.from_numpy(probe)).sum().backward()
    _close(tx.grad, jgx, 2e-4)
    for k in jp:
        scale = max(1.0, float(np.abs(np.asarray(jgp[k])).max()))
        np.testing.assert_allclose(tp[k].grad.numpy() / scale, np.asarray(jgp[k]) / scale,
                                   atol=2e-4, rtol=2e-4, err_msg=k)


def test_chunked_scan_equals_the_recurrence():
    """The port alone: the chunked form over 45 tokens in chunks of 8 and
    16 equals 45 steps of the recurrence from the same state."""
    x, dt, A, B, C, st = (torch.from_numpy(a) for a in _scan_inputs(7, g=2))
    state, ys = st.clone(), []
    for t in range(x.shape[1]):
        y, state = tm.ssd_decode_step(x[:, t], dt[:, t], A,
                                      B[:, t].repeat_interleave(2, dim=1),
                                      C[:, t].repeat_interleave(2, dim=1), state)
        ys.append(y)
    want = torch.stack(ys, dim=1)
    for chunk in (8, 16):
        got, final = tm.ssd_chunked(x, dt, A, B, C, chunk, st)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(final, state, atol=1e-4, rtol=1e-4)
