"""The weighted value sum's plans on the port against the reference, on the
CPU: every integer field of ``make_gather_plan`` (one slot per selection)
and ``make_dedup_gather_plan`` (each selected row once, sorted) equal to the
reference's, on duplicate-heavy, all-unique, single-token and all-sentinel
selections; ``gather_supported`` equal to the reference's at every
d_model of the port's configs; and ``value_sum_path`` keeping CUDA on the
two K6 rungs. The port's plans leave out the TPU DMA
chunk table (``run_start``/``run_len``/``run_off``), which no Hopper kernel
reads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import archs, get_config, reduced
from repro_torch.kernels import ops
from repro_torch.models import build_model

# (tokens, slots, table rows, selection): "all sentinel" leaves whole
# 128-slot tiles of the dedup plan past the last selected row.
CASES = {"duplicate heavy": (40, 5, 300, "hot"), "all unique": (16, 8, 128, "unique"),
         "single token": (1, 6, 50, "spread"), "all sentinel": (64, 4, 300, "few")}


def _selection(n, s, rows, kind, rng):
    if kind == "hot":
        idx = rng.choice([3, 4, 5, 17, 299, 0, 150], size=(n, s))
    elif kind == "unique":
        idx = rng.permutation(rows)[:n * s].reshape(n, s)
    elif kind == "few":
        idx = rng.integers(200, 203, size=(n, s))
    else:
        idx = rng.integers(0, rows, size=(n, s))
    return idx.astype(np.int32), rng.standard_normal((n, s)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_integer_fields_match_reference(case):
    n, s, rows, kind = CASES[case]
    idx, w = _selection(n, s, rows, kind, np.random.default_rng(sorted(CASES).index(case)))
    jplan = jops.make_gather_plan(jnp.asarray(idx), jnp.asarray(w), rows)
    plan = ops.make_gather_plan(torch.from_numpy(idx), torch.from_numpy(w), rows)
    assert plan.m_pad == jplan.m_pad
    for field in ("row_src", "tok_src"):
        np.testing.assert_array_equal(getattr(plan, field).numpy(),
                                      np.asarray(getattr(jplan, field)), err_msg=field)
    np.testing.assert_array_equal(plan.weight_tiles.numpy(), np.asarray(jplan.weight_tiles))
    jdedup = jops.make_dedup_gather_plan(jnp.asarray(idx), jnp.asarray(w), rows)
    dedup = ops.make_dedup_gather_plan(torch.from_numpy(idx), torch.from_numpy(w), rows)
    assert dedup.u_pad == jdedup.u_pad
    for field in ("row_src", "sel_pos", "tok_src"):
        np.testing.assert_array_equal(getattr(dedup, field).numpy(),
                                      np.asarray(getattr(jdedup, field)), err_msg=field)
    np.testing.assert_array_equal(dedup.weights.numpy(), np.asarray(jdedup.weights))
    valid = dedup.row_src < rows
    assert torch.equal(dedup.row_src[dedup.sel_pos], torch.from_numpy(idx).reshape(-1))
    if case == "all sentinel":
        assert not valid[128:].any() and dedup.u_pad == 256


def test_gather_supported_matches_reference():
    widths = set()
    for name in sorted(archs._REGISTRY):
        for cfg in (get_config(name), reduced(name)):
            widths.add(cfg.d_model)
            for kind in ("topk", "pkm"):
                lm = build_model(cfg, ffn=kind)
                widths.add(lm.cfg.d_model)
    assert {64, 412, 512, 1024, 1536} <= widths
    for d in sorted(widths):
        for jdt, dt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            assert ops.gather_supported(d, dt) == jops.gather_supported(d, jdt), (d, dt)


def test_value_sum_path_keeps_cuda_on_k6():
    """On the CPU every rung is taken; on CUDA only the two K6 rungs are,
    and a pin to "dense" or "einsum", or a dtype K6 does not take, raises
    instead of running the plain gather on the card."""
    from repro_torch.configs.base import FFNConfig
    from repro_torch.core import value_sum_path
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for impl, want in (("dense", "dense"), ("einsum", "einsum"), ("auto", "einsum"),
                       ("pallas", "pallas"), ("pallas_fused", "pallas_fused")):
        cfg = FFNConfig(kind="pkm", impl=impl)
        assert value_sum_path(cfg, 412, torch.float32, cpu) == want
        if want.startswith("pallas") or impl == "auto":
            for dt in (torch.float32, torch.bfloat16):
                got = value_sum_path(cfg, 412, dt, cuda)
                assert got == ("pallas_fused" if impl == "auto" else want)
            with pytest.raises(NotImplementedError, match="plain CPU rung"):
                value_sum_path(cfg, 412, torch.float16, cuda)
        else:
            with pytest.raises(NotImplementedError, match="plain CPU rung"):
                value_sum_path(cfg, 412, torch.float32, cuda)
