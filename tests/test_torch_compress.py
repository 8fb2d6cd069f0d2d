"""Error-feedback gradient compression on the port against the reference's
``optim/compress.py``, on the CPU: ``compress_grads`` in "bf16" and "int8"
over three rounds of the same gradients and residuals (the wire values
and the residuals every round), the expert-leaf names, the residual
state, and the pod tier's refusal (it needs a device mesh).

The reference's tree stacks a segment's two layers into one leaf, the
port's holds one leaf a layer (``models/stack.py``), so int8's per-tensor
scale spans both layers on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jcompress
from repro_torch.common import map_leaves
from repro_torch.optim import compress

LAYERS = 2
Z = lambda *shape: np.zeros(shape, np.float32)
# the reference's layout: the segment's layers stacked on a leading axis
TEMPLATE = {"emb": Z(12, 8), "stack": {"segments": [{"e0": {
    "ffn": {"we1": Z(LAYERS, 4, 8, 6), "we2": Z(LAYERS, 4, 6, 8),
            "router": Z(LAYERS, 8, 4)},
    "norm1": {"scale": Z(LAYERS, 8)}}}]}}


def _tree(rng, scale):
    """Random leaves in the reference's layout; the layers' scales differ,
    so the shared int8 scale is the larger layer's."""
    def leaf(path, z):
        a = rng.standard_normal(z.shape) * scale
        if path[0] == "stack":
            a = a * np.array([1.0, 3.0]).reshape((LAYERS,) + (1,) * (z.ndim - 1))
        return a.astype(np.float32)
    return map_leaves(TEMPLATE, leaf)


def _port(tree):
    """The same values in the port's layout: one dict per layer."""
    seg = tree["stack"]["segments"][0]
    return {"emb": torch.from_numpy(np.array(tree["emb"])), "stack": {"segments": [
        {name: [map_leaves(entry, lambda path, a, r=r: torch.from_numpy(np.array(a[r])))
                for r in range(LAYERS)] for name, entry in seg.items()}]}}


def _paths(tree):
    out = {}
    map_leaves(tree, lambda path, leaf: out.setdefault(path, leaf))
    return out


def _reference_slice(jpaths, path):
    """The reference's value behind the port's leaf at ``path``."""
    a = np.asarray(jpaths[compress.stacked_path(path)])
    return a[path[4]] if compress.stacked_path(path) != path else a


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compress_grads_matches_reference_over_three_rounds(mode):
    rng = np.random.default_rng(0)
    err = compress.init_compression_state(_port(_tree(rng, 1.0)))
    jerr = jcompress.init_compression_state(_tree(rng, 1.0))
    for step in range(3):
        grads = _tree(rng, 10.0 ** -step)
        wire, err = compress.compress_grads(_port(grads), err, mode)
        jwire, jerr = jcompress.compress_grads(
            jax.tree_util.tree_map(jnp.asarray, grads), jerr, mode)
        got, got_err = _paths(wire), _paths(err)
        want, want_err = _paths(jwire), _paths(jerr)
        assert set(got) == set(got_err) and len(got) == 1 + 4 * LAYERS
        for path in got:
            assert got[path].dtype == got_err[path].dtype == torch.float32
            np.testing.assert_allclose(got[path].numpy(), _reference_slice(want, path),
                                       rtol=1e-6, atol=0,
                                       err_msg=f"{mode} round {step} wire {path}")
            np.testing.assert_allclose(got_err[path].numpy(),
                                       _reference_slice(want_err, path), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{mode} round {step} err {path}")
    assert compress.compress_grads(wire, err, "none") == (wire, err)


def test_expert_leaves_state_and_pod_tier():
    """``is_expert_leaf`` names the port's leaves as the reference's names
    the stacked leaves they slice; the residuals are float32 zeros of each
    leaf's shape; the pod tier raises and names ROADMAP queue 1 item 8."""
    tree = _tree(np.random.default_rng(1), 1.0)
    jflat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            jcompress.is_expert_leaf(path) for path, _ in jflat}
    params = map_leaves(_port(tree), lambda path, a: a.to(torch.bfloat16))
    got = {path: compress.is_expert_leaf(path) for path in _paths(params)}
    assert got == {path: want[compress.stacked_path(path)] for path in got}
    assert sum(got.values()) == 2 * LAYERS
    state = _paths(compress.init_compression_state(params))
    for path, p in _paths(params).items():
        assert state[path].dtype == torch.float32 and state[path].shape == p.shape
        assert not state[path].any()
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        compress.init_compression_state(params, pod=2)
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        compress.compress_pod_grads(params, state, "int8")
