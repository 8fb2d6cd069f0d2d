"""The trainer with its FFN swapped to PKM and to the top-K MLP, on the
port against the reference, on the CPU: three train steps of reduced
wt103-47m-dense with ``--ffn pkm`` and ``--ffn topk`` (3 layers, d_model
64; float32, dropout 0; XL memories) in step with the reference, as
tests/test_torch_paper_pair.py runs the paper's pairs, and the port's CLI
``--ffn`` with ``--device cpu --reduced`` (which refuses a swap to
sigma_moe: its "einsum" dispatch is not ported). The port runs the value sum on
its kernel rung ("pallas_fused": ``ops.gathered_weighted_sum_dedup`` on
K6's plain version), the reference on its einsum rung: both compute the
same sum. Tolerances: losses 1e-4, parameters after the steps 2e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.configs import reduced as jax_reduced
from repro.data import DataIterator as JaxDataIterator
from repro.data import make_dataset as jax_make_dataset
from repro.models.registry import build_model as jax_build_model
from repro.runtime.steps import init_train_state as jax_init_train_state
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch.common import map_leaves, tree_leaves
from repro_torch.configs import OptimizerConfig, reduced
from repro_torch.convert import from_jax_params
from repro_torch.kernels import cvmm as K
from repro_torch.launch import train as train_cli
from repro_torch.models import LM, build_model
from repro_torch.optim import adamw_init
from repro_torch.runtime import make_train_step

ARCH = "wt103-47m-dense"


def _f32(cfg, impl):
    cfg = cfg.override(dtype="float32", dropout=0.0)
    return cfg.with_ffn(dataclasses.replace(cfg.ffn, impl=impl))


@pytest.mark.parametrize("kind", ["pkm", "topk"])
def test_three_swapped_train_steps_match_reference(kind):
    jlm = jax_build_model(jax_reduced(ARCH), ffn=kind)
    jlm = type(jlm)(_f32(jlm.cfg, "einsum"))
    lm = LM(_f32(build_model(reduced(ARCH), ffn=kind).cfg, "pallas_fused"))
    assert lm.cfg.ffn.kind == kind
    B, S = 2, 12
    jopt = JaxOptimizerConfig(total_steps=3)
    jstate = jax_init_train_state(jlm, jax.random.PRNGKey(0), jopt, use_mems=True, batch=B)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jstate["params"]), lm.cfg,
                             device="cpu")
    layer = params["stack"]["segments"][0]["e0"][0]["ffn"]
    assert set(layer) == ({"keys_a", "keys_b", "values"} if kind == "pkm" else {"w1", "w2"})
    tparams = map_leaves(params, lambda path, p: p.requires_grad_())
    state = {"params": tparams, "opt": adamw_init(tparams),
             "mems": lm.init_mems(B, device="cpu")}
    jstep = jax.jit(jax_make_train_step(jlm, jopt))
    step = make_train_step(lm, OptimizerConfig(total_steps=3))
    it = JaxDataIterator(jax_make_dataset("synthetic", lm.cfg.vocab_size), B, S, seed=7)
    for _ in range(3):
        tokens = it.next()["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)}, jax.random.PRNGKey(1))
        state, m = step(state, {"tokens": torch.from_numpy(np.array(tokens))})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-3)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                           lm.cfg, device="cpu")
    for got, w in zip(tree_leaves(state["params"]), tree_leaves(want)):
        np.testing.assert_allclose(got.detach().numpy(), w.numpy(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("kind", ["pkm", "topk"])
def test_trainer_cli_swaps_the_ffn_on_the_cpu(kind, capsys):
    out = train_cli.main(["--arch", ARCH, "--ffn", kind, "--reduced", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--device", "cpu"],
                         eval_batches=1)
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert np.isfinite(out["eval_losses"]).all()
    assert out["launches"] == [dict.fromkeys(K.LAUNCHES, 0)] * 3   # plain on CPU
    layer = out["state"]["params"]["stack"]["segments"][0]["e0"][0]["ffn"]
    assert set(layer) == ({"keys_a", "keys_b", "values"} if kind == "pkm" else {"w1", "w2"})
    assert f", ffn {kind}, " in capsys.readouterr().out


def test_trainer_cli_refuses_the_sigma_moe_swap():
    """``--ffn sigma_moe`` on a dense arch gives the reference's "einsum"
    dispatch, which the port does not run: the CLI stops before it builds
    any state, naming the queue item."""
    with pytest.raises(SystemExit, match="ROADMAP queue 1 item 1"):
        train_cli.main(["--arch", ARCH, "--ffn", "sigma_moe", "--reduced", "--steps",
                        "1", "--batch", "2", "--seq", "16", "--device", "cpu"])
