"""The port's train step on a mesh of 4 gloo ranks (2x2) on the CPU against
one process on the global batch: three steps of the reduced wt103-47m-moe
(3 layers, d_model 64, 4 experts; float32, dropout 0, XL memories) with
the sort dispatch (also against the reference's one-device step, from its
init), ``dispatch="shard_map"`` (experts sharded over "model"; capacity
factor 2.0 = E/k, so nothing drops and one process's capacity path
computes the same), S-BASE, noisy top-k (its gating noise drawn for the
global batch from the shared generator) and ``grad_accum=2``: the losses,
the grad norms and every parameter, gathered, within 1e-5 and 2e-4, the
replicated ones bit-equal on every rank. The capacity dispatch on more
than one rank must raise, and ``python -m repro_torch.launch.train --mesh
2x2`` must train as ``--mesh 1x1`` does in one process. One spawn of the
ranks (``tests/torch_mesh_ranks.py``) serves every test here."""
import dataclasses
import json

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
from repro_torch.convert import from_jax_params
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from torch_mesh_ranks import (case_config, run_case, run_ranks, save_tree, train_body,
                              tree_arrays)

ARCH = "wt103-47m-moe"
B, S, STEPS = 8, 12, 3
MESH = (2, 2)
NOISY = dict(kind="noisy_topk", selector_activation="softmax", renormalize=True,
             reg_kind="cv", reg_gamma=1e-2)
CASES = [dict(name="sort", ffn=dict(impl="ragged")),
         dict(name="shard_map", ffn=dict(dispatch="shard_map", capacity_factor=2.0)),
         dict(name="sbase", ffn=dict(kind="sbase")),
         dict(name="noisy_topk", ffn=NOISY),
         dict(name="grad_accum", ffn={}, grad_accum=2),
         dict(name="einsum", ffn=dict(dispatch="einsum"))]
CLI = ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "8", "--seq", "12",
       "--seed", "3", "--device", "cpu", "--log-every", "100"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's sort steps, then every case on the ranks, then every
    case in one process: {name: (mesh ranks' numbers, one process's)}."""
    out = tmp_path_factory.mktemp("mesh_train")
    it = JaxDataIterator(jax_make_dataset("synthetic", 256), B, S + 1, seed=7)
    batches = np.stack([np.asarray(it.next()["tokens"]) for _ in range(STEPS)])
    np.save(out / "batches.npy", batches)
    cases = [dict(c, arch=ARCH, mesh=MESH) for c in CASES]

    jcfg = jax_reduced(ARCH).override(dtype="float32", dropout=0.0)
    jlm = jax_build_model(jcfg.with_ffn(dataclasses.replace(jcfg.ffn, impl="ragged")))
    jopt = JaxOptimizerConfig(total_steps=STEPS)
    jstate = jax_init_train_state(jlm, jax.random.PRNGKey(0), jopt, use_mems=True, batch=B)
    lm = build_model(case_config(cases[0]))
    as_port = lambda tree: from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                                           lm.cfg, device="cpu")
    save_tree(out / "sort_init.npz", as_port(jstate["params"]))
    jstep, jlosses = jax.jit(jax_make_train_step(jlm, jopt)), []
    for tokens in batches:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)}, jax.random.PRNGKey(1))
        jlosses.append(float(jm["loss"]))
    reference = (jlosses, as_port(jstate["params"]))
    for case in cases[1:]:
        save_tree(out / f"{case['name']}_init.npz", build_model(case_config(case)).init(
            torch.Generator().manual_seed(0), device="cpu"))

    run_ranks(train_body, 4, out, str(out),
              cases + [dict(name="cli", cli=CLI + ["--mesh", "2x2"])])
    results = {"reference": reference,
               "cli": ([json.loads((out / f"cli_rank{r}.json").read_text())
                        for r in range(4)], train_cli.main(CLI + ["--mesh", "1x1"]))}
    for case in cases:
        ranks = [dict(json.loads((out / f"{case['name']}_rank{r}.json").read_text()),
                      params=np.load(out / f"{case['name']}_rank{r}.npz")) for r in range(4)]
        results[case["name"]] = (ranks, run_case(case, out))
    return results


def _gathered(ranks):
    """Every parameter of the mesh run by path: expert shards concatenated
    in model order (from the data-0 ranks), replicated leaves from rank 0
    after checking they are the same bits on every rank."""
    model = sorted((r for r in ranks if r["coords"]["data"] == 0),
                   key=lambda r: r["coords"]["model"])
    out = {}
    for key in ranks[0]["params"].files:
        if key in ranks[0]["marks"]:
            out[key] = np.concatenate([r["params"][key] for r in model])
        else:
            for r in ranks[1:]:
                np.testing.assert_array_equal(r["params"][key], ranks[0]["params"][key])
            out[key] = ranks[0]["params"][key]
    return out


def _check(name, runs):
    ranks, (losses, norms, error, params, _) = runs[name]
    assert error is None and all(r["error"] is None for r in ranks)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(r["norms"], norms, rtol=1e-5, err_msg=name)
    got, want = _gathered(ranks), tree_arrays(params)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=2e-4, rtol=2e-4, err_msg=f"{name} {key}")
    return ranks, got


def test_sort_dispatch_matches_one_process_and_the_reference(runs):
    ranks, got = _check("sort", runs)
    jlosses, jparams = runs["reference"]
    np.testing.assert_allclose(ranks[0]["losses"], jlosses, rtol=1e-5)
    for key, w in tree_arrays(jparams).items():
        np.testing.assert_allclose(got[key], w, atol=2e-4, rtol=2e-4, err_msg=key)


def test_shard_map_steps_match_one_process(runs):
    ranks, _ = _check("shard_map", runs)
    # each rank holds 2 of the 4 experts of every layer's we1 and we2
    assert len(ranks[0]["marks"]) == 2 * 3
    for r in ranks:
        assert all(r["params"][key].shape[0] == 2 for key in r["marks"])


def test_sbase_and_noisy_topk_steps_match_one_process(runs):
    _check("sbase", runs)
    _check("noisy_topk", runs)


def test_grad_accum_steps_match_one_process(runs):
    _check("grad_accum", runs)


def test_capacity_dispatch_raises_on_four_ranks(runs):
    ranks, (losses, _, error, _, _) = runs["einsum"]
    assert error is None and len(losses) == STEPS        # one process trains
    for r in ranks:
        assert r["losses"] == [] and "queue 1 item 8" in r["error"]


def test_cli_mesh_trains_as_one_process(runs):
    """The trainer under ``--mesh 2x2`` on 4 ranks against ``--mesh 1x1`` in
    one process, the same seed: bf16 and dropout 0.1 as the reduced
    config has them (dropout drawn for the global batch), so the losses
    are held to bf16's 1e-2."""
    ranks, one = runs["cli"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-2)
