"""The port's expert-parallel dispatch (``dispatch="shard_map"``) on 4 gloo
ranks on the CPU, against the reference. On meshes 2x2 and 1x4, with and
without GLU experts, at a capacity that drops (factor 0.5) and one that
does not (4.0 = E/k): each rank's output and the gradients of its tokens,
gates and expert shard against the reference's pure-JAX ``_einsum_path``
applied to each rank's token block (the math of its ``_shard_map_path``),
the blocks' outputs concatenated and the expert gradients summed over
them; where nothing drops, also against the reference's ``_sort_path`` on
all tokens. The cases spread over the shard's rungs: "ragged" (the CPU's
"auto"), "pallas" (the K4/K5 Function on the kernels' plain versions) and
the einsum rung. float32; tolerances 1e-5 for outputs, 2e-4 for
gradients. Also: ``ep_local_plan`` through the plan checker (and a planted
bad EP plan found), ``ep_plan_stats`` against the reference's with a
stand-in mesh, and ``ep_degree``'s padding against the reference's
parameter shapes. The ranks run ``tests/torch_mesh_ranks.py``."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import moe_ffn as jax_moe_ffn
from repro.core import dispatch as jdispatch
from repro.core.routing import SelectionInfo as JaxSelectionInfo
from repro.models.registry import build_model as jax_build_model
from repro_torch.analysis.plans import check_plans, verify_plan
from repro_torch.common import map_leaves
from repro_torch.configs import get_config, moe_ffn
from repro_torch.core import dispatch
from repro_torch.models import build_model
from torch_mesh_ranks import ep_dispatch_body, run_ranks

N, D, E, G, K = 64, 32, 8, 16, 2
CASES = [dict(name=f"{m[0]}x{m[1]}-{'glu' if glu else 'relu'}-{factor}", mesh=m, glu=glu,
              factor=factor, impl=impl)
         for (m, glu, factor, impl) in [((2, 2), False, 0.5, "auto"),
                                        ((2, 2), False, 4.0, "pallas"),
                                        ((2, 2), True, 0.5, "pallas"),
                                        ((2, 2), True, 4.0, "einsum"),
                                        ((1, 4), False, 0.5, "einsum"),
                                        ((1, 4), False, 4.0, "auto"),
                                        ((1, 4), True, 0.5, "auto"),
                                        ((1, 4), True, 4.0, "pallas")]]


def _inputs(seed, glu):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    # distinct experts a token, skewed toward the low ones so 0.5 drops
    idx = np.argsort(rng.random((N, E)) + np.linspace(0, 1.5, E), axis=1)[:, :K]
    gates = rng.uniform(0.1, 1.0, (N, K)).astype(np.float32)
    ws = {"we1": rng.standard_normal((E, D, G)) * D ** -0.5,
          "we2": rng.standard_normal((E, G, D)) * G ** -0.5}
    if glu:
        ws["we1g"] = rng.standard_normal((E, D, G)) * D ** -0.5
    cot = rng.standard_normal((N, D)).astype(np.float32)
    return dict(x=x, idx=idx.astype(np.int32), gates=gates, cot=cot,
                **{k: v.astype(np.float32) for k, v in ws.items()})


def _reference(path, data, jcfg, blocks):
    """The reference's path on each token block, under ``jax.jit``: (y,
    dropped per block, dx, dgates, expert gradients summed over the
    blocks)."""
    names = sorted(k for k in data if k.startswith("we"))
    n = N // blocks

    def run(x, g, idx, cot, *w):
        out = path(dict(zip(names, w)), x, jcfg, JaxSelectionInfo(None, None, idx, g), E)
        y, dropped = out if isinstance(out, tuple) else (out, jnp.float32(0.0))
        return jnp.sum(y * cot), (y, dropped)

    grad = jax.jit(jax.value_and_grad(run, argnums=(0, 1, *range(4, 4 + len(names))),
                                      has_aux=True))
    ys, drops, dxs, dgs, dws = [], [], [], [], []
    for b in range(blocks):
        rows = slice(b * n, (b + 1) * n)
        (_, (y, dropped)), grads = grad(data["x"][rows], data["gates"][rows],
                                        data["idx"][rows], data["cot"][rows],
                                        *(data[k] for k in names))
        ys.append(np.asarray(y))
        drops.append(float(dropped))
        dxs.append(np.asarray(grads[0]))
        dgs.append(np.asarray(grads[1]))
        dws.append({k: np.asarray(g) for k, g in zip(names, grads[2:])})
    return (np.concatenate(ys), drops, np.concatenate(dxs), np.concatenate(dgs),
            {k: sum(d[k] for d in dws) for k in names})


def test_shard_map_matches_reference_per_block(tmp_path):
    want = {}
    for i, case in enumerate(CASES):
        data = _inputs(i, case["glu"])
        np.savez(tmp_path / f"{case['name']}_in.npz", **data)
        kw = dict(capacity_factor=case["factor"], glu_experts=case["glu"],
                  activation="silu" if case["glu"] else "relu")
        jcfg = jax_moe_ffn(E, G, K, dispatch="einsum", **kw)
        want[case["name"]] = [_reference(jdispatch._einsum_path, data, jcfg, 4)]
        if case["factor"] == 4.0:
            scfg = jax_moe_ffn(E, G, K, dispatch="sort", impl="ragged", **kw)
            want[case["name"]].append(_reference(jdispatch._sort_path, data, scfg, 1))
    run_ranks(ep_dispatch_body, 4, tmp_path, str(tmp_path), CASES)

    for case in CASES:
        mp = case["mesh"][1]
        ranks = [np.load(tmp_path / f"{case['name']}_rank{r}.npz") for r in range(4)]
        y = np.concatenate([r["y"] for r in ranks])
        dx = np.concatenate([r["dx"] for r in ranks])
        dgates = np.concatenate([r["dgates"] for r in ranks])
        names = [k for k in ("we1", "we1g", "we2") if f"d{k}" in ranks[0].files]
        # expert shard m is held by the ranks of model coordinate m; sum its
        # data rows' gradients, then lay the shards out in expert order
        dw = {k: np.concatenate([sum(ranks[r][f"d{k}"] for r in range(m, 4, mp))
                                 for m in range(mp)]) for k in names}
        for r in ranks:
            assert r["calls"][0] == 4                 # 2 all_to_alls forward, 2 backward
        for i, (wy, wdrops, wdx, wdg, wdw) in enumerate(want[case["name"]]):
            msg = f"{case['name']} against {'sort' if i else 'einsum per block'}"
            np.testing.assert_allclose(y, wy, atol=1e-5, rtol=1e-5, err_msg=msg)
            if i == 0:
                drops = float(ranks[0]["dropped"])
                assert all(float(r["dropped"]) == drops for r in ranks)
                np.testing.assert_allclose(drops, np.mean(wdrops), rtol=1e-6, err_msg=msg)
                assert (drops > 0) == (case["factor"] == 0.5), msg
            for name, got, w in [("x", dx, wdx), ("gates", dgates, wdg)] + [
                    (k, dw[k], wdw[k]) for k in names]:
                np.testing.assert_allclose(got, w, atol=2e-4, rtol=2e-4,
                                           err_msg=f"{msg}: d{name}")


def test_ep_plans_through_the_checker_and_stats_as_the_reference():
    """``ep_local_plan`` passes ``verify_plan`` for the reference's EP cases
    and ``check_plans`` sweeps them; ``ep_plan_stats`` (which verifies its
    plan) gives the reference's ``e_local``, ``capacity``,
    ``rows_per_shard`` and row count on a stand-in mesh."""
    for e_local, cap_g in ((2, 256), (4, 128), (1, 384), (3, 64)):
        assert verify_plan(dispatch.ep_local_plan(e_local, cap_g, device="cpu"),
                           e_local * cap_g) == []
    findings, checks = check_plans()
    assert findings == [] and checks >= 48
    cfg, jcfg = moe_ffn(16, 128, 4, dispatch="shard_map"), jax_moe_ffn(16, 128, 4,
                                                                      dispatch="shard_map")
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2}, axis_names=("data", "model"))
    got = dispatch.ep_plan_stats(cfg, 1024, 16, mesh, device="cpu")
    want = jdispatch.ep_plan_stats(jcfg, 1024, 16, mesh)
    for key in ("e_local", "capacity", "rows_per_shard", "per_row"):
        assert got[key] == want[key], (key, got, want)
    assert (got["e_local"], got["capacity"], got["rows_per_shard"]) == (8, 80, 1280)


def test_planted_bad_ep_plan_is_found():
    """A shard plan whose slots mix two experts in one row tile, or whose
    slack slot reads a real row, is flagged."""
    plan = dispatch.ep_local_plan(3, 64, device="cpu")
    te = plan.tile_expert.clone()
    te[0] = 1                                    # expert 0's tile now expert 1's
    found = verify_plan(dataclasses.replace(plan, tile_expert=te), 3 * 64)
    assert found, "a tile that is no longer expert-pure passed"
    rs = plan.row_src.clone()
    slack = int(np.setdiff1d(np.arange(plan.m_pad), plan.new_pos.numpy())[0])
    rs[slack] = 0
    assert verify_plan(dataclasses.replace(plan, row_src=rs), 3 * 64)


def test_ep_degree_pads_experts_as_the_reference():
    """16 experts on a model axis of 3 give 18; every parameter shape equals
    the reference's (``jax.eval_shape`` of its init), the router's 16
    columns included."""
    jlm = jax_build_model(jax_get_config("wt103-47m-moe"), ep_degree=3)
    jshapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    lm = build_model(get_config("wt103-47m-moe"), ep_degree=3)
    params = lm.init(torch.Generator().manual_seed(0), device="meta")
    moe = params["stack"]["segments"][0]["e0"][0]["ffn"]
    assert moe["we1"].shape[0] == moe["we2"].shape[0] == 18
    assert moe["router"].shape == (412, 16)
    layers = jshapes["stack"]["segments"][0]["e0"]["ffn"]
    for name, leaf in moe.items():
        assert leaf.shape == tuple(layers[name].shape[1:]), name
    # the reference stacks the layers; every layer's shapes match
    seen = map_leaves(params["stack"], lambda path, t: tuple(t.shape))
    assert len(seen["segments"][0]["e0"]) == layers["we1"].shape[0]
