"""Rank bodies of the port's mesh tests (``tests/test_torch_mesh*.py``,
``tests/test_torch_ep_dispatch.py``), and ``run_ranks``, which starts them.

Each body runs in a process of its own, one gloo rank on the CPU, joined
through a ``file://`` store in the test's ``tmp_path`` (no TCP port, so
xdist workers cannot clash). The bodies import torch, numpy and the port
only; the tests compute the reference's side before the ranks start and
pass inputs and outputs as ``.npy``/``.npz`` files.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def _entry(rank, world, store, body, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        body(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(body, world: int, tmp_path: Path, *args, timeout: float = TIMEOUT_S) -> None:
    """``body(rank, world, *args)`` on ``world`` gloo ranks; raises if a rank
    raised, and kills them all and raises after ``timeout`` seconds."""
    ctx = mp.start_processes(_entry, args=(world, str(tmp_path / "store"), body, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(5)


def tree_arrays(tree) -> dict:
    """The leaves of a port tree as numpy arrays, keyed by their paths."""
    from repro_torch.common import map_leaves
    out = {}
    map_leaves(tree, lambda path, t: out.setdefault("/".join(map(str, path)),
                                                    t.detach().numpy()))
    return out


def save_tree(path: Path, tree) -> None:
    np.savez(path, **tree_arrays(tree))


def load_tree(path: Path, template):
    """A tree shaped like ``template`` with the leaves ``save_tree`` wrote."""
    from repro_torch.common import map_leaves
    arrays = np.load(path)
    return map_leaves(template, lambda p, t: torch.from_numpy(
        np.array(arrays["/".join(map(str, p))])))


# ----------------------------------------------------------- the mesh itself

def local_mesh_body(rank, world, out):
    """make_local_mesh(model=2): shapes, coords, each group's members (an
    all-reduce of 2**rank over it), axis_size under mesh_context; then
    model=3, which must raise."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import all_reduce_, axis_size, current_mesh, mesh_context

    mesh = make_local_mesh(model=2, device="cpu")
    members = {}
    for axes in (("model",), ("data",), ()):
        bit = torch.tensor([2.0 ** rank], dtype=torch.float64)
        members["+".join(axes) or "all"] = int(all_reduce_(bit, mesh.group(*axes)).item())
    with mesh_context(mesh):
        sizes = {a: axis_size(a) for a in ("data", "model", "pod")}
        inside = current_mesh() is mesh
    try:
        make_local_mesh(model=3, device="cpu")
        error = None
    except ValueError as e:
        error = str(e)
    Path(out, f"rank{rank}.json").write_text(json.dumps({
        "shape": mesh.shape, "coords": mesh.coords, "index": mesh.index,
        "members": members, "sizes": sizes, "inside": inside,
        "outside": current_mesh() is None, "error": error}))


def collectives_body(rank, world, out):
    """all_to_all, all_reduce_sum and pmean forward and backward on two
    ranks, their call counts, and the batch reductions under a mesh."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import (CALLS, all_reduce_sum, all_to_all, batch_count,
                                      batch_logsumexp, batch_mean, batch_sum, global_draw,
                                      mesh_context, pmean, reset_call_counts)

    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    group = mesh.group("model")
    base = torch.arange(8, dtype=torch.float64).reshape(4, 2)
    x = (base + 100 * rank).requires_grad_()
    reset_call_counts()
    y = all_to_all(x, group)
    peer = base + 100 * (1 - rank)
    want = (torch.cat([base[:2] + 100 * 0, peer[:2]]) if rank == 0
            else torch.cat([peer[2:], base[2:] + 100]))
    assert torch.equal(y.detach(), want), (rank, y)
    cot = torch.full((4, 2), float(rank + 1), dtype=torch.float64) * torch.arange(
        1, 5, dtype=torch.float64)[:, None]
    y.backward(cot)
    # backward: rank r's chunk j of cot goes back to rank j as its chunk r
    own = cot[:2] if rank == 0 else cot[2:]
    other = (torch.full((4, 2), float(2 - rank), dtype=torch.float64)
             * torch.arange(1, 5, dtype=torch.float64)[:, None])
    back = torch.cat([own, other[:2]]) if rank == 0 else torch.cat([other[2:], own])
    assert torch.equal(x.grad, back), (rank, x.grad, back)
    assert CALLS == {"all_to_all": 2, "all_reduce": 0}, CALLS

    v = torch.tensor([1.0 + rank, 10.0 * rank], dtype=torch.float64, requires_grad=True)
    s = all_reduce_sum(v, group)
    assert torch.equal(s.detach(), torch.tensor([3.0, 10.0], dtype=torch.float64))
    s.backward(torch.tensor([2.0, 3.0], dtype=torch.float64))
    assert torch.equal(v.grad, torch.tensor([2.0, 3.0], dtype=torch.float64))
    w = torch.tensor([1.0 + rank, 10.0 * rank], dtype=torch.float64, requires_grad=True)
    m = pmean(w, group)
    assert torch.equal(m.detach(), torch.tensor([1.5, 5.0], dtype=torch.float64))
    m.backward(torch.tensor([2.0, 3.0], dtype=torch.float64))
    assert torch.equal(w.grad, torch.tensor([2.0, 3.0], dtype=torch.float64))
    assert CALLS == {"all_to_all": 2, "all_reduce": 2}, CALLS

    # the batch reductions: this rank's rows of a 6-row global batch
    full = torch.linspace(-2.0, 3.0, 18, dtype=torch.float64).reshape(6, 3)
    mine = full[3 * rank:3 * rank + 3]
    gen = torch.Generator().manual_seed(4)
    one = torch.rand((6, 5), generator=torch.Generator().manual_seed(4))
    with mesh_context(mesh):
        np.testing.assert_allclose(batch_mean(mine), full.mean(0), rtol=1e-12)
        np.testing.assert_allclose(batch_sum(mine, (0,)), full.sum(0), rtol=1e-12)
        np.testing.assert_allclose(batch_count(mine.sum(0)), full.sum(0), rtol=1e-12)
        np.testing.assert_allclose(batch_logsumexp(mine), torch.logsumexp(full, 0, True),
                                   rtol=1e-12)
        drawn = global_draw(lambda shape: torch.rand(shape, generator=gen), (3, 5))
    assert torch.equal(drawn, one[3 * rank:3 * rank + 3])
    Path(out, f"rank{rank}.json").write_text(json.dumps({"calls": dict(CALLS)}))


# -------------------------------------------------- the expert-parallel layer

def ep_dispatch_body(rank, world, out, cases):
    """Each case's shard_map layer on this rank's token block and expert
    shard: the output, the dropped share and the gradients of the tokens,
    the gates and the expert shard, for a cotangent of the output."""
    from repro_torch.configs import moe_ffn
    from repro_torch.convert import shard_experts
    from repro_torch.core import dispatch
    from repro_torch.core.routing import SelectionInfo
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import CALLS, mesh_context, reset_call_counts

    for case in cases:
        mesh = make_mesh(tuple(case["mesh"]), ("data", "model"), device="cpu")
        data = np.load(Path(out, f"{case['name']}_in.npz"))
        r, n = mesh.index, data["x"].shape[0] // mesh.size
        rows = slice(r * n, (r + 1) * n)
        names = [k for k in ("we1", "we1g", "we2") if k in data.files]
        full = {k: torch.from_numpy(data[k]) for k in names}
        params = {k: v.requires_grad_() for k, v in shard_experts(
            full, mesh.coords["model"], mesh.shape["model"]).items()}
        x = torch.from_numpy(data["x"][rows]).requires_grad_()
        gates = torch.from_numpy(data["gates"][rows]).requires_grad_()
        info = SelectionInfo(probs=None, sel=None,
                             idx=torch.from_numpy(data["idx"][rows]).long(), gates=gates)
        cfg = moe_ffn(full["we1"].shape[0], data["we1"].shape[2], data["idx"].shape[1],
                      dispatch="shard_map", capacity_factor=case["factor"],
                      glu_experts="we1g" in names, impl=case["impl"],
                      activation="silu" if "we1g" in names else "relu")
        reset_call_counts()
        with mesh_context(mesh):
            y, dropped = dispatch.expert_mlp(params, x, cfg, info, full["we1"].shape[0])
            (y * torch.from_numpy(data["cot"][rows])).sum().backward()
        np.savez(Path(out, f"{case['name']}_rank{rank}.npz"), y=y.detach().numpy(),
                 dropped=dropped.detach().numpy(), dx=x.grad.numpy(),
                 dgates=gates.grad.numpy(), calls=np.array(
                     [CALLS["all_to_all"], CALLS["all_reduce"]]),
                 **{f"d{k}": params[k].grad.numpy() for k in names})


# ------------------------------------------------------------- train steps

def case_config(case):
    """A train case's model config: reduced ``case["arch"]`` in float32
    without dropout, its FFN fields replaced by ``case["ffn"]``."""
    from repro_torch.configs import reduced
    cfg = reduced(case["arch"]).override(dtype="float32", dropout=0.0)
    return cfg.with_ffn(dataclasses.replace(cfg.ffn, **case["ffn"]))


def run_case(case, out, mesh=None):
    """A train case's steps on ``mesh`` (None: one process) from the full
    initial parameters the test wrote, dropout and gating noise from one
    generator: (losses, grad norms, the NotImplementedError's text or None,
    the final parameters, the expert-shard marks)."""
    from repro_torch.common import tree_leaves
    from repro_torch.configs import OptimizerConfig
    from repro_torch.convert import is_expert_shard, shard_experts
    from repro_torch.core.dispatch import expert_shards
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import make_train_step

    batches = np.load(Path(out, "batches.npy"))
    cfg = case_config(case)
    model_axis = mesh.shape["model"] if mesh is not None else 1
    lm = build_model(cfg, ep_degree=model_axis)
    params = load_tree(Path(out, f"{case['name']}_init.npz"),
                       lm.init(torch.Generator().manual_seed(0), device="cpu"))
    shards = expert_shards(cfg.ffn, mesh) if mesh is not None else 1
    if mesh is not None:
        params = shard_experts(params, mesh.coords["model"], shards)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    accum, ranks = case.get("grad_accum", 1), (mesh.size if mesh is not None else 1)
    state = {"params": params, "opt": adamw_init(params),
             "mems": lm.init_mems(batches.shape[1] // accum // ranks, device="cpu")}
    step = make_train_step(lm, OptimizerConfig(total_steps=len(batches)),
                           grad_accum=accum, mesh=mesh)
    gen = torch.Generator().manual_seed(5)
    losses, norms, error = [], [], None
    try:
        for tokens in batches:
            state, m = step(state, {"tokens": torch.from_numpy(tokens)}, gen)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    except NotImplementedError as e:
        error = str(e)
    marks = {"/".join(map(str, path)) for path in _paths(state["params"])
             if shards > 1 and is_expert_shard(path)}
    return losses, norms, error, state["params"], sorted(marks)


def _paths(tree) -> list:
    from repro_torch.common import map_leaves
    out = []
    map_leaves(tree, lambda path, t: out.append(path))
    return out


def train_body(rank, world, out, cases):
    """Each case on its mesh (``run_case``), or the trainer's CLI for a case
    with ``cli`` argv: this rank's numbers and parameters, written out."""
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_mesh

    for case in cases:
        if case.get("cli"):
            run = train_cli.main(case["cli"])
            Path(out, f"{case['name']}_rank{rank}.json").write_text(
                json.dumps({"losses": run["losses"]}))
            continue
        mesh = make_mesh(tuple(case["mesh"]), ("data", "model"), device="cpu")
        losses, norms, error, params, marks = run_case(case, out, mesh)
        Path(out, f"{case['name']}_rank{rank}.json").write_text(json.dumps(
            {"losses": losses, "norms": norms, "error": error, "marks": marks,
             "coords": mesh.coords}))
        save_tree(Path(out, f"{case['name']}_rank{rank}.npz"), params)
