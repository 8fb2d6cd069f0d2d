"""Train a language model with the port, on one device or on a mesh of
ranks.

    python -m repro_torch.launch.train --arch wt103-47m-moe --steps 30 \
        --batch 32 --seq 256 [--ffn KIND] [--reduced] [--device cpu] \
        [--mesh DATAxMODEL] [--data synthetic|/path/corpus] [--grad-accum N] \
        [--grad-compression none|bf16|int8] [--remat none|dots|full] \
        [--ckpt-dir DIR [--ckpt-every N] [--keep N] [--resume]]

The reference's ``launch/train.py``: the same optimizer
(AdamW, cosine schedule over ``--steps``, clipping at 0.25), the same data
for a seed (the synthetic stream, or ``seq + 1``-byte windows of a local
byte corpus; ``--seq`` next-token targets a row), and XL memories carried
across steps. ``--grad-accum N`` splits each batch into N microbatches
whose float32 gradients are averaged, with the XL memories sized for one
microbatch (``batch / N`` rows) and carried from each to the next, as the
reference's scan carries them; ``--grad-compression`` sends the clipped
gradient through bf16 or int8 with error feedback
(``optim.compress_grads``); ``--remat`` recomputes each block in the
backward ("full"), or all but its matrix products ("dots"). Parameters
come from ``--seed``, dropout from ``--seed + 1``. Every step's loss is
printed with its wall time (the step ends in a host read of the loss); a
straggler monitor flags slow steps; kernel launches per step are printed
once at the end.

Fault tolerance, as in the reference: with ``--ckpt-dir``, every state leaf
(parameters, AdamW moments and step, compression residuals, XL memories,
the data iterator's state and the dropout generator's state) goes into
one atomic checkpoint after every ``--ckpt-every`` steps (async) and
after the last (blocking); ``--resume`` restarts from the latest
committed one, bit for bit where the device's arithmetic is
deterministic. The port draws dropout from one stateful
``torch.Generator`` (the reference folds the step into a pure
key), so its state is part of the checkpoint. Unlike the reference, the
port writes no checkpoint without ``--ckpt-dir``. ``--fail-at-step``
raises at that step, after waiting for a save in flight, to test restarts.

``--ffn`` swaps the arch's FFN to another kind by the reference's widths
rule (``models.build_model(ffn=)``): "sigma_moe", "topk", "pkm", "dense"
or "glu". The top-K MLP's and PKM's value sums run K6 on CUDA, forward and
backward (``ops.gathered_weighted_sum_dedup``). A swap to "sigma_moe"
gives the reference's config, with the capacity ("einsum") dispatch,
whose batched products are library GEMMs (no kernel of the port).

The expert MLPs run on the sort path's rung for the device: the fused
kernels on CUDA (K1, K2; backward K1, K3, K4). As in the reference, which
has no flag for it, the unfused planned rung (K4 forward; K4 and K5
backward) is pinned around the call instead:

    ops.set_default_impl("pallas")      # repro_torch.kernels.ops
    try:
        main([...])
    finally:
        ops.set_default_impl(None)

``--mesh DATAxMODEL`` (default ``1x1``) trains on a mesh of that many ranks,
one process a device, started by ``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --mesh 2x2 ...

Every rank reads the same global batch and takes its rows of it; the
gradients are all-reduced (``runtime/steps.py``), so the run computes one
process's steps on the global batch. The experts are padded to a multiple
of the "model" axis, as in the reference; they are sharded over it under
``dispatch="shard_map"`` (explicit expert parallelism, which no ``--arch``
selects: build such a config in process) and replicated under the sort
dispatch. Only rank 0 prints. ``--mesh 1x1`` without a launcher is a mesh
of one rank without a process group, and computes what one device does.
Not ported: the pod tier (``--mesh PODxDATAxMODEL`` with pod > 1),
checkpoints on more than one rank, and the capacity dispatch (``--ffn
sigma_moe``) on more than one rank, which raises (ROADMAP.md, queue 1
item 8).
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Dict, List, Optional


def _checkpoint_tree(state: Dict, gen) -> Dict:
    """Every state leaf of a run, as one tree."""
    opt = state["opt"]
    tree = {"params": state["params"],
            "opt": {"step": opt.step, "mu": opt.mu, "nu": opt.nu},
            "rng": gen.get_state()}
    for key in ("err", "mems"):
        if key in state:
            tree[key] = state[key]
    return tree


def _state_from_tree(tree: Dict, gen) -> Dict:
    """The train state of a restored tree; sets ``gen`` to its state."""
    from ..optim import OptState
    gen.set_state(tree["rng"])
    opt = tree["opt"]
    state = {"params": tree["params"],
             "opt": OptState(step=opt["step"], mu=opt["mu"], nu=opt["nu"])}
    for key in ("err", "mems"):
        if key in tree:
            state[key] = tree[key]
    return state


def main(argv: Optional[List[str]] = None, eval_batches: int = 0) -> Dict:
    """Train; returns the run's numbers (per step: loss, wall time, kernel
    launches, and the dropped share of the (token, expert) pairs summed
    over the MoE layers) and its final state. With
    ``eval_batches``, also the eval step's losses and cross-entropies on
    that many held-out batches (the data stream of ``--seed + 1000``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="wt103-47m-moe")
    ap.add_argument("--ffn", default=None,
                    help="swap FFN kind (sigma_moe|topk|pkm|dense|glu)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config of the arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2.5e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic', or the path of a local byte corpus")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (no checkpoints without it)")
    ap.add_argument("--ckpt-every", type=int, default=100,
                    help="save after every N steps (0 = only the final save)")
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--resume", action="store_true",
                    help="restart from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="TESTING: raise at this step to exercise restart")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL, e.g. 2x2: one rank a device, under "
                         "torch.distributed.run")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .mesh import MESH_AXIS_LAYOUTS, make_mesh

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")
    if args.resume and args.ckpt_dir is None:
        raise SystemExit("--resume needs --ckpt-dir")
    shape = tuple(int(x) for x in args.mesh.split("x"))
    if len(shape) not in (2, 3):
        raise SystemExit(f"--mesh {args.mesh}: give DATAxMODEL")
    if len(shape) == 3 and shape[0] > 1:
        raise SystemExit(f"--mesh {args.mesh}: the pod tier (pod > 1) is not ported "
                         "(ROADMAP.md, queue 1 item 8)")
    ranks = math.prod(shape)
    if ranks > 1 and args.ckpt_dir is not None:
        raise SystemExit("--ckpt-dir on more than one rank is not ported (ROADMAP.md, "
                         "queue 1 item 8)")
    if args.grad_accum < 1 or args.batch % (args.grad_accum * ranks):
        raise SystemExit(f"--batch {args.batch} does not split into --grad-accum "
                         f"{args.grad_accum} microbatches over {ranks} ranks")
    started = not dist.is_initialized()
    mesh = make_mesh(shape, MESH_AXIS_LAYOUTS[len(shape) - 2], device=dev)
    try:
        return _train(args, mesh, eval_batches)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, mesh, eval_batches: int) -> Dict:
    """``main``'s run on ``mesh`` (this rank's part of it)."""
    import torch

    from ..checkpoint import CheckpointManager
    from ..common import map_leaves, tree_leaves
    from ..configs import OptimizerConfig, get_config, reduced
    from ..convert import is_expert_shard
    from ..core.dispatch import expert_shards
    from ..data import DataIterator, make_dataset
    from ..kernels import cvmm as K
    from ..models import build_model
    from ..runtime import (StragglerMonitor, init_train_state, make_eval_step,
                           make_train_step)

    dev = mesh.device
    log = print if mesh.index == 0 else (lambda *a, **k: None)
    cfg = reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, ffn=args.ffn, remat=args.remat,
                        ep_degree=mesh.shape["model"])
    cfg = model.cfg
    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                              grad_accum=args.grad_accum,
                              grad_compression=args.grad_compression)
    train_step = make_train_step(model, opt_cfg, grad_accum=args.grad_accum, mesh=mesh)
    ds = make_dataset(args.data, cfg.vocab_size)
    it = DataIterator(ds, args.batch, args.seq + 1, seed=args.seed)
    # The memories of one microbatch (this rank's rows of it): the reference
    # sizes them for the whole batch, on which its scan over microbatches
    # fails.
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(args.seed),
                             opt_cfg, use_mems=bool(cfg.xl_memory),
                             batch=args.batch // args.grad_accum // mesh.size, device=dev,
                             mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    shards = expert_shards(cfg.ffn, mesh)
    n_params = sum(tree_leaves(map_leaves(state["params"], lambda path, p: p.numel() * (
        shards if is_expert_shard(path) else 1))))
    log(f"[train] {cfg.name}{' (reduced)' if args.reduced else ''}: "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, ffn {cfg.ffn.kind}, "
        f"{n_params / 1e6:.2f} M "
        f"params, {model.dtype} compute; batch {args.batch} x seq {args.seq} "
        f"on {dev}; mesh {mesh.shape}; data {args.data}; grad accum {args.grad_accum}, "
        f"compression {args.grad_compression}, remat {args.remat}", flush=True)

    mgr = (CheckpointManager(args.ckpt_dir, keep=args.keep)
           if args.ckpt_dir is not None else None)
    start_step = 0
    if args.resume:
        restored, extra = mgr.restore(_checkpoint_tree(state, gen))
        if restored is not None:
            state = _state_from_tree(restored, gen)
            del restored
            start_step = int(extra["step"])
            it.restore(extra["data"])
            log(f"[resume] restored step {start_step}", flush=True)
    mon = StragglerMonitor(on_straggler=lambda s, dt, mu: log(
        f"[straggler] step {s}: {dt:.3f}s vs mean {mu:.3f}s", flush=True))

    losses, times, launches, dropped = [], [], [], []
    t_start = time.perf_counter()
    try:
        for step in range(start_step, args.steps):
            if step == args.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = {k: torch.as_tensor(v, device=dev) for k, v in it.next().items()}
            before = dict(K.LAUNCHES)
            mon.start()
            state, metrics = train_step(state, batch, gen)
            loss = float(metrics["loss"])
            times.append(mon.stop(step))
            losses.append(loss)
            launches.append({k: K.LAUNCHES[k] - before[k] for k in before})
            dropped.append(metrics["moe_dropped"])
            if step % args.log_every == 0 or step == args.steps - 1:
                log(f"step {step:5d} loss {loss:.4f} lr {metrics['lr']:.2e} "
                    f"gnorm {float(metrics['grad_norm']):.3f} {times[-1]:.3f}s",
                    flush=True)
            if mgr is not None and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, _checkpoint_tree(state, gen),
                         extra={"data": it.state()})
    except BaseException:
        # Preemption/crash path: a save started before the failure must
        # still commit, or "loses at most ckpt_every steps" does not hold.
        if mgr is not None:
            mgr.wait()
        raise
    if mgr is not None:
        mgr.save(args.steps, _checkpoint_tree(state, gen), extra={"data": it.state()},
                 blocking=True)
    total = time.perf_counter() - t_start
    tokens = args.batch * args.seq
    n_steps = args.steps - start_step
    log(f"[done] {n_steps} steps in {total:.1f}s; "
        f"{tokens * n_steps / max(total, 1e-9):.0f} tokens/s; "
        f"stragglers={len(mon.flagged)}", flush=True)
    if any(any(v.values()) for v in launches):
        log(f"[launches per step] {launches[-1]}", flush=True)
    out = {"losses": losses, "step_s": times, "launches": launches,
           "moe_dropped": [float(x) for x in dropped],
           "tokens_per_step": tokens, "n_params": n_params, "start_step": start_step,
           "stragglers": list(mon.flagged), "state": state}
    if eval_batches:
        eval_step = make_eval_step(model, mesh)
        held_out = DataIterator(ds, args.batch, args.seq + 1, seed=args.seed + 1000)
        evals = [eval_step(state["params"], {"tokens": torch.as_tensor(
            held_out.next()["tokens"], device=dev)}) for _ in range(eval_batches)]
        out["eval_losses"] = [float(loss) for loss, _ in evals]
        out["eval_ce"] = [float(m["ce"]) for _, m in evals]
        log(f"[eval] {eval_batches} held-out batches: loss {out['eval_losses']}",
            flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
