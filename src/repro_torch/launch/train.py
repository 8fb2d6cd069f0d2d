"""Train a language model with the port, on one device.

    python -m repro_torch.launch.train --arch wt103-47m-moe --steps 30 \
        --batch 32 --seq 256 [--reduced] [--device cpu]

The reference's ``launch/train.py`` on a single device: the same optimizer
(AdamW, cosine schedule over ``--steps``, clipping at 0.25), the same
synthetic token stream for a seed (``--seq + 1`` tokens a row, so the model
sees ``--seq`` next-token targets), and XL memories carried across steps.
Parameters come from ``--seed``, dropout from ``--seed + 1``. Every step's
loss is printed with its wall time (the step ends in a host read of the
loss); kernel launches per step are printed once at the end.

The expert MLPs run on the sort path's rung for the device: the fused
kernels on CUDA (K1, K2; backward K1, K3, K4). As in the reference, which
has no flag for it, the unfused planned rung (K4 forward; K4 and K5
backward) is pinned around the call instead:

    ops.set_default_impl("pallas")      # repro_torch.kernels.ops
    try:
        main([...])
    finally:
        ops.set_default_impl(None)

Checkpointing, resume and multi-device meshes are not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="wt103-47m-moe")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config of the arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2.5e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--data", default="synthetic", choices=["synthetic"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..common import tree_leaves
    from ..configs import OptimizerConfig, get_config, reduced
    from ..data import DataIterator, make_dataset
    from ..kernels import cvmm as K
    from ..models import build_model
    from ..runtime import init_train_state, make_train_step

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")
    cfg = reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps)
    train_step = make_train_step(model, opt_cfg)
    it = DataIterator(make_dataset(args.data, cfg.vocab_size), args.batch,
                      args.seq + 1, seed=args.seed)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(args.seed),
                             opt_cfg, use_mems=bool(cfg.xl_memory),
                             batch=args.batch, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"[train] {cfg.name}{' (reduced)' if args.reduced else ''}: "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e6:.2f} M "
          f"params, {model.dtype} compute; batch {args.batch} x seq {args.seq} "
          f"on {dev}", flush=True)

    losses, times, launches = [], [], []
    t_start = time.perf_counter()
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in it.next().items()}
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, gen)
        loss = float(metrics["loss"])
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        launches.append({k: K.LAUNCHES[k] - before[k] for k in before})
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} lr {metrics['lr']:.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {times[-1]:.3f}s",
                  flush=True)
    total = time.perf_counter() - t_start
    tokens = args.batch * args.seq
    print(f"[done] {args.steps} steps in {total:.1f}s; "
          f"{tokens * args.steps / total:.0f} tokens/s", flush=True)
    if any(any(v.values()) for v in launches):
        print(f"[launches per step] {launches[-1]}", flush=True)
    return {"losses": losses, "step_s": times, "launches": launches,
            "tokens_per_step": tokens, "n_params": n_params}


if __name__ == "__main__":
    main()
    sys.exit(0)
