#!/usr/bin/env python3
"""The logit gaps where K7 and its plain version pick different tokens in
``chip_smoke.py``'s phase 17 bf16 gate, on one CUDA card.

    python3 scripts/phase17_argmax_gap.py [--seed 0] [--served 8]

Phase 17 holds granite-moe-3b-a800m's bf16 prefill at depth 2 (600 random
tokens in chunks of 256 on the paged cache) with K7 against the plain
versions of the kernels, on the same expert choices. Phase 17 now draws its
prompt from a generator of its own; it used to draw it from serve-long's,
after serve-long's ``--served`` prompts of 3,500 tokens and the profiled
chunk's 256 tokens. This script draws that older prompt again, runs the
gate's two prefills and prints, for every row whose argmax differs, the
reference's two largest logits, the gap max(want) - want[argmax(got)] that
``chip_smoke.argmax_agrees`` holds to tol (1 + |max(want)|), and the bf16
spacing at that magnitude.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--served", type=int, default=8,
                    help="serve-long's prompts drawn before the gate's prompt")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import routing
    from repro_torch.kernels import build, cvmm as K
    from repro_torch.models import LM

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build()
    cfg = get_config(cs.LONG["arch"])
    cfg = cfg.with_ffn(dataclasses.replace(cfg.ffn, dispatch="sort")).override(n_layers=2)
    chunk, ps, vocab = cs.LONG["prefill_chunk"], cs.LONG["page_size"], cfg.vocab_size
    rng = np.random.default_rng(args.seed)
    for _ in range(args.served):
        rng.integers(1, vocab, size=cs.LONG["prompt"])
    rng.integers(1, vocab, size=(1, chunk))
    prompt = rng.integers(1, vocab, size=600).tolist()
    lm = LM(cfg)
    params = lm.serving_params(lm.init(torch.Generator(device=dev).manual_seed(args.seed + 1),
                                       device=dev))
    choices = []
    with cs.pinned_routing(routing, choices, replay=False):
        got = cs._paged_prefill_logits(lm, params, prompt, chunk, ps, dev)
    with cs.plain_kernels(K), cs.pinned_routing(routing, choices, replay=True):
        want = cs._paged_prefill_logits(lm, params, prompt, chunk, ps, dev)
    tol = cs.E2E_TOL["bfloat16"]
    rows = []
    for i, (g, w) in enumerate(zip(got, want)):
        ok, err, rel, _ = cs.close(g, w, tol, "bfloat16", ulps=False)
        agrees, flipped, gap = cs.argmax_agrees(g, w, tol)
        top_w, top_g = w[0].topk(2), g[0].topk(2)
        entry = {"chunk": i, "max_abs_err": err, "normwise": rel, "close": ok,
                 "argmax_got": top_g.indices.tolist(), "argmax_want": top_w.indices.tolist(),
                 "want_top2": top_w.values.tolist(), "got_top2": top_g.values.tolist(),
                 "flipped": flipped, "gap": gap,
                 "limit": tol * (1 + top_w.values[0].abs().item()),
                 "bf16_spacing": cs.bf16_ulp(top_w.values[0].abs().item()),
                 "agrees_within_tol": agrees}
        rows.append(entry)
        print(f"chunk {i}: max_abs_err {err:.4g}, normwise {rel:.4g}, close {ok}; argmax got "
              f"{entry['argmax_got'][0]}, want {entry['argmax_want'][0]}; want's top two "
              f"{top_w.values.tolist()}, got's top two {top_g.values.tolist()}; gap "
              f"max(want) - want[argmax(got)] {gap:.4g} (bf16 spacing at max(want) "
              f"{entry['bf16_spacing']:.4g}, limit {entry['limit']:.4g}): agrees {agrees}")
    print(json.dumps({"seed": args.seed, "served": args.served, "chunks": rows}))


if __name__ == "__main__":
    main()
