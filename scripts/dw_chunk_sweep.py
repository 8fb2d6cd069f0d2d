#!/usr/bin/env python3
"""Time K3 (``dw_streamed``) and K5 (``cvmm_dw``) on one CUDA card for
several chunk sizes of their split over row tiles (``kernels.cvmm.DW_CHUNK``).

    python3 scripts/dw_chunk_sweep.py [--chunks 3 4 5 6 8] [--seed 0]

At wt103-47m-moe's training shape (batch 32 x 257 tokens, top-4 of 16
experts, d_model 412, expert size 128, bf16), on a uniform plan and on a
skewed one (the busiest expert about 1.6x the mean rows), each kernel's
device time alone (``chip_smoke._device_ms``), checked against its plain
version first. Prints one line per (plan, chunk) and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, nargs="+", default=[3, 4, 5, 6, 8])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from chip_smoke import _device_ms
    from repro_torch.kernels import cvmm as K, ops

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    n, k, E, d, G = 32 * 257, 4, 16, 412, 128
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    uniform = torch.argsort(torch.rand((n, E), generator=gen, device=dev), dim=1)[:, :k]
    weights = torch.linspace(3.0, 0.5, E, device=dev).expand(n, E).contiguous()
    skewed = torch.multinomial(weights, k, replacement=False, generator=gen)
    x = ops._pad_lane(torch.randn((n, d), generator=gen, device=dev), 1).bfloat16()
    dy = ops._pad_lane(torch.randn((n, d), generator=gen, device=dev), 1).bfloat16()
    for pname, idx in (("uniform", uniform), ("skewed", skewed)):
        p = ops.make_moe_plan(idx, E, torch.rand((n, k), generator=gen, device=dev))
        rs, te, gate = p.row_src, p.tile_expert, p.gate_tiles.reshape(-1)
        valid = (rs < n)[:, None]
        u = (torch.randn((p.m_pad, G), generator=gen, device=dev) * 0.05).bfloat16()
        dh = (torch.randn((p.m_pad, G), generator=gen, device=dev) * 0.05).bfloat16()
        xg, dyg = K.gather_rows_plain(x, rs), K.gather_rows_plain(dy, rs)
        cases = {
            "K3 dW1": (K.dw_streamed, K.dw_streamed_plain, (x, dh, rs, te, E),
                       dict(stream_x=True)),
            "K3 dW2": (K.dw_streamed, K.dw_streamed_plain, (u, dy, rs, te, E),
                       dict(stream_x=False)),
            "K3 dW2 gated": (K.dw_streamed, K.dw_streamed_plain, (u, dy, rs, te, E),
                             dict(stream_x=False, gate=gate)),
            "K5 dW1": (K.cvmm_dw, K.cvmm_dw_plain, (xg, te, dh * valid, E), {}),
            "K5 dW2": (K.cvmm_dw, K.cvmm_dw_plain, (u * valid, te, dyg, E), {}),
        }
        rows = p.group_sizes.float()
        print(f"plan {pname}: busiest expert {rows.max() / rows.mean():.2f}x the mean rows")
        saved = K.DW_CHUNK
        try:
            for chunk in args.chunks:
                K.DW_CHUNK = chunk
                line = []
                for name, (fn, plain, a, kw) in cases.items():
                    err = (fn(*a, **kw) - plain(*a, **kw)).abs().max().item()
                    if err > 1e-4:
                        sys.exit(f"{name}, chunk {chunk}: max_abs_err {err:.3g} > 1e-4")
                    line.append(f"{name} {_device_ms(lambda: fn(*a, **kw)):.4f}")
                print(f"{pname} chunk {chunk} ({K.dw_split(p.m_pad // 128, E, chunk)[0]} "
                      f"items an output block), device ms: " + ", ".join(line), flush=True)
        finally:
            K.DW_CHUNK = saved


if __name__ == "__main__":
    main()
