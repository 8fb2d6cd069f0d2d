#!/usr/bin/env python3
"""Time K1 (``fused_w1``), K2 (``fused_w2``), K4 (``cvmm``) and K6
(``gather_rows``), or with ``--k7`` K7 (``flash_attention``) alone, in bf16
on one CUDA card at the main paths' shapes, device alone, beside one
PyTorch call for the same function and the bound.

    python3 scripts/row_gemm_ab.py [--src DIR] [--tag NAME] [--sweep] [--k6] [--k7] [--seed 0]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (default
this checkout's), so that one call can time two trees in turns: unpack the
other tree with ``git archive`` into a directory ``.gitignore`` lists and run
this script with ``--src`` pointing there, then without, and so on. Each tree
builds its kernels into its own ``build/repro_torch/``. ``--sweep`` (this
checkout's kernels only) also times every GEMM case with its items forced
to 256, 128 and 64 columns where the call allows that width (``kernels.cvmm.
row_gemm_schedule`` replaced for the run); ``--k6`` (this checkout's only)
times every K6 case with each of 1, 2, 4 and 8 rows a block and 1, 2 and 4
vectors a lane (``kernels.cvmm.gather_rows_schedule`` replaced). ``--k7``
times K7 at serve-long's last full prefill chunk (256 rows at q_offset
3,072 over kv_len 3,328 of a 4,096-key pool) and at serve's short chunk (32
rows at q_offset 64 over kv_len 96 of 128), granite-moe's 24/8 heads of 64,
beside ``scaled_dot_product_attention`` on K/V cut to kv_len with a
lower-right causal mask and the bound (bytes, tensor operations and
exponentials at the special-function units' rate); with ``--sweep`` (this
checkout's only) also with the key tile forced to 64 and 128 keys and the
splits to 1, 2, 3, 4 and 6 (``kernels.flash_attention.flash_schedule``
replaced).

Shapes: serve-long's prefill chunk (M_pad 81,920 = 40 experts x 2,048 rows,
1,536 -> 512 and 512 -> 1,536, x_pad holding the chunk's 2,048 routed rows
of a random top-8 routing of 256 tokens), serving decode (M_pad 5,120), and
wt103-47m-moe's training step (8,224 tokens x top-4 of 16 experts, d_model
412, expert size 128): K1's forward (relu, h saved) and t0, K2's forward,
K4's dX and the unfused forward's two calls; K6 gathering granite-moe's
token rows (d_model 1,536) at decode (1, 8 and 32 tokens into 128 rows) and
at serve-long's prefill chunk (256 into 256), beside ``index_select``. Each
kernel is first held against its plain version (GEMMs 3e-2 allclose and
1e-2 normwise, K6 exactly); beside its device time the host's time to
launch one call (wrapper included) is timed too. Prints the card's name and
power limit, one line per case, and one JSON line of every number last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_S, PEAK_BF16 = 3.35e12, 989e12   # H100 SXM data sheet, 700 W
# exp2 results a second: 16 a clock on each of 132 SMs (the CUDA
# programming guide's throughput table, compute capability 9.0) at the
# 1.83 GHz that 989 TFLOP/s implies (4,096 bf16 operations an SM a clock).
EXP_PER_S = 132 * 16 * 1.83e9


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--k6", action="store_true")
    ap.add_argument("--k7", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from chip_smoke import _device_ms      # puts this checkout's src on the path
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    from repro_torch.kernels import cvmm as K, ops

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(f"[{args.tag}] repro_torch from {Path(K.__file__).parents[1]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bf = torch.bfloat16
    if args.k7:
        k7_main(args, card, dev, gen)
        return

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    cases = []     # (name, kernel fn, plain fn, library fn, bytes, flops, kind)

    # serving: the decode plan's layout, 40 experts of granite-moe-3b-a800m
    E, D, G = 40, 1536, 512
    for label, tokens in (("prefill chunk", 256), ("decode", 1)):
        plan = ops.make_decode_plan(tokens, 8, E, device=dev)
        m_pad, cap = plan.m_pad, plan.cap
        idx = torch.argsort(torch.rand((tokens, E), generator=gen, device=dev), 1)[:, :8]
        slot = ops.decode_slots(plan, idx)
        te = plan.tile_expert
        for k, n in ((D, G), (G, D)):
            x = torch.zeros((m_pad, k), dtype=bf, device=dev)
            x[slot] = rnd(slot.numel(), k)
            w = rnd(E, k, n, scale=k ** -0.5)
            cases.append((f"K4 {label} M_pad {m_pad} {k}->{n}",
                          lambda x=x, te=te, w=w: K.cvmm(x, te, w),
                          lambda x=x, te=te, w=w: K.cvmm_plain(x, te, w),
                          lambda x=x, w=w, k=k, cap=cap, e=E: torch.bmm(x.view(e, cap, k), w),
                          (x.numel() + w.numel() + m_pad * n) * 2 + te.numel() * 4,
                          2 * m_pad * k * n, "gemm"))
    # K6: the decode plan's dedup gather of the token rows
    for tokens in (1, 8, 32, 256):
        x = rnd(tokens, D)
        rs = ops.make_decode_plan(tokens, 8, E, device=dev).gather.row_src
        xz = torch.cat([x, x.new_zeros((1, D))])
        cases.append((f"K6 n {tokens} d {D} into {rs.numel()} rows",
                      lambda x=x, rs=rs: K.gather_rows(x, rs),
                      lambda x=x, rs=rs: K.gather_rows_plain(x, rs),
                      lambda xz=xz, rs=rs: torch.index_select(xz, 0, rs),
                      (tokens + rs.numel()) * D * 2 + rs.numel() * 4, 0, "gather"))

    # training: wt103-47m-moe, batch 32 x 257 tokens, top-4 of 16 experts
    n, k, E, d, g = 32 * 257, 4, 16, 412, 128
    idx = torch.argsort(torch.rand((n, E), generator=gen, device=dev), 1)[:, :k]
    plan = ops.make_moe_plan(idx, E, torch.rand((n, k), generator=gen, device=dev))
    rs, te, m_pad = plan.row_src, plan.tile_expert, plan.m_pad
    rows = n * k
    valid = (rs < n)[:, None]
    x, dy = (ops._pad_lane(torch.randn((n, d), generator=gen, device=dev), 1).to(bf)
             for _ in range(2))
    w1 = ops._pad_w(torch.randn((E, d, g), generator=gen, device=dev) * d ** -0.5).to(bf)
    w2 = ops._pad_w(torch.randn((E, g, d), generator=gen, device=dev) * g ** -0.5).to(bf)
    w2t, w1t = w2.transpose(1, 2).contiguous(), w1.transpose(1, 2).contiguous()
    u = (torch.randn((m_pad, 128), generator=gen, device=dev) * valid).to(bf)
    dh = (torch.randn((m_pad, 128), generator=gen, device=dev) * valid).to(bf)
    xg = K.gather_rows_plain(x, rs)
    cap = -(-int(plan.group_sizes.max()) // 128) * 128

    def expert_major(a):
        """(M_pad, W) plan rows -> (E, cap, W), routed rows only."""
        out = a.new_zeros((E, cap, a.shape[1]))
        e_of_row = te.long().repeat_interleave(128)
        first = torch.searchsorted(te.long(), torch.arange(E, device=dev))
        pos = torch.arange(m_pad, device=dev) - first[e_of_row] * 128
        keep = (rs < n) & (pos < cap)
        out[e_of_row[keep], pos[keep]] = a[keep]
        return out

    xe, dye = expert_major(xg), expert_major(K.gather_rows_plain(dy, rs))
    ue, dhe = expert_major(u), expert_major(dh)
    gate = plan.gate_tiles.reshape(-1)
    tok, routed_g, routed_d = n * d * 2, rows * g * 2, rows * d * 2
    w_b, idx_b, te_b = E * d * g * 2, rows * 4 + te.numel() * 4, te.numel() * 4
    flops = 2 * rows * d * g
    cases += [(*case, "gemm") for case in (
        ("K1 forward relu+h (training)",
         lambda: K.fused_w1(x, rs, te, w1, act="relu", save_preact=True),
         lambda: K.fused_w1_plain(x, rs, te, w1, act="relu", save_preact=True),
         lambda: torch.bmm(xe, w1), tok + w_b + 2 * routed_g + idx_b, flops),
        ("K1 t0 = dy w2^T (training)",
         lambda: K.fused_w1(dy, rs, te, w2t, act="identity"),
         lambda: K.fused_w1_plain(dy, rs, te, w2t, act="identity"),
         lambda: torch.bmm(dye, w2t), tok + w_b + routed_g + idx_b, flops),
        ("K2 y = (u_pad w2) * gate (training)", lambda: K.fused_w2(u, te, w2, gate),
         lambda: K.fused_w2_plain(u, te, w2, gate), lambda: torch.bmm(ue, w2),
         routed_g + w_b + routed_d + rows * 4 + te_b, flops),
        ("K4 dX = dh w1^T (training)", lambda: K.cvmm(dh, te, w1t),
         lambda: K.cvmm_plain(dh, te, w1t), lambda: torch.bmm(dhe, w1t),
         routed_g + w_b + routed_d + te_b, flops),
        ("K4 h = x_pad w1 (unfused forward)", lambda: K.cvmm(xg, te, w1),
         lambda: K.cvmm_plain(xg, te, w1), lambda: torch.bmm(xe, w1),
         routed_d + w_b + routed_g + te_b, flops),
        ("K4 y = u_pad w2 (unfused forward)", lambda: K.cvmm(u, te, w2),
         lambda: K.cvmm_plain(u, te, w2), lambda: torch.bmm(ue, w2),
         routed_g + w_b + routed_d + te_b, flops),
    )]

    def host_ms(fn, iters=200):
        """The host's time to issue one call (wrapper and launch), the
        device not waited for: the launches queue while it catches up."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        elapsed = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e3 * elapsed / iters

    def check(name, fn, plain, kind):
        got, want = fn(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if kind == "gather":
                if not torch.equal(a, b):
                    sys.exit(f"FAIL: {name} differs from its plain version")
                continue
            a, b = a.float(), b.float()
            rel = (torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(1e-30)).item()
            if not (torch.allclose(a, b, atol=3e-2, rtol=3e-2) and rel <= 1e-2):
                sys.exit(f"FAIL: {name} disagrees with its plain version (normwise {rel:.3g})")

    # --sweep: each case with its items forced to one width where the call
    # allows it (the schedule's grid rule kept), beside the default choice
    default_schedule = getattr(K, "row_gemm_schedule", None)

    def forced(bn):
        def schedule(m_pad, k_pad, n_pad, n_sms, glu=False, save=False):
            widest = 64 if glu else 128 if save else 256
            if bn > widest or n_pad % bn:
                return default_schedule(m_pad, k_pad, n_pad, n_sms, glu=glu, save=save)
            items = m_pad // K.TM * (n_pad // bn)
            return bn, items, max(1, min(items, n_sms))
        return schedule

    # --k6: each K6 case with a forced (rows a block, vectors a lane)
    def forced_k6(rows, vpl):
        return lambda m_pad, row_bytes, n_sms: (rows, vpl)

    # per kind: the schedule function replaced, and its settings by label
    settings = {"gemm": ("row_gemm_schedule", {"default": default_schedule}),
                "gather": ("gather_rows_schedule",
                           {"default": getattr(K, "gather_rows_schedule", None)})}
    if args.sweep:
        settings["gemm"][1].update({f"bn {bn}": forced(bn) for bn in (256, 128, 64)})
    if args.k6:
        settings["gather"][1].update({f"rows {r} vpl {v}": forced_k6(r, v)
                                      for r in (1, 2, 4, 8) for v in (1, 2, 4)})
    out = {"card": card, "tag": args.tag, "cases": []}
    for name, fn, plain, lib, nbytes, nflops, kind in cases:
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, nflops / PEAK_BF16)
        lib_ms = _device_ms(lib)
        row = {"case": name, "bound_ms": bound, "bytes": nbytes, "flops": nflops,
               "library_device_ms": lib_ms, "host_ms": host_ms(fn)}
        attr, choices = settings[kind]
        default = choices["default"]
        for label, schedule in choices.items():
            try:
                if schedule is not None:
                    setattr(K, attr, schedule)
                check(name, fn, plain, kind)
                row[label] = _device_ms(fn)
            finally:
                if default is not None:
                    setattr(K, attr, default)
        out["cases"].append(row)
        times = ", ".join(f"{k_} {row[k_]:.4f}" for k_ in choices)
        lib_name = "torch.bmm" if kind == "gemm" else "index_select"
        print(f"[{args.tag}] {name}: device alone ms {times}; {lib_name} {lib_ms:.4f}; "
              f"bound {bound:.4f} ({nbytes / 1e6:.2f} MB, {nflops / 1e9:.2f} GFLOP); "
              f"host {row['host_ms']:.4f} ms a call",
              flush=True)
    print(json.dumps(out))


def k7_main(args, card, dev, gen) -> None:
    """``--k7``: K7 at serve-long's and serve's prefill chunks."""
    import torch
    import torch.nn.functional as F
    from torch.backends.cuda import SDPAParams, can_use_flash_attention
    from torch.nn.attention.bias import causal_lower_right
    from chip_smoke import _device_ms, bf16_ulp
    from repro_torch.kernels import flash_attention as K7

    H, KV, D = 24, 8, 64
    default = getattr(K7, "flash_schedule", None)
    choices = {"default": None}
    if args.sweep and default is not None:
        for bk in (64, 128):
            for splits in (1, 2, 3, 4, 6):
                choices[f"bk {bk} splits {splits}"] = (bk, splits)
    out = {"card": card, "tag": args.tag, "cases": []}
    for label, sq, pool, q_offset, kvl in (("serve-long chunk", 256, 4096, 3072, 3328),
                                           ("serve chunk", 32, 128, 64, 96)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((1, sq, H, D), (1, pool, KV, D), (1, pool, KV, D)))
        kw = dict(causal=True, scale=D ** -0.5, q_offset=q_offset,
                  kv_len=torch.tensor([kvl], device=dev))
        qt, kt, vt = q.transpose(1, 2), k[:, :kvl].transpose(1, 2), v[:, :kvl].transpose(1, 2)
        gqa = can_use_flash_attention(SDPAParams(qt, kt, vt, None, 0.0, False, True))
        if not gqa:
            kt, vt = (t.repeat_interleave(H // KV, dim=1) for t in (kt, vt))
        bias = causal_lower_right(sq, kvl)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias, scale=D ** -0.5,
                                                  enable_gqa=gqa)

        def kernel():
            return K7.flash_attention(q, k, v, **kw)

        want = K7.flash_attention_plain(q, k, v, **kw).float()
        pairs = sum(min(kvl, q_offset + i + 1) for i in range(sq))
        nbytes = (2 * q.numel() + 2 * kvl * KV * D) * 2 + 8
        flops, exps = 4 * D * H * pairs, H * pairs
        bounds = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": flops / PEAK_BF16,
                  "exponentials": exps / EXP_PER_S}
        bound_by = max(bounds, key=bounds.get)
        row = {"case": f"K7 {label}: Sq {sq} at q_offset {q_offset}, kv_len {kvl} of {pool}",
               "bound_ms": 1e3 * bounds[bound_by], "bound_by": bound_by,
               "bounds_ms": {n: 1e3 * b for n, b in bounds.items()}, "bytes": nbytes,
               "flops": flops, "exps": exps, "library_device_ms": _device_ms(sdpa),
               "library_flash_gqa": gqa}
        for name, forced in choices.items():
            saved = dict(getattr(K7, "FLASH_BK", {}))
            try:
                if forced is not None:
                    bk, splits = forced
                    K7.FLASH_BK[D] = bk

                    def schedule(b, sq_, h, kvh, sk, off, causal, n_sms, bk_=bk, s_=splits):
                        _, items, _, _ = default(b, sq_, h, kvh, sk, off, causal, n_sms, bk_)
                        return K7.ROW_TILE, items, s_, items * s_

                    K7.flash_schedule = schedule
                got = kernel().float()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                rel = (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()
                if (err > 4 * bf16_ulp(want.abs().max().item()) or rel > 1e-2
                        or not torch.equal(kernel(), kernel())):
                    sys.exit(f"FAIL: K7 {label} ({name}) disagrees with its plain version "
                             f"(max_abs_err {err:.3g}, normwise {rel:.3g}) or between calls")
                row[name] = _device_ms(kernel, iters=200)
            finally:
                if default is not None:
                    K7.flash_schedule = default
                    K7.FLASH_BK.update(saved)
        if default is not None:
            row["schedule"] = default(1, sq, H, KV, pool, q_offset, True, 132,
                                      K7.FLASH_BK[D])
        out["cases"].append(row)
        times = ", ".join(f"{n} {row[n]:.4f}" for n in choices)
        print(f"[{args.tag}] {row['case']}: device alone ms {times}; "
              f"scaled_dot_product_attention {row['library_device_ms']:.4f} (flash GQA "
              f"{gqa}); bound {row['bound_ms']:.4f} ({bound_by}; bytes "
              f"{row['bounds_ms']['bytes']:.4f}, operations "
              f"{row['bounds_ms']['operations']:.4f}, exponentials "
              f"{row['bounds_ms']['exponentials']:.4f})", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
