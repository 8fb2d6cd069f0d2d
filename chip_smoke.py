#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases (any failure exits non-zero before the result line). 1-6 are the
serving slice, 7-10 the training slice on the fused rung, 11-14 training on
the unfused rung:

1. the card: torch's device name and nvidia-smi's name and power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print ptxas' register/shared-memory report;
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, in bf16 and float32;
4. the main path: ``repro_torch.serving.Engine`` serving 8 requests on
   granite-moe-3b-a800m (sort dispatch) at full width and depth, random
   weights from ``--seed``; every MoE call must run on the two kernels;
5. end to end, kernels against plain versions: one paged prefill and one
   paged decode step at full width and depth 2; then the Engine's greedy
   tokens against contiguous-cache greedy decoding on the reduced config;
6. each kernel timed with CUDA events beside its bound, its plain version
   and one PyTorch library call for the same function;
7. the training kernels (K1 in its four variants, K2, K3 in its three)
   against their plain versions at wt103-47m-moe's training shapes (batch
   32 x 257 tokens, top-4 of 16 experts), in bf16 and float32, with an
   expert that gets no rows and all-sentinel slack tiles;
8. one full-width training step with the kernels against the same step with
   the plain versions and the same expert choices, gradient leaf by leaf,
   and the first 3 losses: in bf16 with the depth cut to 2 and in float32
   at full depth, each against a fixed tolerance; in bf16 at full depth,
   against float32 plain versions, beside the bf16 plain versions (cuBLAS)
   against the same float32 run;
9. the training main path: ``python -m repro_torch.launch.train --arch
   wt103-47m-moe --steps 30 --batch 32 --seq 256`` at full width and depth,
   in process; the loss must be finite and fall, and every step must launch
   exactly 2 K1, 1 K2, 2 K3 and 1 K4 per MoE layer;
10. the step's time, tokens/s, peak memory and a profile (device-busy
    share, top kernels), and each training kernel timed beside its bound,
    its plain version and a ``torch.bmm`` yardstick;
11. the unfused rung's kernels (K5 for dW1 and dW2, K4 for the forward's w1
    and w2 calls) against their plain versions at the training shapes, in
    bf16 and float32, with an expert that gets no rows and all-sentinel
    slack tiles;
12. phase 8's step on the unfused rung (``ops.set_default_impl("pallas")``)
    with phase 8's three gates, and its float32 full-depth step on the
    unfused kernels against the fused rung's kernels (same expert choices);
13. phase 9's run on the unfused rung: finite, falling loss, exactly 4 K4
    and 2 K5 per MoE layer every step and no K1, K2 or K3, and a last-5
    mean loss within 2 % of phase 9's;
14. phase 10's measurements of that run, and K5 (and K4's forward calls)
    timed beside the bound, the plain version and ``torch.bmm``;
15. one ``{"kernels": [...]}`` JSON line, then the device line last.

With ``--out``, the full results (every phase's numbers and the ptxas
reports) are also written there as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no TF32
TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# float32: the kernel and cuBLAS sum K = 512..1536 products in different
# orders; bf16: one bf16 ulp of the rounded result, the reference's serving
# tolerance (tests/test_serving.py).
GRAD_TOL = {"bfloat16": 2e-2, "float32": 2e-3}
# Training step, kernels against plain versions: per-leaf relative gradient
# error ||g_k - g_p|| / ||g_p||, and the relative loss difference. bf16: the
# two paths round the same intermediates, but their sums run in other
# orders, so a bf16 rounding may land one ulp (2^-8 relative) apart.
# float32: a few times the sound runs' worst leaf (3.9e-4 on an H100), which
# float32 scatters summed in another atomic order reach.
YARDSTICK = 1.5
# bf16 at full depth: the kernels' worst and median leaf error against
# float32 plain versions may each be at most this many times the bf16 plain
# versions' (cuBLAS) against the same float32 run.
TRAIN = dict(arch="wt103-47m-moe", batch=32, seq=256, steps=30)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="write the full results to this JSON file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import dispatch
    from repro_torch.kernels import build, cvmm as K, ops
    from repro_torch.models import LM, build_model
    from repro_torch.serving import DecodePlanCache, Engine, Request, make_provider

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    results = {}

    # ------------------------------------------------------------ 1. card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[1] device: {kind}; count {torch.cuda.device_count()}")
    print(smi)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    results["card"] = smi

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    infos = build.build()
    print(f"[2] built {sorted(infos)} in {time.perf_counter() - t0:.1f} s")
    for name, info in infos.items():
        print(f"[2] {name}: nvcc {info.seconds:.1f} s -> {info.path.name}")
        for line in info.ptxas.splitlines():
            if "Compiling entry" in line or "Used" in line:
                print(f"[2]   {line.strip()}")
    results["build"] = {n: {"seconds": i.seconds, "ptxas": i.ptxas}
                        for n, i in infos.items()}

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    E, D, G = 40, 1536, 512

    def decode_layout(m_pad):
        return torch.arange(E, dtype=torch.int32, device=dev).repeat_interleave(
            m_pad // 128 // E)

    def k4_inputs(m_pad, k, n, dtype, layout):
        x = torch.randn((m_pad, k), generator=gen, device=dev).to(dtype)
        w = (torch.randn((E, k, n), generator=gen, device=dev) * k ** -0.5).to(dtype)
        te = (decode_layout(m_pad) if layout == "decode" else
              torch.randint(0, E, (m_pad // 128,), generator=gen, device=dev,
                            dtype=torch.int32))
        return x, te, w

    def k6_inputs(n, dtype, weighted):
        x = torch.randn((n, D), generator=gen, device=dev).to(dtype)
        plan = ops.make_decode_plan(n, 8, E, device=dev)
        wt = (torch.rand((plan.gather.u_pad,), generator=gen, device=dev)
              if weighted else None)
        return x, plan.gather.row_src, wt

    # ------------------------------------------- 3. kernels vs plain versions
    k4_cases = [(5120, D, G, "decode"), (5120, G, D, "decode"),
                (10240, D, G, "decode"), (5120, D, G, "random")]
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for m_pad, k, n, layout in k4_cases:
            x, te, w = k4_inputs(m_pad, k, n, dt, layout)
            got, want = K.cvmm(x, te, w), K.cvmm_plain(x, te, w)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), atol=TOL[dn], rtol=TOL[dn])
            print(f"[3] cvmm {layout} M_pad {m_pad} {k}->{n} E {E} {dn}: "
                  f"max_abs_err {err:.3g} (tol {TOL[dn]}) {'ok' if ok else 'BAD'}")
            if not ok:
                fail(f"cvmm disagrees with cvmm_plain at {m_pad} {k}->{n} {dn}")
            errs[("cvmm", m_pad, k, n, layout, dn)] = err
        for n in (1, 8, 32):
            for weighted in (False, True):
                x, rs, wt = k6_inputs(n, dt, weighted)
                got, want = K.gather_rows(x, rs, wt), K.gather_rows_plain(x, rs, wt)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                print(f"[3] gather_rows n {n} d {D} weighted {weighted} {dn}: "
                      f"max_abs_err {err:.3g} (exact) {'ok' if err == 0 else 'BAD'}")
                if err != 0:
                    fail(f"gather_rows disagrees with gather_rows_plain at n {n} {dn}")
                errs[("gather_rows", n, weighted, dn)] = err
    results["phase3"] = {" ".join(map(str, k)): v for k, v in errs.items()}

    # --------------------------------------------- 4. the main path, full size
    cfg = get_config("granite-moe-3b-a800m")
    lm = build_model(cfg.with_ffn(dataclasses.replace(cfg.ffn, dispatch="sort")))
    cfg = lm.cfg
    t0 = time.perf_counter()
    params = lm.serving_params(lm.init(torch.Generator(device=dev).manual_seed(args.seed),
                                       device=dev))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[4] {cfg.name} sort dispatch: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B params in {lm.dtype}; init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               size=int(rng.integers(32, 97))).tolist(),
                    max_new=32) for i in range(8)]
    engine_kw = dict(max_batch=8, max_len=128, page_size=16, burst_steps=8,
                     prefill_chunk=32, device=dev)
    with Engine(lm, params, **engine_kw) as eng:     # warm-up: lazy inits
        eng.run([Request(rid="warm", prompt=[1, 2, 3], max_new=4)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with Engine(lm, params, **engine_kw) as eng:
        outs = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        plan_counters = eng.plan_cache.counters()
        stats = dict(eng.stats)
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(v) for v in outs.values())
    print(f"[4] {len(outs)} requests, {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tok/s; max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"[4] engine stats {stats}; decode plans {plan_counters}")
    moe_calls = cfg.n_layers * (stats["decode_steps"] + stats["prefill_chunks"])
    print(f"[4] launches {launches}; MoE calls {moe_calls} -> expected cvmm "
          f"{3 * moe_calls}, gather_rows {moe_calls}")
    if len(outs) != 8 or any(len(v) != 32 for v in outs.values()):
        fail(f"engine did not complete every request: {[len(v) for v in outs.values()]}")
    if any(not 0 <= t < cfg.vocab_size for v in outs.values() for t in v):
        fail("engine emitted a token outside the vocabulary")
    if launches["cvmm"] != 3 * moe_calls or launches["gather_rows"] != moe_calls:
        fail(f"main path did not run every MoE call on the kernels: {launches}")
    results["engine"] = {"requests": len(outs), "tokens": n_tok, "wall_s": wall,
                         "tok_per_s": n_tok / wall, "max_memory_allocated": peak,
                         "stats": stats, "plan_cache": plan_counters,
                         "launches": launches, "n_params": n_params}
    results["decode_step"] = _profile_decode_step(lm, params, dev)
    del params, eng
    torch.cuda.empty_cache()

    # -------------------------------- 5. end to end: kernels vs plain versions
    cfg2 = cfg.override(n_layers=2)
    lm2 = LM(cfg2)
    p2 = lm2.serving_params(lm2.init(torch.Generator(device=dev).manual_seed(args.seed + 1),
                                     device=dev))
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(1, 32)), device=dev)
    tables = torch.arange(1, 1 + 8 * 8, dtype=torch.int32, device=dev).reshape(8, 8)
    dec_tok = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=8), device=dev)
    dec_pos = torch.full((8,), 32, device=dev)

    def prefill_and_decode():
        cache = lm2.init_paged_cache(1 + 8 * 8, 16, device=dev)
        dispatch.set_decode_provider(make_provider(DecodePlanCache(), max_tokens=32))
        try:
            lp, cache = lm2.prefill_paged(p2, prompt, cache, tables[:1], 0, 32)
            ld, _ = lm2.decode_step_paged(p2, cache, dec_tok, dec_pos, tables)
        finally:
            dispatch.set_decode_provider(None)
        return lp, ld

    got = prefill_and_decode()
    with plain_kernels(K):
        want = prefill_and_decode()
    for name, g, w in zip(("prefill_paged", "decode_step_paged"), got, want):
        g, w = g[:, :cfg.vocab_size], w[:, :cfg.vocab_size]
        err = (g - w).abs().max().item()
        same = bool((g.argmax(-1) == w.argmax(-1)).all())
        ok = torch.allclose(g, w, atol=TOL["bfloat16"], rtol=TOL["bfloat16"]) and same
        print(f"[5] {name} depth 2 logits {tuple(g.shape)}: kernels vs plain "
              f"max_abs_err {err:.3g} (tol 3e-2), same argmax {same}; "
              f"finite {bool(torch.isfinite(g).all())} {'ok' if ok else 'BAD'}")
        if not ok or not torch.isfinite(g).all():
            fail(f"{name}: kernel path disagrees with the plain path")
        results.setdefault("e2e", {})[name] = err
    del p2
    torch.cuda.empty_cache()

    rcfg = reduced("granite-moe-3b-a800m").override(dtype="float32")
    rlm = LM(rcfg)
    rp = rlm.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    rreqs = [Request(rid=i, prompt=rng.integers(1, rcfg.vocab_size,
                                                size=int(rng.integers(3, 18))).tolist(),
                     max_new=int(rng.integers(2, 10))) for i in range(4)]
    with Engine(rlm, rp, max_batch=3, max_len=64, page_size=8, burst_steps=4,
                prefill_chunk=8, device=dev) as eng:
        routs = eng.run(rreqs)
    refs = {r.rid: _greedy(rlm, rp, r.prompt, r.max_new, dev) for r in rreqs}
    print(f"[5] reduced f32 engine vs contiguous greedy: {routs == refs}")
    if routs != refs:
        fail(f"reduced engine {routs} != contiguous greedy {refs}")

    # ------------------------------------------------------------- 6. timing
    timings = []
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for m_pad, k, n, _ in k4_cases[:3]:
            x, te, w = k4_inputs(m_pad, k, n, dt, "decode")
            cap = m_pad // E
            nbytes = (x.numel() + w.numel() + m_pad * n) * x.element_size() + te.numel() * 4
            flops = 2 * m_pad * k * n
            bound_b, bound_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dn]
            timings.append({
                "kernel": "cvmm", "shape": f"M_pad {m_pad} {k}->{n} E {E}", "dtype": dn,
                "ms": _time_ms(lambda: K.cvmm(x, te, w)),
                "plain_ms": _time_ms(lambda: K.cvmm_plain(x, te, w)),
                "library_ms": _time_ms(lambda: torch.bmm(x.view(E, cap, k), w)),
                "bound_ms": 1e3 * max(bound_b, bound_f),
                "bound_by": "bytes" if bound_b >= bound_f else "operations",
                "max_abs_err": errs[("cvmm", m_pad, k, n, "decode", dn)]})
        for n in (1, 8, 32):
            x, rs, _ = k6_inputs(n, dt, False)
            xz = torch.cat([x, x.new_zeros((1, D))])
            nbytes = (n + rs.numel()) * D * x.element_size() + rs.numel() * 4
            timings.append({
                "kernel": "gather_rows", "shape": f"n {n} d {D} into {rs.numel()} rows",
                "dtype": dn,
                "ms": _time_ms(lambda: K.gather_rows(x, rs)),
                "plain_ms": _time_ms(lambda: K.gather_rows_plain(x, rs)),
                "library_ms": _time_ms(lambda: torch.index_select(xz, 0, rs)),
                "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
                "max_abs_err": errs[("gather_rows", n, False, dn)]})
    for t in timings:
        print(f"[6] {t['kernel']} {t['shape']} {t['dtype']}: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    results["timings"] = timings

    # ------------------------------------------------ 7-14. the training slice
    train = _training_slice(args.seed, dev, gen, K, results)

    # ------------------------------------------------------------ 15. report
    def row(kernel, shape, source, replaces):
        t = next(t for t in timings if t["kernel"] == kernel and t["shape"] == shape
                 and t["dtype"] == "bfloat16")
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[kernel], "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": shape, "dtype": "bfloat16", "path": "serving"}

    k4 = row("cvmm", f"M_pad 5120 {D}->{G} E {E}", "src/repro_torch/kernels/csrc/cvmm.cu",
             "src/repro/kernels/cvmm.py:241")
    k4["launches_training"] = train["launches"]["cvmm"]
    k4["launches_training_unfused"] = train["launches_unfused"]["cvmm"]
    line = {"kernels": [
        train["rows"]["fused_w1"], train["rows"]["fused_w2"],
        train["rows"]["dw_streamed"], k4, train["rows"]["cvmm_dw"],
        row("gather_rows", f"n 8 d {D} into 128 rows",
            "src/repro_torch/kernels/csrc/gather_rows.cu",
            "src/repro/kernels/cvmm.py:621")]}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1, default=str))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def _training_slice(seed, dev, gen, K, results):
    """Phases 7-14: the training slice's kernels, one step kernels vs plain,
    the 30-step main path, and its measurements, on the fused rung (7-10)
    and the unfused rung (11-14). Returns the launch counts of both main
    paths and the report rows of K1, K2, K3 and K5."""
    import torch
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core import routing
    from repro_torch.data import DataIterator, make_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.runtime import init_train_state, make_train_step

    cfg = get_config(TRAIN["arch"])
    n, k, E, d, G = TRAIN["batch"] * (TRAIN["seq"] + 1), cfg.ffn.k, cfg.ffn.n_experts, \
        cfg.d_model, cfg.ffn.expert_size

    # ------------------------------------- 7. training kernels vs plain versions
    def draw_plan(skip=None):
        pool = torch.tensor([e for e in range(E) if e != skip], device=dev)
        keys = torch.rand((n, len(pool)), generator=gen, device=dev)
        idx = pool[torch.argsort(keys, dim=1)[:, :k]]
        return ops.make_moe_plan(idx, E, torch.rand((n, k), generator=gen, device=dev))

    empty = E // 2
    plans = {"all experts": draw_plan(), "one expert empty": draw_plan(skip=empty)}
    for name, plan in plans.items():
        slack = (plan.row_src.view(-1, 128) >= n).all(1).sum().item()
        print(f"[7] plan '{name}': N {n} x top-{k}, E {E}, M_pad {plan.m_pad}, "
              f"{plan.m_pad // 128} tiles of which {slack} all-sentinel; rows per "
              f"expert {plan.group_sizes.tolist()}")
        if not slack:
            fail("the plan has no all-sentinel slack tile")

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    base = {"x": ops._pad_lane(rnd(n, d), 1), "dy": ops._pad_lane(rnd(n, d), 1),
            "w1": ops._pad_w(rnd(E, d, G, scale=d ** -0.5)),
            "w1g": ops._pad_w(rnd(E, d, G, scale=d ** -0.5)),
            "w2": ops._pad_w(rnd(E, G, d, scale=G ** -0.5))}
    base["w2t"] = base["w2"].transpose(1, 2).contiguous()

    def inputs(dt, plan):
        # Every checked output is O(1), so one tolerance means the same for
        # every kernel: weights carry (reduction length)^-0.5, and so do the
        # cotangents that K3 sums over an expert's ~n*k/E rows (unit-scale
        # cotangents make sums near 45, whose float32 summation orders
        # differ by more than 1e-4).
        t = {key: v.to(dt) for key, v in base.items()}
        t["u"] = rnd(plan.m_pad, base["w1"].shape[2]).to(dt)
        t["dh"] = rnd(plan.m_pad, base["w1"].shape[2]).to(dt)
        rows = (n * k / E) ** -0.5
        t["dh_dw"] = (t["dh"].float() * rows).to(dt)
        t["dy_dw"] = (base["dy"] * rows).to(dt)
        return t

    cases = []      # (name, kernel, plan key, fn(t, plan) -> (kernel, plain))
    for glu in (False, True):
        for save in (False, True):
            for act in ("relu", "identity"):
                variant = "w1" + ("_glu" if glu else "") + ("_save" if save else "")
                cases.append((f"fused_w1 {variant} {act}", "fused_w1", "all experts",
                              lambda t, p, glu=glu, save=save, act=act: [
                                  f(t["x"], p.row_src, p.tile_expert, t["w1"],
                                    t["w1g"] if glu else None, act=act, save_preact=save)
                                  for f in (K.fused_w1, K.fused_w1_plain)]))
    cases.append(("fused_w1 t0 = dy w2^T identity, one expert empty", "fused_w1",
                  "one expert empty", lambda t, p: [
                      f(t["dy"], p.row_src, p.tile_expert, t["w2t"], None, act="identity")
                      for f in (K.fused_w1, K.fused_w1_plain)]))
    cases.append(("cvmm dX = dh w1^T", "cvmm", "all experts", lambda t, p: [
        f(t["dh"], p.tile_expert, t["w1"].transpose(1, 2).contiguous())
        for f in (K.cvmm, K.cvmm_plain)]))
    cases.append(("fused_w2", "fused_w2", "all experts", lambda t, p: [
        f(t["u"], p.tile_expert, t["w2"], p.gate_tiles.reshape(-1))
        for f in (K.fused_w2, K.fused_w2_plain)]))
    for variant, stream_x, gated in (("stream_x (dW1)", True, False),
                                     ("stream_g (dW2, no gate)", False, False),
                                     ("stream_g gated (dW2)", False, True)):
        cases.append((f"dw_streamed {variant}, one expert empty", "dw_streamed",
                      "one expert empty", lambda t, p, sx=stream_x, gt=gated: [
                          f(t["x"] if sx else t["u"], t["dh_dw"] if sx else t["dy_dw"],
                            p.row_src, p.tile_expert, E, stream_x=sx,
                            gate=p.gate_tiles.reshape(-1) if gt else None)
                          for f in (K.dw_streamed, K.dw_streamed_plain)]))
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        tens = {key: inputs(dt, plan) for key, plan in plans.items()}
        for name, kernel, pkey, fn in cases:
            got, want = fn(tens[pkey], plans[pkey])
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            differ = (sum(int((a != b).sum()) for a, b in zip(got, want))
                      / sum(a.numel() for a in got))
            # K3's outputs are float32 sums of identical operands in either
            # input type, so they get the float32 tolerance.
            tol = TOL["float32" if kernel == "dw_streamed" else dn]
            ok = all(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)
                     for a, b in zip(got, want)) and len(got) == len(want)
            if kernel == "dw_streamed":
                ok = ok and bool((got[0][empty] == 0).all())
            print(f"[7] {name} {dn}: max_abs_err {err:.3g} (tol {tol}), "
                  f"{100 * differ:.3f}% of elements differ {'ok' if ok else 'BAD'}")
            if not ok:
                fail(f"{name} disagrees with its plain version in {dn}")
            errs[(name, dn)] = err
        del tens
    results["phase7"] = {f"{a} {b}": v for (a, b), v in errs.items()}

    # ------------------------- 8. one full-width step: kernels vs plain versions
    # The plain runs replay the kernel runs' expert choices, so both route
    # every token alike and differ only in the kernels' arithmetic (left free,
    # summation order flips the top-4 choice of tokens near a tie, which
    # moves whole tokens between experts). The check holds each gradient leaf
    # and the first 3 losses to GRAD_TOL in bf16 at full width with the depth
    # cut to 2, and in float32 at full width and depth. At full depth in
    # bf16, outputs that differ by one ulp in a few elements per kernel call
    # grow through 16 layers forward and back into per-leaf differences
    # above GRAD_TOL, as any two bf16 paths do; there the kernels' gradients
    # are held against float32 plain versions on the same expert choices,
    # with the bf16 plain versions' error against the same run as the
    # yardstick (YARDSTICK).
    opt = OptimizerConfig(total_steps=3)
    stream = DataIterator(make_dataset("synthetic", cfg.vocab_size), TRAIN["batch"],
                          TRAIN["seq"] + 1, seed=seed)
    batches = [{"tokens": torch.as_tensor(stream.next()["tokens"], device=dev)}
               for _ in range(3)]
    three_steps = _three_steps_fn(batches, opt, seed, dev)
    results["phase8"] = _step_gates("8", cfg, "pallas_fused", three_steps, K, ops,
                                    routing)
    torch.cuda.empty_cache()     # phase 9's peak memory is the trainer's own

    # ------------------------------------------------ 9. the training main path
    argv = ["--arch", TRAIN["arch"], "--steps", str(TRAIN["steps"]), "--batch",
            str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]), "--seed", str(seed),
            "--device", dev.type]
    layers = cfg.n_layers
    fused = _train_main_path("9", argv, dict.fromkeys(K.LAUNCHES, 0) | {
        "fused_w1": 2 * layers, "fused_w2": layers, "dw_streamed": 2 * layers,
        "cvmm": layers}, K, train_cli)

    # --------------------------------------------------------- 10. measurements
    _print_run("10", fused)
    lm = build_model(cfg)
    state = init_train_state(lm, torch.Generator(device=dev).manual_seed(seed), opt,
                             use_mems=True, batch=TRAIN["batch"], device=dev)
    prof = _profile_train_step("10", lm, state, batches[0], make_train_step(lm, opt), dev)
    del lm, state
    timings = _time_training_kernels("10", "pallas_fused", K, plans["all experts"],
                                     inputs(torch.bfloat16, plans["all experts"]),
                                     n, d, G, E, errs)
    results["training"] = fused | {"profile": prof, "timings": timings}

    # --------------------------- 11. the unfused rung's kernels vs plain versions
    # K5 (both operands tile-aligned, slack rows zero) for dW1 and dW2, and
    # K4 for the unfused forward's w1 and w2 calls, at the training shapes.
    def unfused_cases(t, p):
        valid = (p.row_src < n)[:, None]
        xa = K.gather_rows_plain(t["x"], p.row_src)             # x_pad of the w1 call
        cases = {"cvmm_dw dW1 = x_pad^T dh_pad": (xa, p.tile_expert, t["dh_dw"] * valid, E),
                 "cvmm_dw dW2 = u_pad^T dy_pad": (t["u"] * valid, p.tile_expert,
                                                   K.gather_rows_plain(t["dy_dw"], p.row_src),
                                                   E)}
        return [(name, "cvmm_dw", args) for name, args in cases.items()] + [
            ("cvmm h = x_pad w1 (unfused forward)", "cvmm", (xa, p.tile_expert, t["w1"])),
            ("cvmm y = u_pad w2 (unfused forward)", "cvmm",
             (t["u"] * valid, p.tile_expert, t["w2"]))]

    errs11 = {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for pkey, plan in plans.items():
            for name, kernel, args in unfused_cases(inputs(dt, plan), plan):
                got = getattr(K, kernel)(*args)
                want = getattr(K, kernel + "_plain")(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                # K5's outputs are float32 sums of identical operands in
                # either input type, so they get the float32 tolerance.
                tol = TOL["float32" if kernel == "cvmm_dw" else dn]
                ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
                if kernel == "cvmm_dw" and pkey == "one expert empty":
                    ok = ok and bool((got[empty] == 0).all())
                print(f"[11] {name}, {pkey}, {dn}: max_abs_err {err:.3g} (tol {tol}) "
                      f"{'ok' if ok else 'BAD'}")
                if not ok:
                    fail(f"{name} disagrees with its plain version in {dn} ({pkey})")
                errs11[(f"{name}, {pkey}", dn)] = err
    errs.update(errs11)
    results["phase11"] = {f"{a} {b}": v for (a, b), v in errs11.items()}

    # ---------------- 12. one full-width step on the unfused rung: kernels vs plain
    phase12 = _step_gates("12", cfg, "pallas", three_steps, K, ops, routing,
                          cross_rung="pallas_fused")
    for label, r in phase12.items():
        fused_kernels = {k_: v for k_, v in r["launches"].items()
                         if k_ in ("fused_w1", "fused_w2", "dw_streamed") and v}
        if fused_kernels or not r["launches"]["cvmm_dw"]:
            fail(f"the pallas rung's step ({label}) launched {r['launches']}")
    results["phase12"] = phase12
    torch.cuda.empty_cache()

    # ------------------------------------- 13. the unfused rung's training path
    with pinned_impl(ops, "pallas"):
        unfused = _train_main_path("13", argv, dict.fromkeys(K.LAUNCHES, 0) | {
            "cvmm": 4 * layers, "cvmm_dw": 2 * layers}, K, train_cli,
            label='ops.set_default_impl("pallas"); ')
    gap = abs(unfused["last5"] - fused["last5"]) / fused["last5"]
    print(f"[13] last-5 mean loss {unfused['last5']:.4f} on the pallas rung, "
          f"{fused['last5']:.4f} on the pallas_fused rung (phase 9, same seed): "
          f"{100 * gap:.2f}% apart (limit 2%)")
    if gap > 0.02:
        fail("the unfused rung's training run strays from the fused rung's")

    # ------------------------------------------------------- 14. measurements
    _print_run("14", unfused)
    lm = build_model(cfg)
    state = init_train_state(lm, torch.Generator(device=dev).manual_seed(seed), opt,
                             use_mems=True, batch=TRAIN["batch"], device=dev)
    with pinned_impl(ops, "pallas"):
        prof = _profile_train_step("14", lm, state, batches[0], make_train_step(lm, opt),
                                   dev)
    del lm, state
    timings += _time_training_kernels("14", "pallas", K, plans["all experts"],
                                      inputs(torch.bfloat16, plans["all experts"]),
                                      n, d, G, E, errs)
    results["training_unfused"] = unfused | {"profile": prof}

    src = "src/repro_torch/kernels/csrc/"
    meta = {"fused_w1": ("fused_w1 relu+h (forward)", src + "fused_w1.cu",
                         "src/repro/kernels/cvmm.py:513", fused),
            "fused_w2": ("fused_w2 (forward)", src + "fused_w2.cu",
                         "src/repro/kernels/cvmm.py:820", fused),
            "dw_streamed": ("dw_streamed stream_x (dW1)", src + "dw_streamed.cu",
                            "src/repro/kernels/cvmm.py:730", fused),
            "cvmm_dw": ("cvmm_dw dW1 = x_pad^T dh_pad", src + "cvmm_dw.cu",
                        "src/repro/kernels/cvmm.py:296", unfused)}
    rows = {}
    for kernel, (case, source, replaces, run) in meta.items():
        t = next(t for t in timings if t["case"] == case)
        rows[kernel] = {"name": kernel, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": run["launches"][kernel],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "shape": t["shape"], "dtype": "bfloat16",
                        "path": "training, " + ("pallas" if run is unfused
                                                else "pallas_fused") + " rung"}
    return {"launches": fused["launches"], "launches_unfused": unfused["launches"],
            "rows": rows}


def _train_main_path(tag, argv, want, K, train_cli, label=""):
    """Run the trainer in process with every launch count at 0 just before;
    the loss must be finite and fall, and every step must launch exactly
    ``want``. Returns the run's numbers."""
    import numpy as np
    import torch

    print(f"[{tag}] {label}python -m repro_torch.launch.train {' '.join(argv)}",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    bad_steps = [i for i, l in enumerate(out["launches"]) if l != want]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"[{tag}] launches {launches}; per step {out['launches'][-1]} (expected "
          f"{want}); steps off that count: {bad_steps}")
    print(f"[{tag}] loss mean of the first 5 steps {first:.4f}, of the last 5 {last:.4f}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not last < first:
        fail("the training loss did not fall")
    if bad_steps:
        fail(f"training steps {bad_steps} did not run every MoE layer on the kernels")
    steady = out["step_s"][5:]
    step_s = float(np.mean(steady))
    return {"losses": losses, "step_s": out["step_s"], "step_ms": 1e3 * step_s,
            "step_ms_min": 1e3 * min(steady), "step_ms_max": 1e3 * max(steady),
            "tokens_per_s": out["tokens_per_step"] / step_s, "max_memory_allocated": peak,
            "launches": launches, "launches_per_step": out["launches"][-1],
            "n_params": out["n_params"], "first5": first, "last5": last}


def _print_run(tag, run):
    print(f"[{tag}] step {run['step_ms']:.2f} ms (mean of steps 5-{TRAIN['steps'] - 1}, "
          f"min {run['step_ms_min']:.2f}, max {run['step_ms_max']:.2f}); "
          f"{run['tokens_per_s']:.0f} tokens/s; max_memory_allocated "
          f"{run['max_memory_allocated'] / 2**30:.2f} GiB")


def _three_steps_fn(batches, opt, seed, dev):
    """``three_steps(lm)``: the gradients of the first batch, then 3 train
    steps from the same initial state; returns (grads by leaf path, losses)."""
    import torch
    from repro_torch.common import map_leaves
    from repro_torch.runtime import init_train_state, make_train_step

    def three_steps(lm):
        state = init_train_state(lm, torch.Generator(device=dev).manual_seed(seed), opt,
                                 use_mems=True, batch=TRAIN["batch"], device=dev)
        loss, _ = lm.loss(state["params"], batches[0], train=True,
                          gen=torch.Generator(device=dev).manual_seed(seed + 1),
                          mems=state["mems"])
        loss.backward()
        grads = {}
        map_leaves(state["params"], lambda path, p: grads.setdefault(path, p.grad.clone()))
        step = make_train_step(lm, opt)
        drop = torch.Generator(device=dev).manual_seed(seed + 2)
        losses = []
        for b in batches:
            state, m = step(state, b, drop)
            losses.append(float(m["loss"]))
        return grads, losses
    return three_steps


def _compare(ga, gb):
    """Per-leaf ||ga - gb|| / ||gb||: (worst, its leaf path, median)."""
    import torch
    errs = sorted(((torch.linalg.norm((ga[p] - gb[p]).float())
                    / torch.linalg.norm(gb[p].float()).clamp_min(1e-30)).item(), p)
                  for p in gb)
    return errs[-1][0], "/".join(map(str, errs[-1][1])), errs[len(errs) // 2][0]


def _step_gates(tag, cfg, rung, three_steps, K, ops, routing, cross_rung=None):
    """Phases 8 and 12: one full-width training step on the sort path's
    ``rung`` with the kernels, against the same step with the plain versions
    and the same expert choices.

    The plain runs replay the kernel runs' expert choices, so both route
    every token alike and differ only in the kernels' arithmetic (left free,
    summation order flips the top-4 choice of tokens near a tie, which
    moves whole tokens between experts). The check holds each gradient leaf
    and the first 3 losses to GRAD_TOL in bf16 at full width with the depth
    cut to 2, and in float32 at full width and depth. At full depth in
    bf16, outputs that differ by one ulp in a few elements per kernel call
    grow through 16 layers forward and back into per-leaf differences
    above GRAD_TOL, as any two bf16 paths do; there the kernels' gradients
    are held against float32 plain versions on the same expert choices,
    with the bf16 plain versions' error against the same run as the
    yardstick (YARDSTICK). With ``cross_rung``, the float32 step also runs
    on that rung's kernels with the same choices, each gradient leaf and
    loss within GRAD_TOL["float32"] of ``rung``'s: two independent kernel
    sets for one function."""
    import numpy as np
    import torch
    from repro_torch.models import build_model

    E = cfg.ffn.n_experts
    out = {}
    for variant, mode in ((cfg.override(n_layers=2), "fixed"),
                          (cfg.override(dtype="float32"), "fixed"), (cfg, "yardstick")):
        label = f"{variant.dtype}, depth {variant.n_layers}"
        lm = build_model(variant)
        choices = []
        K.reset_launch_counts()
        with pinned_impl(ops, rung), pinned_routing(routing, choices, replay=False):
            gk, lk = three_steps(lm)
        step_launches = dict(K.LAUNCHES)
        with pinned_impl(ops, rung), plain_kernels(K), \
                pinned_routing(routing, choices, replay=True):
            gp, lp = three_steps(lm)
        worst, leaf, median = _compare(gk, gp)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
        tol = GRAD_TOL[variant.dtype]
        print(f"[{tag}] {rung}, {label}, full width, {len(gp)} gradient leaves, same "
              f"expert choices: worst relative error {worst:.3g} at {leaf}, median "
              f"{median:.3g}; losses kernels {lk} plain {lp}, worst relative "
              f"{loss_err:.3g} ({f'tol {tol}' if mode == 'fixed' else 'not a check'}); "
              f"launches {step_launches}")
        out[label] = {"worst_grad_rel": worst, "worst_leaf": leaf, "median": median,
                      "losses_kernels": lk, "losses_plain": lp,
                      "launches": step_launches}
        if not all(np.isfinite(lk)):
            fail(f"non-finite loss {lk}")
        if mode == "fixed" and not (worst <= tol and loss_err <= tol):
            fail(f"{rung}, {label}: the kernels' training step disagrees with the "
                 "plain versions'")
        if cross_rung and variant.dtype == "float32":
            with pinned_impl(ops, cross_rung), pinned_routing(routing, choices, replay=True):
                gx, lx = three_steps(lm)
            cross = _compare(gx, gk)
            cross_loss = max(abs(a - b) / abs(b) for a, b in zip(lx, lk))
            print(f"[{tag}] {label}, same expert choices, {cross_rung} kernels against "
                  f"{rung} kernels: worst relative error {cross[0]:.3g} at {cross[1]}, "
                  f"median {cross[2]:.3g}; losses {lx}, worst relative {cross_loss:.3g} "
                  f"(tol {GRAD_TOL['float32']})")
            out[label]["cross_rung"] = {"rung": cross_rung, "worst": cross[0],
                                        "leaf": cross[1], "median": cross[2],
                                        "losses": lx}
            if not (cross[0] <= GRAD_TOL["float32"]
                    and cross_loss <= GRAD_TOL["float32"]):
                fail(f"{label}: the {cross_rung} and {rung} kernels' training steps "
                     "disagree")
            del gx
        if mode == "yardstick":
            with pinned_impl(ops, rung), plain_kernels(K), \
                    pinned_routing(routing, choices, replay=True):
                gf, lf = three_steps(build_model(variant.override(dtype="float32")))
            kern, lib = _compare(gk, gf), _compare(gp, gf)
            print(f"[{tag}] {label}, same expert choices, against float32 plain "
                  f"versions: kernels worst {kern[0]:.3g} at {kern[1]}, median "
                  f"{kern[2]:.3g}; bf16 plain versions (cuBLAS) worst {lib[0]:.3g} at "
                  f"{lib[1]}, median {lib[2]:.3g}; limit {YARDSTICK}x the latter's "
                  f"worst and median; float32 losses {lf}")
            out[label].update(kernels_vs_f32=kern, plain_bf16_vs_f32=lib, losses_f32=lf)
            if not (kern[0] <= YARDSTICK * lib[0] and kern[2] <= YARDSTICK * lib[2]):
                fail(f"{label}: the kernels' gradients stray further from float32 than "
                     f"{YARDSTICK}x the bf16 plain versions'")
            del gf
            load = [torch.bincount(c.reshape(-1), minlength=E).max().item() * E / c.numel()
                    for c in choices[:variant.n_layers]]
            print(f"[{tag}] {label}: rows of the busiest expert over the mean, layer by "
                  f"layer, first batch: {[round(x, 2) for x in load]}")
            out[label]["expert_load"] = load
            with pinned_impl(ops, rung), plain_kernels(K):
                free = _compare(gk, three_steps(lm)[0])
            print(f"[{tag}] {label}, each run choosing its own experts: worst relative "
                  f"error {free[0]:.3g} at {free[1]}, median {free[2]:.3g} (not a check)")
            out[label]["free_routing"] = free
        del gk, gp, lm
    return out


def _profile_train_step(tag, lm, state, batch, step, dev):
    """One full-width training step under torch.profiler: wall time, device
    busy share, and the kernels that take the time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = step(state, batch, gen)             # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    print(f"[{tag}] profiled training step: {wall_ms:.2f} ms wall, device busy "
          f"{busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f}% ({n_launch} kernel launches)")
    for e in top:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    ours = {}
    for e in kernels:           # this port's kernels, by their CUDA symbols
        name = _port_kernel(e.key)
        if name:
            n, ms = ours.get(name, (0, 0.0))
            ours[name] = (n + e.count, ms + e.self_device_time_total / 1e3)
    for name, (n, ms) in sorted(ours.items()):
        print(f"[{tag}]   {name}: {n} launches, {ms:.3f} ms in the step, "
              f"{ms / n:.4f} ms each")
    if busy_ms <= 0:
        fail("the profiler saw no device time in the training step")
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms, "kernel_launches": n_launch,
            "top": [(e.key, e.count, e.self_device_time_total / 1e3) for e in top],
            "port_kernels": ours}


def _port_kernel(symbol):
    """Which of this port's bf16 kernels a profiled CUDA symbol is, or None.
    K1, K2 and K4 are instances of row_gemm_bf16<BN, GATHER, GLU, SAVE, GATE>
    (csrc/row_gemm.cuh): K1 gathers, K2 applies the gate, K4 does neither.
    K3 and K5 are instances of dw_bf16<OPERANDS, GATE> (csrc/dw_gemm.cuh):
    K5 gathers neither operand (OPERANDS 0)."""
    if "dw_bf16<" in symbol:
        operands = symbol.split("dw_bf16<", 1)[1].split(",", 1)[0].strip()
        return "K5 cvmm_dw" if operands.endswith("0") else "K3 dw_streamed"
    if "row_gemm_bf16<" not in symbol:
        return None
    args = symbol.split("row_gemm_bf16<", 1)[1].split(">", 1)[0]
    _, gather, _, _, gate = (a.strip() for a in args.split(","))
    return ("K1 fused_w1" if gather == "true" else "K2 fused_w2" if gate == "true"
            else "K4 cvmm")


def _time_training_kernels(tag, rung, K, plan, t, n, d, g, E, errs):
    """Each training kernel of the sort path's ``rung`` ("pallas_fused": K1,
    K2, K3, K4 dX; "pallas": K5, K4 forward) at the step's shapes (bf16),
    with CUDA events,
    beside its bound, its plain version and a torch.bmm yardstick on the
    expert-major padded layout (rows grouped per expert, each group padded
    to the largest). Bounds count what the function needs, not the padded
    layout the kernels work on: each input read once and each output
    written once at its real widths (d_model ``d`` and expert size ``g``,
    not the lane-padded K_pad), the routed rows only (not the slack rows of M_pad), and the
    products of the routed rows over ``d``."""
    import torch

    m_pad, rows = plan.m_pad, int(plan.group_sizes.sum())
    k_pad = t["w1"].shape[1]
    te, rs, gate = plan.tile_expert, plan.row_src, plan.gate_tiles.reshape(-1)
    cap = -(-int(plan.group_sizes.max()) // 128) * 128
    valid = rs < n

    def expert_major(a_pad):
        """(M_pad, W) plan rows -> (E, cap, W), routed rows only."""
        out = a_pad.new_zeros((E, cap, a_pad.shape[1]))
        e_of_row = te.long().repeat_interleave(128)
        first = torch.searchsorted(te.long(), torch.arange(E, device=te.device))
        pos = torch.arange(m_pad, device=te.device) - first[e_of_row] * 128
        keep = valid & (pos < cap)
        out[e_of_row[keep], pos[keep]] = a_pad[keep]
        return out

    xg = K.gather_rows_plain(t["x"], rs)
    dyg = K.gather_rows_plain(t["dy"], rs)
    ua, dha = t["u"] * valid[:, None], t["dh"] * valid[:, None]   # slack rows zero
    xe, dye = expert_major(xg), expert_major(dyg)
    ue, dhe = expert_major(t["u"]), expert_major(t["dh"])
    w1t = t["w1"].transpose(1, 2).contiguous()
    b = 2                       # bf16 bytes
    tok = n * d * b             # x or dy, unsorted: every token once
    routed_g = rows * g * b     # u, h, t0 or dh: one row per routed row
    routed_d = rows * d * b     # y or dX before the scatter
    w_bf16, w_f32 = E * d * g * b, E * d * g * 4
    idx = rows * 4 + te.numel() * 4     # row_src of the routed rows, tile_expert
    gates = rows * 4
    flops = 2 * rows * d * g
    fused_specs = [
        ("fused_w1 relu+h (forward)",
         lambda: K.fused_w1(t["x"], rs, te, t["w1"], act="relu", save_preact=True),
         lambda: K.fused_w1_plain(t["x"], rs, te, t["w1"], act="relu", save_preact=True),
         lambda: torch.bmm(xe, t["w1"]),
         tok + w_bf16 + 2 * routed_g + idx, ("fused_w1 w1_save relu", "bfloat16")),
        ("fused_w1 identity (t0 = dy w2^T)",
         lambda: K.fused_w1(t["dy"], rs, te, t["w2t"], act="identity"),
         lambda: K.fused_w1_plain(t["dy"], rs, te, t["w2t"], act="identity"),
         lambda: torch.bmm(dye, t["w2t"]),
         tok + w_bf16 + routed_g + idx,
         ("fused_w1 t0 = dy w2^T identity, one expert empty", "bfloat16")),
        ("fused_w2 (forward)",
         lambda: K.fused_w2(t["u"], te, t["w2"], gate),
         lambda: K.fused_w2_plain(t["u"], te, t["w2"], gate),
         lambda: torch.bmm(ue, t["w2"]),
         routed_g + w_bf16 + routed_d + gates + te.numel() * 4, ("fused_w2", "bfloat16")),
        ("dw_streamed stream_x (dW1)",
         lambda: K.dw_streamed(t["x"], t["dh"], rs, te, E, stream_x=True),
         lambda: K.dw_streamed_plain(t["x"], t["dh"], rs, te, E, stream_x=True),
         lambda: torch.bmm(xe.transpose(1, 2), dhe),
         tok + routed_g + w_f32 + idx,
         ("dw_streamed stream_x (dW1), one expert empty", "bfloat16")),
        ("dw_streamed stream_g gated (dW2)",
         lambda: K.dw_streamed(t["u"], t["dy"], rs, te, E, stream_x=False, gate=gate),
         lambda: K.dw_streamed_plain(t["u"], t["dy"], rs, te, E, stream_x=False, gate=gate),
         lambda: torch.bmm(ue.transpose(1, 2), dye),
         routed_g + tok + w_f32 + gates + idx,
         ("dw_streamed stream_g gated (dW2), one expert empty", "bfloat16")),
        ("cvmm (dX = dh w1^T)",
         lambda: K.cvmm(t["dh"], te, w1t),
         lambda: K.cvmm_plain(t["dh"], te, w1t),
         lambda: torch.bmm(dhe, w1t),
         routed_g + w_bf16 + routed_d + te.numel() * 4, ("cvmm dX = dh w1^T", "bfloat16")),
    ]
    unfused_specs = [
        ("cvmm_dw dW1 = x_pad^T dh_pad",
         lambda: K.cvmm_dw(xg, te, dha, E),
         lambda: K.cvmm_dw_plain(xg, te, dha, E),
         lambda: torch.bmm(xe.transpose(1, 2), dhe),
         routed_d + routed_g + w_f32 + te.numel() * 4,
         ("cvmm_dw dW1 = x_pad^T dh_pad, one expert empty", "bfloat16")),
        ("cvmm_dw dW2 = u_pad^T dy_pad",
         lambda: K.cvmm_dw(ua, te, dyg, E),
         lambda: K.cvmm_dw_plain(ua, te, dyg, E),
         lambda: torch.bmm(ue.transpose(1, 2), dye),
         routed_g + routed_d + w_f32 + te.numel() * 4,
         ("cvmm_dw dW2 = u_pad^T dy_pad, one expert empty", "bfloat16")),
        ("cvmm h = x_pad w1 (unfused forward)",
         lambda: K.cvmm(xg, te, t["w1"]),
         lambda: K.cvmm_plain(xg, te, t["w1"]),
         lambda: torch.bmm(xe, t["w1"]),
         routed_d + w_bf16 + routed_g + te.numel() * 4,
         ("cvmm h = x_pad w1 (unfused forward), all experts", "bfloat16")),
        ("cvmm y = u_pad w2 (unfused forward)",
         lambda: K.cvmm(ua, te, t["w2"]),
         lambda: K.cvmm_plain(ua, te, t["w2"]),
         lambda: torch.bmm(ue, t["w2"]),
         routed_g + w_bf16 + routed_d + te.numel() * 4,
         ("cvmm y = u_pad w2 (unfused forward), all experts", "bfloat16")),
    ]
    specs = fused_specs if rung == "pallas_fused" else unfused_specs
    shape = (f"N {n} x top-{rows // n}, M_pad {m_pad}, d {d} (K_pad {k_pad}), G {g}, "
             f"E {E}")
    out = []
    for case, fn, plain, lib, nbytes, err_key in specs:
        bb, bf = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
        row = {"case": case, "shape": shape, "dtype": "bfloat16",
               "ms": _time_ms(fn), "plain_ms": _time_ms(plain), "library_ms": _time_ms(lib),
               "bound_ms": 1e3 * max(bb, bf), "bound_by": "bytes" if bb >= bf else "operations",
               "bound_bytes": nbytes, "bound_flops": flops, "max_abs_err": errs[err_key]}
        out.append(row)
        print(f"[{tag}] {case} bf16: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library (torch.bmm) {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


KERNELS = ("cvmm", "gather_rows", "fused_w1", "fused_w2", "dw_streamed", "cvmm_dw")


@contextmanager
def pinned_routing(routing, choices: list, replay: bool):
    """Record every top-k expert choice of ``repro_torch.core.routing`` into
    ``choices``, or replay the recorded choices in order; the gates are
    always this run's own scores at the chosen experts."""
    import torch
    orig = routing.top_k
    recorded = iter(choices)

    def top_k(s, k):
        if replay:
            idx = next(recorded)
            return torch.gather(s, -1, idx), idx
        vals, idx = orig(s, k)
        choices.append(idx)
        return vals, idx

    routing.top_k = top_k
    try:
        yield
    finally:
        routing.top_k = orig


@contextmanager
def pinned_impl(ops, impl: str):
    """Pin the sort path's rung (``ops.set_default_impl``), unpinned after."""
    ops.set_default_impl(impl)
    try:
        yield
    finally:
        ops.set_default_impl(None)


@contextmanager
def plain_kernels(K):
    """Route every kernel wrapper to its plain version, for comparison."""
    saved = {name: getattr(K, name) for name in KERNELS}
    for name in KERNELS:
        setattr(K, name, getattr(K, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


def _profile_decode_step(lm, params, dev, batch: int = 8, pos: int = 64):
    """Latency of one full-width paged decode step at ``batch`` lanes (mean
    of 5, host clock around synchronized steps), then one step under
    torch.profiler: device busy share and the kernels that take the time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import dispatch
    from repro_torch.serving import DecodePlanCache, make_provider

    cache = lm.init_paged_cache(1 + batch * 8, 16, device=dev)
    tables = torch.arange(1, 1 + batch * 8, dtype=torch.int32, device=dev).reshape(batch, 8)
    tok = torch.ones(batch, dtype=torch.int64, device=dev)
    positions = torch.full((batch,), pos, device=dev)
    dispatch.set_decode_provider(make_provider(DecodePlanCache(), max_tokens=batch))
    try:
        def step():
            lm.decode_step_paged(params, cache, tok, positions, tables)
            torch.cuda.synchronize()
        step()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        dispatch.set_decode_provider(None)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"[4] decode step, {batch} lanes at position {pos}: {step_ms:.2f} ms "
          f"(mean of 5); profiled step {wall_ms:.2f} ms wall, device busy "
          f"{busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f}% "
          f"({sum(e.count for e in kernels)} kernel launches)")
    for e in top:
        print(f"[4]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return {"batch": batch, "step_ms": step_ms, "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "kernel_launches": sum(e.count for e in kernels),
            "top": [(e.key, e.count, e.self_device_time_total / 1e3) for e in top]}


def _greedy(lm, params, prompt, max_new, dev):
    """Contiguous-cache greedy decoding, one request."""
    import torch
    cache = lm.init_cache(1, 64, device=dev)
    lg, cache = lm.prefill(params, torch.as_tensor([prompt], device=dev), cache)
    out = [int(lg[0].argmax())]
    pos = len(prompt)
    while len(out) < max_new:
        lg, cache = lm.decode_step(params, cache, torch.as_tensor([out[-1]], device=dev), pos)
        out.append(int(lg[0].argmax()))
        pos += 1
    return out


def _time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


if __name__ == "__main__":
    main()
