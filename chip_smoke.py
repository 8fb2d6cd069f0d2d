#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases (any failure exits non-zero before the result line):

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
7. one ``{"kernels": [...]}`` JSON line, then the device line last.

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

    # ------------------------------------------------------------- 7. report
    def row(kernel, shape, source, replaces):
        t = next(t for t in timings if t["kernel"] == kernel and t["shape"] == shape
                 and t["dtype"] == "bfloat16")
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[kernel], "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": shape, "dtype": "bfloat16"}

    line = {"kernels": [
        row("cvmm", f"M_pad 5120 {D}->{G} E {E}", "src/repro_torch/kernels/csrc/cvmm.cu",
            "src/repro/kernels/cvmm.py:241"),
        row("gather_rows", f"n 8 d {D} into 128 rows",
            "src/repro_torch/kernels/csrc/gather_rows.cu",
            "src/repro/kernels/cvmm.py:621")]}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1, default=str))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@contextmanager
def plain_kernels(K):
    """Route the kernel wrappers to their plain versions, for comparison."""
    saved = K.cvmm, K.gather_rows
    K.cvmm, K.gather_rows = K.cvmm_plain, K.gather_rows_plain
    try:
        yield
    finally:
        K.cvmm, K.gather_rows = saved


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
