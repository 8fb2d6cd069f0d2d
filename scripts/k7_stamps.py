#!/usr/bin/env python3
"""Where a K7 block's time goes: clock64 stamps at the stages of the bf16
body of ``csrc/flash_attention.cu``, on one CUDA card.

    python3 scripts/k7_stamps.py [--variant base|no-pingpong|no-exp|no-pv] [--out DIR]

The profiler sees a kernel whole; this script looks inside one. It copies
this checkout's ``src`` to DIR (default ``build/k7_stamps/<variant>``, a
directory ``.gitignore`` lists), adds ``clock64()`` stamps to the copy's
kernel (a ``__device__`` array read back through an extra ``extern "C"``
function), builds the copy and runs K7 at serve-long's last full prefill
chunk (256 rows at q_offset 3,072, kv_len 3,328 of a 4,096-key pool) and at
serve's short chunk (32 rows at q_offset 64, kv_len 96 of 128), granite-moe's
24/8 heads of 64 in bf16. For each stage it prints the cycles from a block's
entry (median, min and max over the blocks that reach it) and the launch's
span on the global timer. A variant removes one part of the mainloop, to
time what is left (its outputs are wrong): ``no-pingpong`` the warpgroups'
turns on named barriers, ``no-exp`` the exponentials (a multiply instead),
``no-pv`` the P V products.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAGES = {10: "producer past the block barrier", 3: "Q rows stored", 4: "first tile landed",
          5: "first tile's softmax done", 6: "mainloop done", 7: "last P V done",
          11: "partial stored, counter added", 2: "output: 1 / l", 15: "output: staged",
          14: "output: warpgroup synced", 8: "end"}


def stamp(src: str, variant: str) -> str:
    """The kernel source with the stamps (and the variant's cut) added."""
    def after(anchor: str, text: str) -> None:
        nonlocal src
        if anchor not in src:
            sys.exit(f"k7_stamps: the kernel source no longer has {anchor!r}")
        src = src.replace(anchor, anchor + text, 1)

    def replace(old: str, new: str) -> None:
        nonlocal src
        if old not in src:
            sys.exit(f"k7_stamps: the kernel source no longer has {old!r}")
        src = src.replace(old, new)

    replace("namespace {\n\nusing bf16 = __nv_bfloat16;",
            "__device__ unsigned long long g_stamps[4096][16];\n"
            "#define STAMP(k) do { if (blockIdx.x < 4096) "
            "g_stamps[blockIdx.x][k] = clock64(); } while (0)\n"
            "__device__ __forceinline__ unsigned long long gtime() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n"
            "namespace {\n\nusing bf16 = __nv_bfloat16;")
    after("  const int n = max(0, min((split + 1) * n_all / n_split, (kvl + BK - 1) / BK) - lo);\n",
          "  if (threadIdx.x == 0 && blockIdx.x < 4096) {\n"
          "    g_stamps[blockIdx.x][0] = gtime();\n"
          "    g_stamps[blockIdx.x][1] = clock64();\n"
          "    g_stamps[blockIdx.x][12] = n;\n"
          "    g_stamps[blockIdx.x][13] = n_split;\n  }\n")
    after("  __syncthreads();\n\n  if (tid >= CONSUMERS) {", "\n    if (tid == CONSUMERS) STAMP(10);")
    after("    named_sync(ws::kQ + wg, 128);\n", "    if (tid == 0) STAMP(3);\n")
    after("      mbar_wait(&full[0], 0);\n", "      if (tid == 0) STAMP(4);\n")
    after("      softmax(0);\n      rescale();\n", "      if (tid == 0) STAMP(5);\n")
    replace("    if (n > 0) {\n      wgmma_fence();\n      issue_pv(",
            "    if (tid == 0) STAMP(6);\n    if (n > 0) {\n      wgmma_fence();\n      issue_pv(")
    after("    if (wg == 0) named_sync(ws::kSched, CONSUMERS);  // warpgroup 1's last turn\n",
          "    if (tid == 0) STAMP(7);\n")
    after("      const float inv[2] = {1.0f / fmaxf(sum[0], 1e-20f), 1.0f / fmaxf(sum[1], 1e-20f)};\n",
          "      if (tid == 0) STAMP(2);\n")
    replace("      named_sync(ws::kQ + wg, 128);\n      // With D >= 64",
            "      if (tid == 0) STAMP(15);\n      named_sync(ws::kQ + wg, 128);\n"
            "      if (tid == 0) STAMP(14);\n      // With D >= 64")
    done = "if (tid == 0) { STAMP(8); g_stamps[blockIdx.x][9] = gtime(); }"
    replace("      store(o, l);\n      return;", f"      store(o, l);\n      {done}\n      return;")
    replace("    if (!last_s) return;",
            f"    if (tid == 0) STAMP(11);\n    if (!last_s) {{\n      {done}\n      return;\n    }}")
    replace("    store(o, sum);\n  }\n}", f"    store(o, sum);\n    {done}\n  }}\n}}")
    if variant == "no-pingpong":
        replace("      named_sync(ws::kSched + wg, CONSUMERS);\n", "")
        replace("      named_arrive(ws::kSched + (wg ^ 1), CONSUMERS);\n", "")
        replace("    if (wg == 1) named_arrive(ws::kSched, CONSUMERS);\n", "")
        replace("    if (wg == 0) named_sync(ws::kSched, CONSUMERS);", "    if (false)")
    elif variant == "no-exp":
        replace('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = x * 0.5f;")
    elif variant == "no-pv":
        replace("      issue_pv(ring + (j - 1) % STAGES * S::STAGE);\n      wgmma_commit();\n",
                "      wgmma_commit();\n")
    return src + """
extern "C" int repro_flash_stamps(void* dst, void* stream) {
  return (int)cudaMemcpyFromSymbolAsync(dst, g_stamps, sizeof(g_stamps), 0,
                                        cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
}
extern "C" int repro_flash_stamps_clear(void* stream) {
  void* p = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&p, g_stamps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemsetAsync(p, 0, sizeof(g_stamps), (cudaStream_t)stream);
}
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="base", choices=("base", "no-pingpong", "no-exp", "no-pv"))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    out = args.out or ROOT / "build" / "k7_stamps" / args.variant
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "src", out / "src")
    cu = out / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
    cu.write_text(stamp(cu.read_text(), args.variant))
    sys.path.insert(0, str(out / "src"))
    import torch
    from repro_torch.kernels import build, flash_attention as K7

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    lib = build.load("flash_attention")
    gen = torch.Generator(device=dev).manual_seed(0)
    H, KV, D = 24, 8, 64
    for label, sq, pool, off, kvl in (("serve-long chunk", 256, 4096, 3072, 3328),
                                      ("serve chunk", 32, 128, 64, 96)):
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
                   for s in ((1, sq, H, D), (1, pool, KV, D), (1, pool, KV, D)))
        kw = dict(causal=True, scale=D ** -0.5, q_offset=off,
                  kv_len=torch.tensor([kvl], device=dev))
        for _ in range(20):                  # warm-up
            K7.flash_attention(q, k, v, **kw)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if lib.repro_flash_stamps_clear(stream):
            sys.exit("k7_stamps: clearing the stamps failed")
        K7.flash_attention(q, k, v, **kw)    # the call that is read
        buf = torch.zeros(4096 * 16, dtype=torch.int64, device=dev)
        if lib.repro_flash_stamps(ctypes.c_void_p(buf.data_ptr()), stream):
            sys.exit("k7_stamps: reading the stamps failed")
        torch.cuda.synchronize()
        rows = [r for r in buf.view(4096, 16).tolist() if r[0]]
        t0 = min(r[0] for r in rows)
        print(f"[{args.variant}] K7 {label}: {len(rows)} blocks, key tiles a block "
              f"{sorted({r[12] for r in rows})}, splits {sorted({r[13] for r in rows})}; "
              f"launch span {(max(r[9] for r in rows) - t0) / 1e3:.2f} us on the global timer")
        for idx, name in STAGES.items():
            vals = [r[idx] - r[1] for r in rows if r[idx]]
            if vals:
                print(f"[{args.variant}]   {name:32s} cycles from entry: median "
                      f"{statistics.median(vals):7.0f}, min {min(vals)}, max {max(vals)} "
                      f"({len(vals)} blocks)")


if __name__ == "__main__":
    main()
