#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases (any failure exits non-zero before the result line). 1-6 are the
serving slice, 7-10 the training slice on the fused rung, 11-14 training on
the unfused rung, 15-18 K7 and the long-prompt serving run, A-E the paper's
dense/sigma-MoE pairs, their eval step and checkpoint/resume, F-H the
paper's PKM and top-K MLP on K6, forward and backward, I-K the paper's MoE
baselines (Switch, S-BASE, noisy top-k), the capacity dispatch and the
trainer's gradient accumulation, compression and remat, L-N the reference's
other architectures (Mamba2, zamba2's hybrid, whisper, pixtral and the
llama-likes) served from the contiguous cache, with K7 at head size 112, O
the tile layer (shared memory, the autotuner's tuned mode), P expert
parallelism on a one-rank NCCL mesh:

1. the card: torch's device name and nvidia-smi's name and power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print ptxas' register/shared-memory report;
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, in bf16 and float32: K4 at decode (M_pad 5,120 and
   10,240) and at serve-long's prefill chunk (M_pad 81,920, the chunk's 256
   tokens' top-8 rows in the decode plan's slots), w1 (1,536 -> 512) and w2
   (512 -> 1,536) widths, bf16 also within 1e-2 normwise and every K4 the
   same bits on a second call; the bf16 gate must also reject a K4 that
   drops one 64-deep ring stage or reads it twice; K6 exactly, weighted and
   not, at decode (1, 8 and 32 tokens) and at the prefill chunk's 256, and
   at one vector a row (K_pad 8, bf16) through an unsorted ``row_src``;
4. the main path: ``repro_torch.serving.Engine`` serving 8 requests on
   granite-moe-3b-a800m (sort dispatch) at full width and depth, random
   weights from ``--seed``; every MoE call must run on the two kernels,
   and every prefill chunk's attention on K7 (none at decode);
5. end to end, kernels against plain versions: one paged prefill and one
   paged decode step at full width and depth 2; then the Engine's greedy
   tokens against contiguous-cache greedy decoding on the reduced config;
6. each kernel timed by back-to-back CUDA events and device alone beside
   its bound, its plain version and one PyTorch library call for the same
   function, timed the same two ways: K4 at decode and at the prefill
   chunk's two widths (``torch.bmm``), K6 at decode and at the prefill
   chunk (``index_select``);
7. the training kernels (K1 in its four variants, K2, K3 in its three)
   against their plain versions at wt103-47m-moe's training shapes (batch
   32 x 257 tokens, top-4 of 16 experts), in bf16 (K1, K2 and K4 also
   within 1e-2 normwise) and float32, with an expert that gets no rows and
   all-sentinel slack tiles (K2's slack rows zero), and K3 also on a skewed
   plan (one expert with 3x the mean rows, over many of its chunks); K1,
   K2, K4 and the skewed K3 give the same bits on a second call; the bf16
   gate must also reject a K2 that applies row r + 8's gate to row r;
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
    share, top kernels, exactly one K1, K2, K3 and K4 device kernel per
    wrapper call, so K2 and K4 are told apart),
    each training kernel timed by back-to-back events and device alone
    beside its bound, its plain version and a ``torch.bmm`` yardstick,
    and K3's three variants on the uniform plan and on the profiled
    step's own (layer 0's) plan;
11. the unfused rung's kernels (K5 for dW1 and dW2, K4 for the forward's w1
    and w2 calls) against their plain versions at the training shapes, in
    bf16 (K4 also within 1e-2 normwise) and float32, with an expert that
    gets no rows and all-sentinel slack tiles, and on phase 7's skewed plan
    (K4 the same bits twice on every plan, K5 on the skewed one);
12. phase 8's step on the unfused rung (``ops.set_default_impl("pallas")``)
    with phase 8's three gates, and its float32 full-depth step on the
    unfused kernels against the fused rung's kernels (same expert choices);
13. phase 9's run on the unfused rung: finite, falling loss, exactly 4 K4
    and 2 K5 per MoE layer every step and no K1, K2 or K3, and a last-5
    mean loss within 2 % of phase 9's;
14. phase 10's measurements of that run (one K4 and K5 device kernel per
    call),
    K5 (and K4's forward calls) timed beside the bound, the plain version
    and ``torch.bmm``, and K5 on the uniform and the step's own plan;
15. K7 against its plain version on the card, in bf16 and float32: the
    reference oracle's five cases, granite-moe's heads at 256-row chunks
    (offsets 0, 256, 1,280 and serve-long's last two) against a 4,096-key
    pool, two batch rows with different ``kv_len``, and head size 16, each
    the same bits on a second call; the bf16 gate must also reject a K7
    whose softmax scale is 10 % off, one that reads three keys past
    ``kv_len``, and split merges that drop the 64 keys at a split boundary
    or count them twice (emulated through the inputs);
16. serve-long: the Engine serving LongBench's multi-document QA as a
    4k-context model sees it (prompts at its 3,500-token cut, 32 new tokens
    each, prefill chunks of 256) on granite-moe at full width and depth;
    exact K7, K4 and K6 counts, wall time, tok/s, peak memory, and one
    profiled prefill chunk (one K7 device kernel per wrapper call);
17. end to end, K7 against its plain version: a depth-2 bf16 paged prefill
    of a 600-token prompt in three chunks (which must also reject a K7 with
    its softmax scale 10 % off), and a float32 full-depth prefill of a
    1,024-token prompt in four, with the expert choices pinned, prompts from
    a generator of the phase's own; the argmax may differ only where the
    reference's logits tie within the tolerance (``argmax_agrees``);
18. K7 timed at serve-long's last full prefill chunk and at serve's short
    chunk beside its bound (bytes, tensor products or exponentials), its
    plain version and ``scaled_dot_product_attention`` with K/V cut to
    ``kv_len`` and a lower-right causal mask (the backend it took named),
    by CUDA events around back-to-back calls and around calls queued
    while the device sleeps (the device's time alone), with the bf16
    kernel's schedule and ptxas' registers, spills and shared memory;
A. the training kernels (phase 7's cases) against their plain versions at
   wt103-262m-moe's and enwik8-41m-moe's training shapes (batch 16 x 513
   tokens, top-4 of 32 and of 16 experts, d_model 1,024 and 512), and each
   timed as phase 10 does;
B. phase 8's step gates on one full-width wt103-262m-moe step (batch 16 x
   512) under PyTorch's deterministic algorithms, so that both sides differ
   only in the kernels' arithmetic; a bf16 depth-2 step whose losses pass
   2e-2 but whose worst gradient leaf does not is held to the yardstick
   instead (at this width that leaf, layer 0's XL ``w_r``, sits at bf16's
   noise), after the plain versions' step is run twice to show the
   comparison's own noise; that depth-2 rule must pass on three more seeds
   and reject, by the yardstick alone too, a planted K2 fault (gate rows
   exchanged) and a planted K4 fault (a 64-deep stage dropped);
C. the paper's larger pair, wt103-262m-dense then wt103-262m-moe, through
   ``python -m repro_torch.launch.train --steps 30 --batch 16 --seq 512`` at
   full width and depth in process, on one seed: finite, falling loss,
   exactly 2 K1, 1 K2, 2 K3 and 1 K4 per MoE layer every step of the
   sigma-MoE run and none in the dense run, step time, tokens/s, peak
   memory, both parameter counts (equal to the reference's) and their
   ratio; then the eval step on 4 held-out batches (seed + 1,000), finite
   and below each model's step-0 training loss;
D. the same for the byte-level pair enwik8-41m-dense and enwik8-41m-moe,
   with ``--data`` a corpus of the repo's own files (the Python sources
   under src/ and tests/ and the top-level Markdown files, sorted, bytes
   concatenated), and bits per byte on the held-out batches;
E. checkpoint and resume: wt103-47m-moe at full width (batch 32 x 256, 12
   steps, ``--ckpt-every 6``), run A uninterrupted, run B failing at step
   6 after its checkpoint committed and resumed with ``--resume`` ("[resume]
   restored step 6"), run C uninterrupted again; B must equal A bit for bit
   if C does, else stay within 2x C's worst per-leaf distance from A; the
   gate must reject resumes with the dropout generator's or the data
   iterator's state left fresh;
F. K6 at the swapped FFNs' shapes (wt103-47m-dense with ``--ffn pkm``: 4
   heads x top-32 of 2,025 values for 32 x 257 tokens, 1,052,672
   selections; ``--ffn topk``: top-256 of 2,053 W2 rows, 2,105,344), on
   the dedup plans built from one random layer's real selections, and on
   PKM's one-slot-a-selection ``GatherPlan`` with the weight in K6's
   epilogue: exactly its plain version in bf16 and float32, the same bits
   on a second call; the two autograd Functions (forward, dvalues,
   dweights), kernels against plain versions within phase 3's
   tolerances; K6 timed device alone beside its bound and
   ``index_select``;
G. one full-width training step of each swap (depth 16, bf16), kernels
   against plain versions on the same selections under deterministic
   algorithms: the losses and every gradient leaf equal bit for bit, and
   the gate must reject a K6 that reads one row of each 128-row block from
   its neighbour;
H. the main path: ``python -m repro_torch.launch.train --arch
   wt103-47m-dense --ffn pkm`` (and ``--ffn topk``, and without ``--ffn``
   as the dense baseline) ``--steps 15 --batch 32 --seq 256`` in process:
   finite, falling loss, exactly 2 K6 a swapped layer every step and no
   K1-K5, the eval step on 4 held-out batches (seed + 1,000) below step 0's
   loss with 1 K6 a layer, step time, tokens/s, peak memory, a profile
   with one K6 device kernel per wrapper call, parameter counts equal to
   the reference's, and for PKM the share of the values the last batch
   selected (``collect_stats``; no gate);
I. gates: the capacity ("einsum") dispatch on one wt103-47m-moe layer (32 x
   257 tokens) at a capacity that drops nothing, against the sort path's
   kernels on the same routing (bf16 3e-2 and 1e-2 normwise, float32
   1e-4); its dropped share at capacity factors 1.25 and 0.25 equal to a
   host count of the overflow; one full-depth float32 step of S-BASE and of
   noisy top-k, kernels against plain versions on pinned routing (phase 8's
   float32 gate, 2e-3 a leaf); under deterministic algorithms with dropout
   on, ``remat`` "full" and "dots" gradients bit-equal to the plain step's,
   the generator ending in the same state, with exact launches;
J. the baselines trained: S-BASE, noisy top-k and Switch (``BASELINES``,
   built in process) and ``python -m repro_torch.launch.train --arch
   wt103-47m-dense --ffn sigma_moe`` (the capacity dispatch), 15 steps at
   batch 32 x 256, full width and depth: finite, falling loss, exact
   launches every step (2 K1, 1 K2, 2 K3, 1 K4 a layer on the sort
   dispatch, none on the capacity dispatch), the dropped share, parameter
   counts equal to the reference's, and a profiled step;
K. the trainer's options on wt103-47m-moe, 10 steps each: ``--grad-accum 2``
   (twice the launches), ``--grad-compression int8`` (every residual within
   half a quantization step) and ``bf16``, ``--remat full`` and ``dots`` (3
   K1, 2 K2, 2 K3, 1 K4 a layer; peak memory beside phase 9's, full below
   it): finite, falling loss and exact launches every step;
L. K7 at zamba2-7b's head size 112 (its 4 x 600 prefill, a chunk at 512
   over a longer cache, a chunk whose keys split over the card) and at
   every shape phase N gives it (llama3 and pixtral 32/8 at 600 and 856
   rows, deepseek 56/8, llama4-scout 40/8, gemma3's global 32/16 at 1,100,
   minicpm 36/36, whisper's encoder over 1,500 frames, its decoder, and
   its cross-attention at 600 rows and 1) against its plain version in
   bf16 and float32 with phase 15's gates; the bf16 gate must reject K7
   built with a planted fault in D 112's padding (``K7_FAULTS``); the D
   112 prefill timed beside its bound and ``scaled_dot_product_attention``;
M. zamba2-7b at full width and depth (81 slots), bf16: 4 prompts of 600
   tokens through ``LM.prefill`` on the contiguous cache, then 32 greedy
   ``LM.decode_step``s each: exactly 13 K7 launches a prefill (its shared
   attention slots) and none at decode, finite logits, time to the first
   token, decode tok/s and peak memory; at one pattern period (6 slots)
   prefill logits with K7 against its plain version (bf16 3e-2, float32
   1e-3, ``argmax_agrees``), and in float32 the decode steps' logits against one forward's
   (1e-3);
N. mamba2-370m as phase M at full depth (48 SSM layers, no kernel), and
   llama3-8b, deepseek-coder-33b, minicpm-2b (2 layers), gemma3-27b (5
   local and 1 global), llama4-scout (2 layers, sort dispatch, decode on
   decode plans: K6 and K4), pixtral-12b (2 layers after a 256-token
   image prefix) and whisper-tiny (4 + 4 layers over 1,500 frames) at full
   width in float32: prefill and 8 decode steps against the forward
   (1e-3), the prefill with the kernels against their plain versions
   (1e-3), K7 launches as the config implies (one a layer without a
   window; whisper's encoder and cross-attention too, and 4 a decode
   step); llama4-scout's K4 and K6 against their plain versions at its
   widths;
O. the tile layer: every bf16 kernel instance's shared memory as its
   launcher requests it (each source's ``repro_*_smem`` query, dynamic and
   static) equal to ``analysis/smem.py``'s inventory and within the card's
   opt-in limit (``cudaDevAttrMaxSharedMemoryPerBlockOptin``), every
   candidate the tuner emits on the analysis grid one of those instances;
   then tuned mode (``kernels/autotune.py``) on a cache of its own: the
   picks at serve decode (K4, K6), serve-long's chunk (K4, K6, K7) and the
   47M training shapes (K1-K5) against their plain versions within their
   kernels' gates (phases 3, 7 and 15), the wrapper's own decision the same
   bits as its pick, each pick timed device alone beside the heuristic's; a
   cold cache times at least one candidate, a warm one none; a 10-step
   tuned wt103-47m-moe run from a cold cache times candidates in steps 1-2
   only, its loss finite and falling. Tuning is off again afterwards;
P. expert parallelism (``dispatch="shard_map"``) on a real NCCL process
   group of one rank (a file store in a temporary directory) and the mesh
   (data 1, model 1): one wt103-47m-moe layer on 32 x 256 tokens (top-4 of
   16, d 412, G 128), in bf16 and float32, K4/K5 against their plain
   versions on the same routing (bf16 3e-2 and 1e-2 normwise, float32
   1e-4; float32 gradients of x, we1 and we2 within 2e-4 relative), exactly
   2 K4 and 2 all_to_alls forward, 2 K4, 2 K5 and 2 all_to_alls backward
   and no other kernel, the dropped share at capacity factors 1.25 and 0.25
   equal to a host count of the overflow, and at factor 4.0 (= E/k, nothing drops)
   the sort path's kernels on the same routing within phase I's gates; K4
   and K5 on the EP buffer (16 x 2,560 rows) timed beside their bound, plain
   versions and ``torch.bmm``; 10 steps of wt103-47m-moe with
   ``dispatch="shard_map"`` at batch 32 x 256, full width and depth, in
   process on the mesh: finite, falling loss, exactly 4 K4, 2 K5 and 4
   all_to_alls a layer every step, step time, tokens/s and peak memory
   beside phases 9 and 13; in float32 at full depth, the first 3 losses and
   one step's gradients on the mesh against the same with no mesh (the
   capacity dispatch on ``torch.bmm``) within 2e-3 a leaf on pinned
   routing under deterministic algorithms; and under deterministic algorithms 5 steps of the sort
   dispatch on the mesh equal to 5 with no mesh bit for bit, with phase
   9's launches;
19. one ``{"kernels": [...]}`` JSON line (with A's wt103-262m-moe rows of
    K1, K2, K3 and K4, their launches from C, K6's rows at F's shapes,
    their launches from H, the K1-K4 rows' launches in J's and K's runs,
    K7's row at D 112 from L and its launches in M and N, and K4's and
    K6's launches at llama4-scout's decode in N, and K4's and K5's rows on
    P's EP buffer with their launches in P's 10-step run), then the device
    line last.

With ``--out``, the full results (every phase's numbers and the ptxas
reports) are also written there as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no TF32
EXP_PER_S = 132 * 16 * 1.83e9
# exp2 results a second on an H100 SXM: 16 a clock on each of 132 SMs (the
# CUDA programming guide's throughput table, compute capability 9.0) at the
# 1.83 GHz that 989 TFLOP/s implies (4,096 bf16 operations an SM a clock).
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
PAIRS = {"wt103": ("wt103-262m-dense", "wt103-262m-moe"),
         "enwik8": ("enwik8-41m-dense", "enwik8-41m-moe")}
PAIR = dict(batch=16, seq=512, steps=30, eval_batches=4)
# The paper's parameter-equal dense/sigma-MoE pairs (Tab. 8/9) at their
# published widths and depths, at batch 16 x 512 (512 tokens a segment, the
# configs' XL context), trained phase 9's 30 steps from one seed.
PAPER_PARAMS = {"wt103-262m-dense": 262_772_736, "wt103-262m-moe": 262_846_464,
                "enwik8-41m-dense": 41_518_080, "enwik8-41m-moe": 41_554_944,
                "wt103-47m-dense": 47_370_872, "wt103-47m-dense --ffn pkm": 34_839_480,
                "wt103-47m-dense --ffn topk": 47_370_872,
                "wt103-47m-moe sbase": 47_410_424, "wt103-47m-moe noisy_topk": 47_515_896,
                "wt103-47m-moe switch": 47_331_320,
                "wt103-47m-dense --ffn sigma_moe": 47_410_424}
# The reference's parameter counts (jax.eval_shape of its LM.init;
# tests/test_torch_paper_configs.py, for the swaps
# tests/test_torch_ffn_swap.py, and for the baselines and the sigma-MoE swap
# tests/test_torch_trainer_options.py hold the port's counts to them).
BASELINES = {
    "sbase": dict(kind="sbase"),
    "noisy_topk": dict(kind="noisy_topk", selector_activation="softmax", renormalize=True,
                       reg_kind="cv", reg_gamma=1e-2),
    "switch": dict(kind="switch", n_experts=4, expert_size=512, k=1, d_ff=2048,
                   selector_activation="softmax", reg_kind="switch", reg_gamma=1e-2,
                   dispatch="einsum", capacity_factor=1.25)}
# Phases I-J: the paper's MoE baselines (Tab. 4), each wt103-47m-moe's FFN
# with these fields replaced (dataclasses.replace). S-BASE and noisy top-k
# keep its 16 experts of 128, top-4, on the sort dispatch (8 Sinkhorn
# iterations; softmax gates renormalized, router noise, cv regularizer
# 1e-2). Switch keeps its 2,048 expert channels and 512 active ones as
# table4_ablations.py pairs them: 4 experts of 512, top-1, softmax, switch
# regularizer 1e-2, capacity factor 1.25 on the capacity dispatch.
BASE_RUN = dict(arch="wt103-47m-moe", batch=32, seq=256, steps=15, option_steps=10)
EP = dict(arch="wt103-47m-moe", tokens=32 * 256, steps=10, sort_steps=5)
# Phase P: expert parallelism on one layer of wt103-47m-moe's step (32 x
# 256 tokens, top-4 of 16 experts), then its 10-step run with
# dispatch="shard_map" at BASE_RUN's batch, and 5 sort-dispatch steps.
# Phases J and K: phase 9's model and batch; the FFN runs 15 steps, the
# trainer options (gradient accumulation, compression, remat) 10 each.
# (30 steps each here and in SWAP until the script passed half its limit
# on slower hosts: 622-632 s; the timed mean is then of steps 5-14.)
SWAP = dict(arch="wt103-47m-dense", kinds=("pkm", "topk"), batch=32, seq=256, steps=15,
            eval_batches=4)
# Phases F-H: the paper's top-K MLP and PKM (Sec. 3.1, 3.2) swapped into the
# 47M dense baseline by the reference's --ffn rule (PKM: 45**2 = 2,025 values,
# 4 heads, top-32; top-K: K 256 of d_ff 2,053), at phase 9's batch; each
# layer call sees 32 x 257 tokens.
RESUME = dict(arch="wt103-47m-moe", batch=32, seq=256, steps=12, every=6)
# Phase E: phase 9's model and batch, checkpointed every 6 of 12 steps.
LONG = dict(arch="granite-moe-3b-a800m", requests=16, prompt=3500, max_new=32,
            max_batch=4, max_len=4096, page_size=16, prefill_chunk=256, burst_steps=8)
# serve-long (phase 16): retrieval-augmented QA over long documents, where
# prefill attention, not decode, sets the time to the first token. Lengths
# from LongBench (Bai et al. 2023, arXiv:2308.14508), multi-document QA
# (HotpotQA, 2WikiMQA, MuSiQue) as its harness runs a 4k-context model:
# prompts cut to 3,500 tokens (config/model2maxlen.json), at most 32 new
# tokens (config/dataset2maxlen.json). max_len is granite's 4,096 context.
# Each task has 200 requests; 16 keep the script, with phases A-N, inside
# half its time limit (64 took 250-463 s alone, host-bound; 32 took 160-189
# s, which with phases I-K passed half the limit; 16 took 86-118 s).
SERVE_E, SERVE_D, SERVE_G = 40, 1536, 512      # granite-moe-3b-a800m's MoE widths
K4_CASES = [(5120, SERVE_D, SERVE_G, "decode"), (5120, SERVE_G, SERVE_D, "decode"),
            (10240, SERVE_D, SERVE_G, "decode"), (5120, SERVE_D, SERVE_G, "random"),
            (81920, SERVE_D, SERVE_G, "prefill"), (81920, SERVE_G, SERVE_D, "prefill")]
# K4 (M_pad, K, N, layout) in phases 3 and 6: serving decode (one and two
# tiles an expert), a random tile layout, and serve-long's prefill chunk
# (M_pad 81,920 = 40 experts x 2,048 rows on the decode plan), at w1's and
# w2's widths.
K6_TOKENS = (1, 8, 32, LONG["prefill_chunk"])
# K6 in phases 3 and 6: decode at 1, 8 and 32 tokens (one 128-row block,
# mostly sentinels) and serve-long's prefill chunk of 256 (256 rows).
K7_TOL = {"bfloat16": 3e-2, "float32": 5e-5}
# K7 against its plain version: the reference oracle's tolerances
# (tests/test_kernels_flash.py); bf16 also rounds P to bf16 for the P V
# product, float32 only sums in another order.
BF16_ULPS, BF16_REL = 4, 1e-2
# bf16 gates also hold ||got - want|| / ||want|| to BF16_REL and, for K7's
# own output, |got - want| to BF16_ULPS bf16 ulps of max|want|: K7 and its
# plain version round the same float32 result to bf16 once, so they differ
# by an ulp where a rounding lands apart (and by P's bf16 rounding).
K7_ORACLE = [(2, 128, 128, 4, 2, 128, True), (1, 256, 256, 2, 2, 128, True),
             (1, 100, 100, 4, 4, 128, True), (2, 128, 128, 4, 2, 128, False),
             (1, 384, 384, 8, 2, 128, True)]     # (B, Sq, Sk, H, KV, D, causal)
E2E_TOL = {"bfloat16": 3e-2, "float32": 1e-3}
# Prefill logits, K7 against its plain version with the same expert
# choices: bf16 at depth 2 as phase 5; float32 at full depth, 32 layers of
# float32 sums in another order.

D112_CASES = [("zamba2 prefill", 4, 600, 600, 32, 32, 112, True, 0, None),
              ("zamba2 chunk at 512", 1, 256, 1024, 32, 32, 112, True, 512, (768,)),
              ("zamba2 split keys", 1, 128, 4096, 32, 32, 112, True, 3968, (4096,)),
              ("llama3-8b 32/8", 2, 600, 600, 32, 8, 128, True, 0, None),
              ("deepseek 56/8", 2, 600, 600, 56, 8, 128, True, 0, None),
              ("llama4-scout 40/8", 2, 600, 600, 40, 8, 128, True, 0, None),
              ("gemma3 32/16 global", 2, 1100, 1100, 32, 16, 128, True, 0, None),
              ("minicpm 36/36", 2, 600, 600, 36, 36, 64, True, 0, None),
              ("pixtral 32/8 after 256 patches", 2, 856, 856, 32, 8, 128, True, 0, None),
              ("whisper encoder", 2, 1500, 1500, 6, 6, 64, False, 0, None),
              ("whisper decoder self", 2, 600, 600, 6, 6, 64, True, 0, None),
              ("whisper cross", 2, 600, 1500, 6, 6, 64, False, 0, None),
              ("whisper cross at decode", 2, 1, 1500, 6, 6, 64, False, 0, None)]
# Phase L, (label, B, Sq, Sk, H, KV, D, causal, q_offset, kv_len): K7 at
# zamba2-7b's head size 112 (its 4 x 600-token prefill, a 256-row chunk
# over a longer cache, a chunk whose keys split over the card), then every
# shape phase N's prefill and decode give K7: the groupings the other new
# archs bring (4, 7, 5, 2 and 1 query heads a KV head) at NEW_RUN's 2 x 600
# rows (gemma3's global layer over 1,100, pixtral's 256 patches and 600
# tokens), and whisper's encoder, decoder and cross-attention over its
# 1,500 encoder frames.
K7_FAULTS = {1: "output rows staged at D's pitch",
             2: "Q's pad columns 112-127 non-zero and read, against K pads of 1.0 in odd keys"}
# Phase L: faults planted in the padding of D 112 at compile time
# (csrc/flash_attention.cu's K7_FAULT), each a library of its own that
# ``build.build(defines=)`` makes beside phase 2's build and
# ``build.selected`` puts behind K7's wrapper.
HYBRID = dict(arch="zamba2-7b", batch=4, prompt=600, max_new=32, depth=6, gate_new=8)
# Phases M and N: zamba2-7b served at full width and depth (81 slots: 13 x
# [5 SSM, shared attention + GLU], then 3 SSM) from the contiguous cache, 4
# prompts of 600 tokens (not a multiple of the 256-token SSD chunk) and 32
# greedy tokens each; the gates at one pattern period (6 slots), float32
# decode against the forward over 8 tokens. mamba2-370m the same.
NEW_ARCHS = {"mamba2-370m": None, "llama3-8b": 2, "deepseek-coder-33b": 2, "minicpm-2b": 2,
             "gemma3-27b": 6, "llama4-scout-17b-a16e": 2, "pixtral-12b": 2,
             "whisper-tiny": None}
NEW_RUN = dict(batch=2, prompt=600, long_prompt=1100, decode=8)
# Phase N: each arch at full width and one pattern period of depth (None:
# its own depth; whisper 4 + 4 layers), float32, 2 prompts of 600 tokens
# (gemma3's 1,100, past its 1,024-token window) and 8 greedy decode steps.

def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def same_bits(a, b) -> bool:
    """Bit-for-bit equality of two float32 or bfloat16 tensors, or tuples of
    them (== would equate -0.0 and 0.0)."""
    import torch
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers (8 significant bits) at |x|."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def close(got, want, tol: float, dn: str, ulps: bool = True):
    """The gate of phases 15 and 17: finite and allclose at ``tol`` (atol =
    rtol); in bf16 also BF16_REL normwise and, with ``ulps`` (one kernel's
    output, rounded once), within BF16_ULPS ulps of max|want|. Returns (ok,
    max_abs_err, normwise error, a description of the limits)."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    rel = (torch.linalg.norm(g - w) / torch.linalg.norm(w).clamp_min(1e-30)).item()
    ok = bool(torch.isfinite(g).all()) and torch.allclose(g, w, atol=tol, rtol=tol)
    lim = f"allclose {tol}"
    if dn == "bfloat16":
        ok = ok and rel <= BF16_REL
        lim += f", normwise {BF16_REL}"
        if ulps:
            top = w.abs().max().item()
            ok = ok and err <= BF16_ULPS * bf16_ulp(top)
            lim += f", {BF16_ULPS} ulps of max|want| {top:.3g} = {BF16_ULPS * bf16_ulp(top):.3g}"
    return ok, err, rel, lim


def argmax_agrees(got, want, tol: float):
    """Whether, on every row, ``got``'s argmax picks a logit that ``want``
    puts within ``tol`` (atol = rtol, as ``close`` holds each logit) of its
    own maximum: the same token, or a tie within the tolerance. Returns
    (ok, the number of rows whose argmax differs, the largest gap
    max(want) - want[argmax(got)] over the rows)."""
    g, w = got.float(), want.float()
    pick = g.argmax(-1, keepdim=True)
    top = w.max(-1, keepdim=True).values
    gap = (top - w.gather(-1, pick)).squeeze(-1)
    flipped = int((pick.squeeze(-1) != w.argmax(-1)).sum())
    ok = bool((gap <= tol * (1 + top.abs().squeeze(-1))).all())
    return ok, flipped, gap.max().item()


def _paged_prefill_logits(m, p, prompt, chunk, page_size, dev):
    """Phase 17's prefill: ``prompt`` (a list of tokens) through
    ``LM.prefill_paged`` in chunks of ``chunk`` on a fresh paged cache, the
    MoE on decode plans. Returns each chunk's float32 logits (1, V)."""
    import torch
    n_pages = -(-len(prompt) // chunk) * chunk // page_size
    cache = m.init_paged_cache(1 + n_pages, page_size, device=dev)
    table = torch.arange(1, 1 + n_pages, dtype=torch.int32, device=dev)[None]
    logits = []
    with _decode_plans(chunk), torch.no_grad():
        for start in range(0, len(prompt), chunk):
            ln = min(chunk, len(prompt) - start)
            tokens = torch.zeros((1, chunk), dtype=torch.int64, device=dev)
            tokens[0, :ln] = torch.as_tensor(prompt[start:start + ln], device=dev)
            lg, cache = m.prefill_paged(p, tokens, cache, table, start, ln)
            logits.append(lg[:, :m.cfg.vocab_size].float())
    return logits


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
    from repro_torch.kernels import build, cvmm as K, flash_attention as K7, ops
    from repro_torch.models import LM, build_model
    from repro_torch.serving import Engine, Request

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
    with ThreadPoolExecutor(len(K7_FAULTS)) as pool:    # phase L's planted faults, beside
        faulty = {fault: pool.submit(build.build, ["flash_attention"], _k7_fault(fault))
                  for fault in K7_FAULTS}
        infos = build.build()
        for fault, job in faulty.items():
            if job.exception() is not None:
                fail(f"K7 with planted fault {fault} did not build:\n{job.exception()}")
    print(f"[2] built {sorted(infos)} in {time.perf_counter() - t0:.1f} s (and K7 with each "
          f"of phase L's {len(faulty)} planted faults)")
    for name, info in infos.items():
        print(f"[2] {name}: nvcc {info.seconds:.1f} s -> {info.path.name}")
        for line in info.ptxas.splitlines():
            if "Compiling entry" in line or "Used" in line:
                print(f"[2]   {line.strip()}")
    results["build"] = {n: {"seconds": i.seconds, "ptxas": i.ptxas}
                        for n, i in infos.items()}

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    E, D, G = SERVE_E, SERVE_D, SERVE_G

    # ------------------------------------------- 3. kernels vs plain versions
    errs, normwise = _serving_kernels(dev, gen, K, ops, results)

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
    attn_calls = cfg.n_layers * stats["prefill_chunks"]
    print(f"[4] launches {launches}; MoE calls {moe_calls} -> expected cvmm "
          f"{3 * moe_calls}, gather_rows {moe_calls}; prefill attention calls "
          f"{attn_calls} -> expected flash_attention {attn_calls}")
    if len(outs) != 8 or any(len(v) != 32 for v in outs.values()):
        fail(f"engine did not complete every request: {[len(v) for v in outs.values()]}")
    if any(not 0 <= t < cfg.vocab_size for v in outs.values() for t in v):
        fail("engine emitted a token outside the vocabulary")
    if launches["cvmm"] != 3 * moe_calls or launches["gather_rows"] != moe_calls:
        fail(f"main path did not run every MoE call on the kernels: {launches}")
    if launches["flash_attention"] != attn_calls:
        fail(f"main path did not run every prefill attention call on K7: {launches}")
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
        with _decode_plans(32):
            lp, cache = lm2.prefill_paged(p2, prompt, cache, tables[:1], 0, 32)
            ld, _ = lm2.decode_step_paged(p2, cache, dec_tok, dec_pos, tables)
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
    timings = _time_serving_kernels(dev, gen, K, ops, errs, normwise, results)

    # ------------------------------------------------ 7-14. the training slice
    train = _training_slice(args.seed, dev, gen, K, results)

    # -------------------------------------------- 15-18. K7 and serve-long
    t0 = time.perf_counter()
    k7_row = _long_prompt_slice(args.seed, dev, gen, K, K7, results)
    print(f"[15-18] took {time.perf_counter() - t0:.1f} s", flush=True)
    k7_row["launches_serve"] = launches["flash_attention"]

    # ------------------------------- A-E. the paper's dense/sigma-MoE pairs
    pair_rows = _paper_pair_slice(args.seed, dev, gen, K, results)

    # ------------------------- F-H. PKM and the top-K MLP on K6, trained
    swap_rows = _swap_slice(args.seed, dev, gen, K, results)

    # ----------------- I-K. the MoE baselines and the trainer's options
    new_paths = _baselines_slice(args.seed, dev, gen, K, results, results["training"])

    # ------- L-N. K7 at head size 112, zamba2-7b and the other new archs
    d112, arch_launches = _arch_slice(args.seed, dev, gen, K, K7, results)

    # ------------------------------------------------------------- O. tile layer
    t0 = time.perf_counter()
    _tile_layer_slice(args.seed, dev, gen, K, K7, ops, results)
    print(f"[O] took {time.perf_counter() - t0:.1f} s", flush=True)

    # ----------------------------------------------- P. expert parallelism
    t0 = time.perf_counter()
    ep_rows = _ep_slice(args.seed, dev, gen, K, ops, results)
    print(f"[P] took {time.perf_counter() - t0:.1f} s", flush=True)

    # ------------------------------------------------------------ 19. report
    def row(kernel, shape, source, replaces):
        t = next(t for t in timings if t["kernel"] == kernel and t["shape"] == shape
                 and t["dtype"] == "bfloat16")
        return {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[kernel], "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"], "library_device_ms": t["library_device_ms"],
                "shape": shape, "dtype": "bfloat16", "path": "serving"}

    k4 = row("cvmm", f"M_pad 5120 {D}->{G} E {E}", "src/repro_torch/kernels/csrc/cvmm.cu",
             "src/repro/kernels/cvmm.py:241")
    k4["prefill_chunk"] = [
        {key: t[key] for key in ("shape", "ms", "device_ms", "plain_ms", "library_ms",
                                 "library_device_ms", "bound_ms", "bound_by", "max_abs_err",
                                 "normwise")}
        for t in timings if t["kernel"] == "cvmm" and t["dtype"] == "bfloat16"
        and t["path"] == "serve-long prefill chunk"]
    k4["launches_serve_long"] = results["serve_long"]["launches"]["cvmm"]
    k4["launches_training"] = train["launches"]["cvmm"]
    k4["launches_training_unfused"] = train["launches_unfused"]["cvmm"]
    k6 = row("gather_rows", f"n 8 d {D} into 128 rows",
             "src/repro_torch/kernels/csrc/gather_rows.cu", "src/repro/kernels/cvmm.py:621")
    k6["prefill_chunk"] = [
        {key: t[key] for key in ("shape", "ms", "device_ms", "plain_ms", "library_ms",
                                 "library_device_ms", "bound_ms", "bound_by", "max_abs_err")}
        for t in timings if t["kernel"] == "gather_rows" and t["dtype"] == "bfloat16"
        and t["path"] == "serve-long prefill chunk"]
    k6["launches_serve_long"] = results["serve_long"]["launches"]["gather_rows"]
    for row_, kernel in ((train["rows"]["fused_w1"], "fused_w1"),
                         (train["rows"]["fused_w2"], "fused_w2"),
                         (train["rows"]["dw_streamed"], "dw_streamed"), (k4, "cvmm")):
        row_["launches_baselines_and_options"] = {
            path: counts[kernel] for path, counts in new_paths.items()}
    k7_row["head_size_112"] = {key: d112[key] for key in (
        "shape", "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
        "bound_by", "max_abs_err", "schedule", "library_backend")}
    k7_row["launches_new_archs"] = {arch: {"prefill": c["flash_attention"],
                                           "decode": c["decode"]["flash_attention"]}
                                    for arch, c in arch_launches.items() if c}
    llama4 = arch_launches["llama4-scout-17b-a16e"]
    k4["launches_llama4_scout_decode"] = llama4["decode"]["cvmm"]
    k6["launches_llama4_scout_decode"] = llama4["decode"]["gather_rows"]
    line = {"kernels": [
        train["rows"]["fused_w1"], train["rows"]["fused_w2"],
        train["rows"]["dw_streamed"], k4, train["rows"]["cvmm_dw"], k6, k7_row,
        *pair_rows, *swap_rows, *ep_rows]}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1, default=str))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def _smem_queries(K):
    """The card's view of every bf16 kernel instance's shared memory: the
    opt-in limit, and {(kernel, instance): (dynamic, static) bytes} from each
    source's ``repro_*_smem`` query (K3's three operand variants apart)."""
    import ctypes
    from repro_torch.analysis import smem as S
    ptr = ctypes.POINTER(ctypes.c_int)
    i = ctypes.c_int

    def ask(lib, symbol, args):
        dyn, stat = ctypes.c_int(-1), ctypes.c_int(-1)
        fn = K._fn(lib, symbol, [i] * len(args) + [ptr, ptr])
        rc = fn(*args, ctypes.byref(dyn), ctypes.byref(stat))
        if rc != 0:
            fail(f"{symbol}{tuple(args)} failed with CUDA error {rc}: not instantiated?")
        return dyn.value, stat.value

    optin = ctypes.c_int(0)
    rc = K._fn("cvmm", "repro_smem_optin", [ptr])(ctypes.byref(optin))
    if rc != 0:
        fail(f"repro_smem_optin failed with CUDA error {rc}")
    seen = {}
    for kernel, inst in S.instances():
        key = (kernel, tuple(sorted(inst.items())))
        if kernel == "cvmm":
            seen[key] = [ask("cvmm", "repro_cvmm_smem", [inst["bn"]])]
        elif kernel == "fused_w2":
            seen[key] = [ask("fused_w2", "repro_fused_w2_smem", [inst["bn"]])]
        elif kernel == "fused_w1":
            seen[key] = [ask("fused_w1", "repro_fused_w1_smem",
                             [inst["bn"], inst["glu"], inst["save"]])]
        elif kernel == "dw_streamed":
            seen[key] = [ask("dw_streamed", "repro_dw_streamed_smem", [sx, gt])
                         for sx, gt in ((1, 0), (0, 0), (0, 1))]
        elif kernel == "cvmm_dw":
            seen[key] = [ask("cvmm_dw", "repro_cvmm_dw_smem", [])]
        elif kernel == "flash_attention":
            seen[key] = [ask("flash_attention", "repro_flash_attention_smem",
                             [inst["d"], inst["bk"]])]
        else:
            seen[key] = [ask("gather_rows", "repro_gather_rows_smem", [inst["vpl"]])]
    return optin.value, seen


def _tile_layer_slice(seed, dev, gen, K, K7, ops, results):
    """Phase O (see the module docstring). Returns nothing; fails on any
    gate."""
    import os
    import shutil
    import torch
    from repro_torch.analysis import smem as S
    from repro_torch.common import tree_leaves
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.data import DataIterator, make_dataset
    from repro_torch.kernels import autotune
    from repro_torch.models import build_model
    from repro_torch.runtime import init_train_state, make_train_step

    out = results.setdefault("tile_layer", {"card": results.get("card")})
    # (1) shared memory: the launchers against the inventory and the card's limit
    optin, seen = _smem_queries(K)
    rows = []
    for (kernel, inst), got in seen.items():
        want = S.launch_bytes(kernel, dict(inst))
        ok = all(g == want for g in got) and all(d + st <= optin for d, st in got)
        rows.append({"kernel": kernel, "instance": dict(inst), "card": got, "inventory": want})
        print(f"[O] smem {kernel} {dict(inst)}: launcher {got}, inventory {want}, "
              f"opt-in {optin} {'ok' if ok else 'BAD'}")
        if not ok:
            fail(f"{kernel} {dict(inst)}: shared memory {got} (dynamic, static) on the card, "
                 f"{want} in analysis/smem.py's inventory, opt-in limit {optin}")
    n_cands = 0
    for family in autotune.families():
        for shape in S.shape_grid(family):
            if family == "row_gemm" and shape["b"] != 2:
                continue
            for c in autotune.enumerate_candidates(family, shape, budget=optin):
                kernel, inst = S.launch_instance(family, shape, c)
                n_cands += 1
                if (kernel, tuple(sorted(inst.items()))) not in seen:
                    fail(f"the tuner's candidate {c} for {family} {shape} launches "
                         f"{kernel} {inst}, which the card was not asked about")
    print(f"[O] {len(seen)} instances, opt-in limit {optin} bytes on the card; "
          f"{n_cands} candidates on the analysis grid, each one of them")
    out["smem"] = {"optin": optin, "instances": rows, "candidates": n_cands}

    # (2) tuned mode on a cache of its own, at the main paths' shapes
    cache = ROOT / "build" / "autotune_phase_o"
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(cache)
    autotune.reset()
    autotune.enable(True)
    try:
        cases = _tile_cases(dev, gen, K, K7, ops)
        picks = []
        for warm in (False, True):
            autotune.reset()                      # a new process: memory dropped
            for case in cases:
                d = autotune.decide(case["family"], case["shape"], device=dev)
                if d.provenance != "tuned":
                    fail(f"{case['label']}: the tuner's decision is {d}")
                if not warm:
                    picks.append(d.tiles)
                elif d.tiles != picks[cases.index(case)]:
                    fail(f"{case['label']}: the warm cache gave {d.tiles}, the cold "
                         f"{picks[cases.index(case)]}")
            timed = autotune.STATS["microbench_calls"]
            print(f"[O] {'warm' if warm else 'cold'} cache: {timed} candidates timed, "
                  f"{autotune.STATS['cache_hits']} cache hits, {len(cases)} shapes")
            if (timed == 0) != warm:
                fail(f"the {'warm' if warm else 'cold'} cache timed {timed} candidates")
            out["warm" if warm else "cold"] = dict(autotune.STATS)
        out["cases"] = []
        smi = results.get("card")
        for case, tiles in zip(cases, picks):
            own = case["run"](None)                 # the wrapper asks the tuner itself
            pick = case["run"](tiles)
            want = case["plain"]()
            torch.cuda.synchronize()
            if not same_bits(own, pick):
                fail(f"{case['label']}: the wrapper's own decision is not the tuned pick")
            ok, err, rel, lim = case["gate"](own, want)
            heur = autotune.heuristic(case["family"], case["shape"])
            h_ms = _device_ms(lambda: case["run"](heur))
            t_ms = _device_ms(lambda: case["run"](tiles))
            print(f"[O] {case['label']}: heuristic {heur} {h_ms:.4f} ms, tuned {tiles} "
                  f"{t_ms:.4f} ms device alone ({smi}); tuned vs plain max_abs_err "
                  f"{err:.3g}, normwise {rel:.3g} ({lim}) {'ok' if ok else 'BAD'}")
            if not ok:
                fail(f"{case['label']}: the tuned pick {tiles} disagrees with the plain version")
            out["cases"].append({"label": case["label"], "family": case["family"],
                                 "heuristic": heur, "heuristic_ms": h_ms, "tuned": tiles,
                                 "tuned_ms": t_ms, "max_abs_err": err, "normwise": rel})
        del cases

        # (3) a 10-step tuned training run from a cold cache
        shutil.rmtree(cache, ignore_errors=True)
        autotune.reset()
        lm = build_model(get_config(TRAIN["arch"]))
        b, s_len, steps = TRAIN["batch"], TRAIN["seq"], 10
        opt = OptimizerConfig(total_steps=steps)
        stream = DataIterator(make_dataset("synthetic", lm.cfg.vocab_size), b, s_len + 1,
                              seed=seed)
        state = init_train_state(lm, torch.Generator(device=dev).manual_seed(seed), opt,
                                 use_mems=True, batch=b, device=dev)
        step, drop = make_train_step(lm, opt), torch.Generator(device=dev).manual_seed(seed + 1)
        losses, timed = [], []
        for _ in range(steps):
            before = autotune.STATS["microbench_calls"]
            batch = {"tokens": torch.as_tensor(stream.next()["tokens"], device=dev)}
            state, m = step(state, batch, drop)
            losses.append(float(m["loss"]))
            timed.append(autotune.STATS["microbench_calls"] - before)
        n_params = sum(t.numel() for t in tree_leaves(state["params"]))
        print(f"[O] tuned {TRAIN['arch']} ({n_params / 1e6:.1f} M parameters), {steps} steps "
              f"of {b} x {s_len} from a cold cache: candidates timed per step {timed}; "
              f"losses {[round(x, 4) for x in losses]}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            fail(f"the tuned training run's loss is not finite and falling: {losses}")
        if timed[0] == 0 or any(timed[2:]):
            fail(f"the tuned run timed candidates outside its first two steps: {timed}")
        out["train"] = {"losses": losses, "timed_per_step": timed,
                        "decisions": {k: e["tiles"] for k, e in json.loads(
                            Path(autotune.cache_path(dev.type)).read_text())["entries"].items()}}
        del state, step, lm
    finally:
        autotune.enable(False)
        autotune.reset()
        os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
    torch.cuda.empty_cache()


def _tile_cases(dev, gen, K, K7, ops):
    """Phase O's shapes: for each, the tuner's family and shape, ``run(tiles)``
    (the wrapper at that schedule; None lets the wrapper decide), ``plain()``
    and the kernel's gate (phase 3's for K4 and K6, phase 7's for K1-K5,
    phase 15's for K7)."""
    import torch
    E, D, G = SERVE_E, SERVE_D, SERVE_G
    sms = K._sm_count(dev)
    bf = torch.bfloat16
    k4_inputs, k6_inputs = _serving_inputs(dev, gen, ops)
    cases = []

    def bf16_gate(got, want):
        ok, err, rel, lim = close(got, want, TOL["bfloat16"], "bfloat16", ulps=False)
        return ok, err, rel, lim

    def exact(got, want):
        err = (got.float() - want.float()).abs().max().item()
        return err == 0, err, 0.0, "exact"

    def f32_sums(got, want):
        err = (got - want).abs().max().item()
        rel = (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, atol=TOL["float32"], rtol=TOL["float32"])
        return ok, err, rel, f"allclose {TOL['float32']} (float32 sums)"

    def k7_gate(got, want):
        return close(got, want, K7_TOL["bfloat16"], "bfloat16")

    def row_gemm(label, kernel, fn, plain, m_pad, k_pad, n_pad, n_experts, glu=False,
                 save=False):
        cases.append({"label": label, "family": "row_gemm", "gate": bf16_gate,
                      "shape": {"kernel": kernel, "m_pad": m_pad, "k_pad": k_pad,
                                "n_pad": n_pad, "glu": glu, "save": save,
                                "n_experts": n_experts, "b": 2, "sms": sms},
                      "run": lambda t: fn(None if t is None else t["bn"]), "plain": plain})

    def gather(label, x, rs):
        cases.append({"label": label, "family": "gather_rows", "gate": exact,
                      "shape": {"m_pad": rs.numel(), "row_bytes": x.shape[1] * 2, "sms": sms},
                      "run": lambda t: K.gather_rows(
                          x, rs, schedule=None if t is None else (t["rows"], t["vpl"])),
                      "plain": lambda: K.gather_rows_plain(x, rs)})

    # serve decode (8 tokens) and serve-long's prefill chunk: K4 at both widths, K6
    for m_pad, layout, tag in ((5120, "decode", "serve decode"),
                               (81920, "prefill", "serve-long chunk")):
        for k, n in ((D, G), (G, D)):
            x, te, w = k4_inputs(m_pad, k, n, bf, layout)
            row_gemm(f"{tag} K4 M_pad {x.shape[0]} {k}->{n}", "cvmm",
                     lambda bn, x=x, te=te, w=w: K.cvmm(x, te, w, bn=bn),
                     lambda x=x, te=te, w=w: K.cvmm_plain(x, te, w), x.shape[0], k, n, E)
    for n_tok, tag in ((8, "serve decode"), (LONG["prefill_chunk"], "serve-long chunk")):
        x, rs, _ = k6_inputs(n_tok, bf, False)
        gather(f"{tag} K6 {n_tok} tokens d {D} into {rs.numel()} rows", x, rs)
    # serve-long's chunk at its last offset: K7 over 4,096 keys
    sq, sk = LONG["prefill_chunk"], LONG["max_len"]
    q = torch.randn((1, sq, 24, 64), generator=gen, device=dev).to(bf)
    kv = [torch.randn((1, sk, 8, 64), generator=gen, device=dev).to(bf) for _ in range(2)]
    kw = dict(causal=True, scale=64 ** -0.5, q_offset=sk - sq)
    cases.append({"label": f"serve-long chunk K7 Sq {sq} at {sk - sq}, Sk {sk}, H 24/8",
                  "family": "flash", "gate": k7_gate,
                  "shape": {"b": 1, "sq": sq, "h": 24, "kvh": 8, "sk": sk,
                            "q_offset": sk - sq, "causal": True, "d": 64,
                            "bk": K7.FLASH_BK[64], "sms": sms},
                  "run": lambda t: K7.flash_attention(
                      q, *kv, **kw, splits=None if t is None else t["splits"]),
                  "plain": lambda: K7.flash_attention_plain(q, *kv, **kw)})
    # wt103-47m-moe's training step: 32 x 256 tokens, top-4 of 16 experts of 128
    n, top, e, d, g = TRAIN["batch"] * TRAIN["seq"], 4, 16, 412, 128
    idx = torch.argsort(torch.rand((n, e), generator=gen, device=dev), 1)[:, :top]
    plan = ops.make_moe_plan(idx, e, torch.rand((n, top), generator=gen, device=dev))
    m_pad, rs, te = plan.m_pad, plan.row_src, plan.tile_expert
    gate = plan.gate_tiles.reshape(-1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    x, dy = ops._pad_lane(rnd(n, d), 1), ops._pad_lane(rnd(n, d), 1)
    w1 = ops._pad_w(rnd(e, d, g, scale=d ** -0.5))
    w2 = ops._pad_w(rnd(e, g, d, scale=g ** -0.5))
    w2t, w1t = w2.transpose(1, 2).contiguous(), w1.transpose(1, 2).contiguous()
    u, dh = rnd(m_pad, 128), rnd(m_pad, 128)
    rows = (n * top / e) ** -0.5
    dh_dw, dy_dw = (dh.float() * rows).to(bf), (dy.float() * rows).to(bf)
    x_pad = torch.where((rs < n)[:, None], K.gather_rows_plain(x, rs), 0.0).to(bf)
    row_gemm(f"47M K1 forward, saving pre-activations, M_pad {m_pad}", "fused_w1",
             lambda bn: K.fused_w1(x, rs, te, w1, act="relu", save_preact=True, bn=bn),
             lambda: K.fused_w1_plain(x, rs, te, w1, act="relu", save_preact=True),
             m_pad, 512, 128, e, save=True)
    cases[-1]["gate"] = lambda got, want: _all_of(bf16_gate, got, want)
    row_gemm("47M K1 t0 = dy w2^T", "fused_w1",
             lambda bn: K.fused_w1(dy, rs, te, w2t, act="identity", bn=bn),
             lambda: K.fused_w1_plain(dy, rs, te, w2t, act="identity"), m_pad, 512, 128, e)
    row_gemm("47M K2", "fused_w2", lambda bn: K.fused_w2(u, te, w2, gate, bn=bn),
             lambda: K.fused_w2_plain(u, te, w2, gate), m_pad, 128, 512, e)
    row_gemm("47M K4 dX = dh w1^T", "cvmm", lambda bn: K.cvmm(dh, te, w1t, bn=bn),
             lambda: K.cvmm_plain(dh, te, w1t), m_pad, 128, 512, e)
    for label, kernel, fn, plain, k_pad, n_pad, stream_x, gated in (
            ("47M K3 dW1", "dw_streamed",
             lambda c: K.dw_streamed(x, dh_dw, rs, te, e, stream_x=True, chunk=c),
             lambda: K.dw_streamed_plain(x, dh_dw, rs, te, e, stream_x=True), 512, 128, 1, 0),
            ("47M K3 dW2, gated", "dw_streamed",
             lambda c: K.dw_streamed(u, dy_dw, rs, te, e, stream_x=False, gate=gate, chunk=c),
             lambda: K.dw_streamed_plain(u, dy_dw, rs, te, e, stream_x=False, gate=gate),
             128, 512, 0, 1),
            ("47M K5 dW1 (unfused rung)", "cvmm_dw",
             lambda c: K.cvmm_dw(x_pad, te, dh_dw, e, chunk=c),
             lambda: K.cvmm_dw_plain(x_pad, te, dh_dw, e), 512, 128, 0, 0)):
        cases.append({"label": label, "family": "dw_split", "gate": f32_sums,
                      "shape": {"kernel": kernel, "m_pad": m_pad, "n_experts": e,
                                "k_pad": k_pad, "n_pad": n_pad, "b": 2,
                                "stream_x": stream_x, "gated": gated},
                      "run": lambda t, fn=fn: fn(None if t is None else t["chunk"]),
                      "plain": plain})
    return cases


def _all_of(gate, got, want):
    """``gate`` over every output of a tuple (K1 with saved pre-activations)."""
    checks = [gate(a, b) for a, b in zip(got, want)]
    return (all(c[0] for c in checks) and len(got) == len(want),
            max(c[1] for c in checks), max(c[2] for c in checks), checks[0][3])


def _serving_inputs(dev, gen, ops):
    """(k4_inputs, k6_inputs): random operands of K4 and K6 at granite-moe's
    serving widths, from ``gen``."""
    import torch
    E, D, G = SERVE_E, SERVE_D, SERVE_G

    def decode_layout(m_pad):
        return torch.arange(E, dtype=torch.int32, device=dev).repeat_interleave(
            m_pad // 128 // E)

    def k4_inputs(m_pad, k, n, dtype, layout):
        w = (torch.randn((E, k, n), generator=gen, device=dev) * k ** -0.5).to(dtype)
        if layout == "prefill":
            # serve-long's prefill chunk on the decode plan: 256 tokens' top-8
            # rows (a random routing) in their slots, the rest zero
            plan = ops.make_decode_plan(LONG["prefill_chunk"], 8, E, device=dev)
            idx = torch.argsort(torch.rand((plan.n_tokens, E), generator=gen, device=dev),
                                1)[:, :8]
            slot = ops.decode_slots(plan, idx)
            x = torch.zeros((plan.m_pad, k), dtype=dtype, device=dev)
            x[slot] = torch.randn((slot.numel(), k), generator=gen, device=dev).to(dtype)
            return x, plan.tile_expert, w
        x = torch.randn((m_pad, k), generator=gen, device=dev).to(dtype)
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

    return k4_inputs, k6_inputs


def _serving_kernels(dev, gen, K, ops, results):
    """Phase 3: K4 and K6 against their plain versions on the card at the
    serving paths' shapes. Returns K4's and K6's max_abs_err and K4's
    normwise errors by case."""
    import torch
    E, D, G = SERVE_E, SERVE_D, SERVE_G
    k4_inputs, k6_inputs = _serving_inputs(dev, gen, ops)
    errs, normwise = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for m_pad, k, n, layout in K4_CASES:
            x, te, w = k4_inputs(m_pad, k, n, dt, layout)
            got, again, want = K.cvmm(x, te, w), K.cvmm(x, te, w), K.cvmm_plain(x, te, w)
            torch.cuda.synchronize()
            ok, err, rel, lim = close(got, want, TOL[dn], dn, ulps=False)
            twice = same_bits(got, again)
            print(f"[3] cvmm {layout} M_pad {m_pad} {k}->{n} E {E} {dn}: max_abs_err "
                  f"{err:.3g}, normwise {rel:.3g} ({lim}), same bits twice {twice} "
                  f"{'ok' if ok and twice else 'BAD'}")
            if not ok:
                fail(f"cvmm disagrees with cvmm_plain at {m_pad} {k}->{n} {dn}")
            if not twice:
                fail(f"cvmm gave different bits on a second call at {m_pad} {k}->{n} {dn}")
            errs[("cvmm", m_pad, k, n, layout, dn)] = err
            normwise[("cvmm", m_pad, k, n, layout, dn)] = rel
            if dn == "bfloat16" and (m_pad, layout) in ((5120, "decode"), (81920, "prefill")):
                # The bf16 gate must reject a K4 whose ring drops one 64-deep
                # stage or adds it twice: the kernel on x with that slice of K
                # zeroed or doubled computes exactly such a K4's output.
                lo = k // 128 * 64           # the middle stage of K
                for fault, scale in (("stage dropped", 0.0), ("stage read twice", 2.0)):
                    bad = x.clone()
                    bad[:, lo:lo + 64] *= scale
                    b_ok, b_err, b_rel, _ = close(K.cvmm(bad, te, w), want, TOL[dn], dn,
                                                  ulps=False)
                    print(f"[3] faulty cvmm ({fault}, K columns {lo}-{lo + 63}) {layout} M_pad "
                          f"{m_pad} {k}->{n} {dn}: max_abs_err {b_err:.3g}, normwise "
                          f"{b_rel:.3g}: {'PASSED, the gate is too loose' if b_ok else 'rejected'}")
                    if b_ok:
                        fail(f"the bf16 gate let a faulty cvmm ({fault}) through")
                    normwise[("faulty cvmm " + fault, m_pad, k, n, layout, dn)] = b_rel
        for n in K6_TOKENS:
            for weighted in (False, True):
                x, rs, wt = k6_inputs(n, dt, weighted)
                got, want = K.gather_rows(x, rs, wt), K.gather_rows_plain(x, rs, wt)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                print(f"[3] gather_rows n {n} d {D} into {rs.numel()} rows weighted "
                      f"{weighted} {dn}: max_abs_err {err:.3g} (exact) "
                      f"{'ok' if err == 0 else 'BAD'}")
                if err != 0:
                    fail(f"gather_rows disagrees with gather_rows_plain at n {n} {dn}")
                errs[("gather_rows", n, weighted, dn)] = err
    # K6 on one 16-byte vector a row (K_pad 8 in bf16) through an unsorted
    # row_src that mixes both kinds of sentinel over several row groups
    x = torch.randn((50, 8), generator=gen, device=dev).to(torch.bfloat16)
    rs = torch.randint(-1, 56, (384,), generator=gen, device=dev, dtype=torch.int32)
    rs[::7], rs[3::11] = 55, -1
    for weighted in (False, True):
        wt = torch.rand((384,), generator=gen, device=dev) if weighted else None
        err = (K.gather_rows(x, rs, wt).float() - K.gather_rows_plain(x, rs, wt).float()
               ).abs().max().item()
        print(f"[3] gather_rows K_pad 8 bfloat16, 384 unsorted slots from 50 rows with "
              f"sentinels -1 and 55, weighted {weighted}: max_abs_err {err:.3g} (exact) "
              f"{'ok' if err == 0 else 'BAD'}")
        if err != 0:
            fail("gather_rows disagrees with gather_rows_plain at K_pad 8")
        errs[("gather_rows K_pad 8", weighted)] = err
    results["phase3"] = {" ".join(map(str, k)): v for k, v in errs.items()}
    results["phase3_normwise"] = {" ".join(map(str, k)): v for k, v in normwise.items()}
    return errs, normwise


def _time_serving_kernels(dev, gen, K, ops, errs, normwise, results):
    """Phase 6: K4 (decode and the prefill chunk) and K6 timed by events and
    device alone beside the bound, the plain version and a library call."""
    import torch
    E, D, G = SERVE_E, SERVE_D, SERVE_G
    k4_inputs, k6_inputs = _serving_inputs(dev, gen, ops)
    timings = []
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for m_pad, k, n, layout in K4_CASES[:3] + K4_CASES[4:]:
            x, te, w = k4_inputs(m_pad, k, n, dt, layout)
            cap = m_pad // E
            nbytes = (x.numel() + w.numel() + m_pad * n) * x.element_size() + te.numel() * 4
            flops = 2 * m_pad * k * n
            bound_b, bound_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dn]

            def lib():
                return torch.bmm(x.view(E, cap, k), w)
            timings.append({
                "kernel": "cvmm", "shape": f"M_pad {m_pad} {k}->{n} E {E}", "dtype": dn,
                "path": "serve-long prefill chunk" if layout == "prefill" else "serving decode",
                "ms": _time_ms(lambda: K.cvmm(x, te, w)),
                "device_ms": _device_ms(lambda: K.cvmm(x, te, w)),
                "plain_ms": _time_ms(lambda: K.cvmm_plain(x, te, w)),
                "library_ms": _time_ms(lib), "library_device_ms": _device_ms(lib),
                "bound_ms": 1e3 * max(bound_b, bound_f),
                "bound_by": "bytes" if bound_b >= bound_f else "operations",
                "max_abs_err": errs[("cvmm", m_pad, k, n, layout, dn)],
                "normwise": normwise[("cvmm", m_pad, k, n, layout, dn)]})
        for n in K6_TOKENS:
            x, rs, _ = k6_inputs(n, dt, False)
            xz = torch.cat([x, x.new_zeros((1, D))])
            nbytes = (n + rs.numel()) * D * x.element_size() + rs.numel() * 4
            timings.append({
                "kernel": "gather_rows", "shape": f"n {n} d {D} into {rs.numel()} rows",
                "dtype": dn, "path": ("serve-long prefill chunk" if n == LONG["prefill_chunk"]
                                      else "serving decode"),
                "ms": _time_ms(lambda: K.gather_rows(x, rs)),
                "device_ms": _device_ms(lambda: K.gather_rows(x, rs)),
                "plain_ms": _time_ms(lambda: K.gather_rows_plain(x, rs)),
                "library_ms": _time_ms(lambda: torch.index_select(xz, 0, rs)),
                "library_device_ms": _device_ms(lambda: torch.index_select(xz, 0, rs)),
                "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
                "max_abs_err": errs[("gather_rows", n, False, dn)]})
    for t in timings:
        print(f"[6] {t['kernel']} {t['shape']} {t['dtype']} ({t['path']}): kernel "
              f"{t['ms']:.4f} ms ({t['device_ms']:.4f} device alone), plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms "
              f"({t['library_device_ms']:.4f} device alone), bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
    results["timings"] = timings
    return timings


def _training_kernels(tag, n, k, E, d, G, dev, gen, K, ops):
    """Phases 7 and A: the training kernels (K1 in its four variants and as
    t0, K2, K3 in its three, K4 dX) against their plain versions for ``n``
    tokens routed top-``k`` over ``E`` experts of ``G`` at d_model ``d``, in
    bf16 and float32, on three plans (all experts, one expert empty, one
    skewed), each kernel the same bits on a second call, and the bf16 gate's
    faulty K2. Returns (plans, inputs(dtype, plan), errors, normwise errors,
    the empty expert)."""
    import torch

    def draw_plan(skip=None, favour=None):
        # favour: that expert's keys scaled by 0.3, so about 3x the mean rows
        # pick it, its tiles spanning many of K3's and K5's chunks
        pool = torch.tensor([e for e in range(E) if e != skip], device=dev)
        keys = torch.rand((n, len(pool)), generator=gen, device=dev)
        if favour is not None:
            keys[:, favour] *= 0.3
        idx = pool[torch.argsort(keys, dim=1)[:, :k]]
        return ops.make_moe_plan(idx, E, torch.rand((n, k), generator=gen, device=dev))

    empty = E // 2
    plans = {"all experts": draw_plan(), "one expert empty": draw_plan(skip=empty),
             "skewed": draw_plan(favour=0)}
    for name, plan in plans.items():
        slack = (plan.row_src.view(-1, 128) >= n).all(1).sum().item()
        print(f"[{tag}] plan '{name}': N {n} x top-{k}, E {E}, M_pad {plan.m_pad}, "
              f"{plan.m_pad // 128} tiles of which {slack} all-sentinel; rows per "
              f"expert {plan.group_sizes.tolist()}")
        if not slack:
            fail("the plan has no all-sentinel slack tile")
    rows = plans["skewed"].group_sizes.float()
    chunks = -(-int(rows.max()) // 128) // K.DW_CHUNK
    print(f"[{tag}] plan 'skewed': the busiest expert has {rows.max() / rows.mean():.2f}x "
          f"the mean rows, {chunks}+ of K3's and K5's chunks of {K.DW_CHUNK} tiles")
    if rows.max() < 2.5 * rows.mean() or chunks < 4:
        fail("the skewed plan is not skewed")

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

    # (name, kernel, plan key, fn(t, plan) -> [kernel, plain] or, where a second
    # call must give the same bits, [kernel, kernel, plain])
    cases = []
    for glu in (False, True):
        for save in (False, True):
            for act in ("relu", "identity"):
                variant = "w1" + ("_glu" if glu else "") + ("_save" if save else "")
                cases.append((f"fused_w1 {variant} {act}", "fused_w1", "all experts",
                              lambda t, p, glu=glu, save=save, act=act: [
                                  f(t["x"], p.row_src, p.tile_expert, t["w1"],
                                    t["w1g"] if glu else None, act=act, save_preact=save)
                                  for f in (K.fused_w1, K.fused_w1, K.fused_w1_plain)]))
    cases.append(("fused_w1 t0 = dy w2^T identity, one expert empty", "fused_w1",
                  "one expert empty", lambda t, p: [
                      f(t["dy"], p.row_src, p.tile_expert, t["w2t"], None, act="identity")
                      for f in (K.fused_w1, K.fused_w1, K.fused_w1_plain)]))
    cases.append(("cvmm dX = dh w1^T", "cvmm", "all experts", lambda t, p: [
        f(t["dh"], p.tile_expert, t["w1"].transpose(1, 2).contiguous())
        for f in (K.cvmm, K.cvmm, K.cvmm_plain)]))
    for pkey in ("all experts", "one expert empty"):
        cases.append((f"fused_w2, {pkey}", "fused_w2", pkey, lambda t, p: [
            f(t["u"], p.tile_expert, t["w2"], p.gate_tiles.reshape(-1))
            for f in (K.fused_w2, K.fused_w2, K.fused_w2_plain)]))
    for variant, stream_x, gated in (("stream_x (dW1)", True, False),
                                     ("stream_g (dW2, no gate)", False, False),
                                     ("stream_g gated (dW2)", False, True)):
        for pkey, pname in (("one expert empty", "one expert empty"), ("skewed", "skewed")):
            cases.append((f"dw_streamed {variant}, {pname}", "dw_streamed",
                          pkey, lambda t, p, sx=stream_x, gt=gated: [
                              f(t["x"] if sx else t["u"], t["dh_dw"] if sx else t["dy_dw"],
                                p.row_src, p.tile_expert, E, stream_x=sx,
                                gate=p.gate_tiles.reshape(-1) if gt else None)
                              for f in (K.dw_streamed, K.dw_streamed, K.dw_streamed_plain)]))
    errs, normwise = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        tens = {key: inputs(dt, plan) for key, plan in plans.items()}
        for name, kernel, pkey, fn in cases:
            outs = fn(tens[pkey], plans[pkey])
            got, want = outs[0], outs[-1]
            torch.cuda.synchronize()
            if len(outs) == 3 and not same_bits(outs[0], outs[1]):
                fail(f"{name} {dn}: two calls on the same inputs gave different bits")
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
            if kernel == "dw_streamed" and pkey == "one expert empty":
                ok = ok and bool((got[0][empty] == 0).all())
            zeros = ""
            if kernel == "fused_w2":    # slack rows (gate 0), all-sentinel tiles among them
                slack = plans[pkey].row_src >= n
                ok = ok and bool((got[0][slack] == 0).all())
                zeros = f", zeros on its {int(slack.sum())} slack rows"
            # K1, K2 and K4 in bf16 also within BF16_REL normwise (close's gate)
            rel = max(close(a, b, tol, dn, ulps=False)[2] for a, b in zip(got, want))
            normed = kernel in ("fused_w1", "cvmm", "fused_w2") and dn == "bfloat16"
            if normed:
                ok = ok and rel <= BF16_REL
            print(f"[{tag}] {name} {dn}: max_abs_err {err:.3g} (tol {tol}), normwise {rel:.3g}"
                  f"{f' (limit {BF16_REL})' if normed else ''}, "
                  f"{100 * differ:.3f}% of elements differ"
                  f"{', same bits twice' if len(outs) == 3 else ''}{zeros} "
                  f"{'ok' if ok else 'BAD'}")
            if not ok:
                fail(f"{name} disagrees with its plain version in {dn}")
            errs[(name, dn)] = err
            normwise[(name, dn)] = rel
            if kernel == "fused_w2" and dn == "bfloat16":
                # The bf16 gate must reject a K2 whose epilogue applies row
                # r + 8's gate to row r and r's to r + 8 in every 16-row
                # group: the kernel run on gates exchanged so computes
                # exactly such a K2's output.
                p, t = plans[pkey], tens[pkey]
                swapped = p.gate_tiles.reshape(-1, 2, 8).flip(1).reshape(-1)
                b_ok, b_err, b_rel, lim = close(K.fused_w2(t["u"], p.tile_expert, t["w2"],
                                                           swapped), want[0], tol, dn,
                                                ulps=False)
                print(f"[{tag}] faulty fused_w2 (gates of rows r and r + 8 exchanged), {pkey} "
                      f"{dn}: max_abs_err {b_err:.3g}, normwise {b_rel:.3g} ({lim}): "
                      f"{'PASSED, the gate is too loose' if b_ok else 'rejected'}")
                if b_ok:
                    fail("the bf16 gate let a faulty fused_w2 (gate rows exchanged) through")
                normwise[("faulty " + name, dn)] = b_rel
        del tens
    return plans, inputs, errs, normwise, empty


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
    plans, inputs, errs, normwise, empty = _training_kernels("7", n, k, E, d, G, dev,
                                                             gen, K, ops)
    results["phase7"] = {f"{a} {b}": v for (a, b), v in errs.items()}
    results["phase7_normwise"] = {f"{a} {b}": v for (a, b), v in normwise.items()}

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
    prof, step_plan = _profile_train_step("10", lm, state, batches[0],
                                          make_train_step(lm, opt), dev, K, ops)
    del lm, state
    t_bf16 = inputs(torch.bfloat16, plans["all experts"])
    timings = _time_training_kernels("10", "pallas_fused", K, plans["all experts"], t_bf16,
                                     n, d, G, E, errs)
    dw_plans = {"uniform": plans["all experts"], "the step's layer 0": step_plan}
    results["training"] = fused | {"profile": prof, "timings": timings, "dw_on_plans":
                                   _time_dw_on_plans("10", "pallas_fused", K, dw_plans,
                                                     t_bf16, n, E)}

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

    errs11, normwise11 = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for pkey, plan in plans.items():
            for name, kernel, args in unfused_cases(inputs(dt, plan), plan):
                got = getattr(K, kernel)(*args)
                want = getattr(K, kernel + "_plain")(*args)
                torch.cuda.synchronize()
                check_twice = kernel == "cvmm" or pkey == "skewed"
                if check_twice and not same_bits(got, getattr(K, kernel)(*args)):
                    fail(f"{name} {dn}: two calls on the same inputs gave different bits")
                # K5's outputs are float32 sums of identical operands in
                # either input type, so they get the float32 tolerance; K4 in
                # bf16 is also held to BF16_REL normwise.
                tol = TOL["float32" if kernel == "cvmm_dw" else dn]
                ok, err, rel, lim = close(got, want, tol, "float32" if kernel == "cvmm_dw"
                                          else dn, ulps=False)
                if kernel == "cvmm_dw" and pkey == "one expert empty":
                    ok = ok and bool((got[empty] == 0).all())
                twice = ", same bits twice" if check_twice else ""
                print(f"[11] {name}, {pkey}, {dn}: max_abs_err {err:.3g}, normwise {rel:.3g} "
                      f"({lim}){twice} {'ok' if ok else 'BAD'}")
                if not ok:
                    fail(f"{name} disagrees with its plain version in {dn} ({pkey})")
                errs11[(f"{name}, {pkey}", dn)] = err
                normwise11[(f"{name}, {pkey}", dn)] = rel
    errs.update(errs11)
    results["phase11"] = {f"{a} {b}": v for (a, b), v in errs11.items()}
    results["phase11_normwise"] = {f"{a} {b}": v for (a, b), v in normwise11.items()}

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
        prof, step_plan = _profile_train_step("14", lm, state, batches[0],
                                              make_train_step(lm, opt), dev, K, ops)
    del lm, state
    timings += _time_training_kernels("14", "pallas", K, plans["all experts"], t_bf16,
                                      n, d, G, E, errs)
    dw_plans = {"uniform": plans["all experts"], "the step's layer 0": step_plan}
    results["training_unfused"] = unfused | {"profile": prof, "dw_on_plans":
                                             _time_dw_on_plans("14", "pallas", K, dw_plans,
                                                               t_bf16, n, E)}

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
                        "device_ms": t["device_ms"],
                        "library_device_ms": t["library_device_ms"],
                        "shape": t["shape"], "dtype": "bfloat16",
                        "path": "training, " + ("pallas" if run is unfused
                                                else "pallas_fused") + " rung"}
    return {"launches": fused["launches"], "launches_unfused": unfused["launches"],
            "rows": rows}


def _phase_b(seed, dev, K, ops, routing):
    """Phase B: one full-width wt103-262m-moe step with the kernels against
    the same step with the plain versions and pinned expert choices, under
    phase 8's three gates, the bf16 depth-2 one by ``_depth2_verdict``'s
    rule. Then that rule at depth 2 on three more seeds, each of which must
    pass, and on each planted fault, which the yardstick alone and the
    whole rule must reject."""
    import torch
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.data import DataIterator, make_dataset

    cfg = get_config(PAIRS["wt103"][1])

    def three_steps_for(s):
        stream = DataIterator(make_dataset("synthetic", cfg.vocab_size), PAIR["batch"],
                              PAIR["seq"] + 1, seed=s)
        batches = [{"tokens": torch.as_tensor(stream.next()["tokens"], device=dev)}
                   for _ in range(3)]
        return _three_steps_fn(batches, OptimizerConfig(total_steps=3), s, dev,
                               batch=PAIR["batch"])

    # Deterministic algorithms, so that the two sides differ only in the
    # kernels' arithmetic: at 18 layers the float32 scatters' atomic order
    # alone moved a gradient leaf by up to 4e-3 between runs on an H100,
    # twice the float32 tolerance.
    with deterministic_algorithms("B"):
        out = _step_gates("B", cfg, "pallas_fused", three_steps_for(seed), K, ops, routing,
                          depth2_yardstick=True)
        depth2 = cfg.override(n_layers=2)
        out["depth2_seeds"] = {}
        for s in (seed + 1, seed + 2, seed + 3):
            passed, out["depth2_seeds"][s] = _depth2_gate(f"B seed {s}", depth2,
                                                          "pallas_fused", three_steps_for(s),
                                                          K, ops, routing)
            if not passed:
                fail(f"bfloat16, depth 2, seed {s}: the kernels' training step disagrees "
                     "with the plain versions' under the fixed gate and the yardstick alike")
        out["depth2_faults"] = {}
        for fault in ("K2 gate rows exchanged", "K4 stage dropped"):
            passed, record = _depth2_gate(f"B {fault}", depth2, "pallas_fused",
                                          three_steps_for(seed), K, ops, routing, fault)
            out["depth2_faults"][fault] = record
            print(f"[B] planted fault, {fault}: the yardstick "
                  f"{'PASSES it' if record['yardstick'] else 'rejects it'}, the rule "
                  f"{'PASSES it' if passed else 'rejects it'}")
            if passed or record["yardstick"]:
                fail(f"phase B's depth-2 rule let a planted fault ({fault}) through")
    return out


def _paper_pair_slice(seed, dev, gen, K, results):
    """Phases A-E: the paper's parameter-equal dense/sigma-MoE pairs. A: the
    training kernels at the new configs' shapes; B: one full-width
    wt103-262m-moe step, kernels against plain versions; C and D: each pair
    trained through the trainer's entry point, then evaluated; E: checkpoint
    and resume. Returns the kernels line's wt103-262m-moe rows."""
    import torch
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core import routing
    from repro_torch.data import DataIterator, make_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.runtime import init_train_state, make_train_step

    n = PAIR["batch"] * (PAIR["seq"] + 1)

    # ---------------------------------- A. the kernels at the new shapes
    timings = {}
    for arch in (PAIRS["wt103"][1], PAIRS["enwik8"][1]):
        t0 = time.perf_counter()
        f, d = get_config(arch).ffn, get_config(arch).d_model
        tag = f"A {arch}"
        plans, inputs, errs, _, _ = _training_kernels(tag, n, f.k, f.n_experts, d,
                                                      f.expert_size, dev, gen, K, ops)
        timings[arch] = _time_training_kernels(tag, "pallas_fused", K, plans["all experts"],
                                               inputs(torch.bfloat16, plans["all experts"]),
                                               n, d, f.expert_size, f.n_experts, errs)
        results.setdefault("phaseA", {})[arch] = {
            "errors": {f"{a} {b}": v for (a, b), v in errs.items()},
            "timings": timings[arch]}
        del plans
        print(f"[A] {arch}: took {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # ------------- B. one full-width wt103-262m-moe step: kernels vs plain
    t0 = time.perf_counter()
    results["phaseB"] = _phase_b(seed, dev, K, ops, routing)
    torch.cuda.empty_cache()
    print(f"[B] took {time.perf_counter() - t0:.1f} s", flush=True)

    # ------------------------------- C and D. the pairs, trained, evaluated
    build = ROOT / "build" / "chip_smoke"
    build.mkdir(parents=True, exist_ok=True)
    corpus = build / "corpus.bin"
    files = _corpus_files()
    with open(corpus, "wb") as out:
        for path in files:
            out.write((ROOT / path).read_bytes())
    print(f"[D] byte corpus: {len(files)} files (src/**/*.py, tests/*.py, *.md), "
          f"{corpus.stat().st_size:,} bytes -> {corpus.relative_to(ROOT)}", flush=True)
    stream = DataIterator(make_dataset("synthetic", get_config(PAIRS["wt103"][1]).vocab_size),
                          PAIR["batch"], PAIR["seq"] + 1, seed=seed)
    runs = {}
    for tag, pair, data in (("C", "wt103", "synthetic"), ("D", "enwik8", str(corpus))):
        t0 = time.perf_counter()
        for arch in PAIRS[pair]:
            layers = get_config(arch).n_layers
            moe = get_config(arch).ffn.kind == "sigma_moe"
            want = dict.fromkeys(K.LAUNCHES, 0) | ({
                "fused_w1": 2 * layers, "fused_w2": layers, "dw_streamed": 2 * layers,
                "cvmm": layers} if moe else {})
            argv = ["--arch", arch, "--steps", str(PAIR["steps"]), "--batch",
                    str(PAIR["batch"]), "--seq", str(PAIR["seq"]), "--seed", str(seed),
                    "--data", data, "--device", dev.type]
            run = _train_main_path(tag, argv, want, K, train_cli,
                                   eval_batches=PAIR["eval_batches"])
            _print_run(tag, run)
            torch.cuda.empty_cache()
            if pair == "wt103":
                lm = build_model(get_config(arch))
                opt = OptimizerConfig(total_steps=PAIR["steps"])
                state = init_train_state(lm, torch.Generator(device=dev).manual_seed(seed),
                                         opt, use_mems=True, batch=PAIR["batch"], device=dev)
                run["profile"], _ = _profile_train_step(
                    tag, lm, state, {"tokens": torch.as_tensor(stream.next()["tokens"],
                                                               device=dev)},
                    make_train_step(lm, opt), dev, K, ops)
                del lm, state
                torch.cuda.empty_cache()
            evals = run["eval_losses"]
            bpb = [c / math.log(2) for c in run["eval_ce"]]
            print(f"[{tag}] {arch}: {run['n_params']:,} params (reference "
                  f"{PAPER_PARAMS[arch]:,}); eval loss on {len(evals)} held-out batches "
                  f"(seed + 1000) {[round(x, 4) for x in evals]}, step-0 training loss "
                  f"{run['losses'][0]:.4f}"
                  + (f"; bits per byte {[round(x, 4) for x in bpb]}" if pair == "enwik8"
                     else ""), flush=True)
            if run["n_params"] != PAPER_PARAMS[arch]:
                fail(f"{arch}: {run['n_params']} parameters, the reference has "
                     f"{PAPER_PARAMS[arch]}")
            if not all(math.isfinite(x) and x < run["losses"][0] for x in evals):
                fail(f"{arch}: eval losses {evals} not finite and below the step-0 "
                     f"training loss {run['losses'][0]}")
            runs[arch] = run | {"bits_per_byte": bpb if pair == "enwik8" else None}
        dense, moe = (runs[a] for a in PAIRS[pair])
        print(f"[{tag}] parameters sigma-MoE / dense = {moe['n_params']:,} / "
              f"{dense['n_params']:,} = {moe['n_params'] / dense['n_params']:.6f}; step "
              f"{moe['step_ms']:.2f} / {dense['step_ms']:.2f} ms; last-5 loss "
              f"{moe['last5']:.4f} / {dense['last5']:.4f}")
        print(f"[{tag}] took {time.perf_counter() - t0:.1f} s", flush=True)
    corpus.unlink()
    results["pairs"] = runs

    # ---------------------------------------------- E. checkpoint and resume
    t0 = time.perf_counter()
    results["resume"] = _resume_phase(seed, dev, train_cli, build)
    print(f"[E] took {time.perf_counter() - t0:.1f} s", flush=True)

    src = "src/repro_torch/kernels/csrc/"
    arch = PAIRS["wt103"][1]
    rows = []
    for kernel, case, source, replaces in (
            ("fused_w1", "fused_w1 relu+h (forward)", "fused_w1.cu", "cvmm.py:513"),
            ("fused_w2", "fused_w2 (forward)", "fused_w2.cu", "cvmm.py:820"),
            ("dw_streamed", "dw_streamed stream_x (dW1)", "dw_streamed.cu", "cvmm.py:730"),
            ("cvmm", "cvmm (dX = dh w1^T)", "cvmm.cu", "cvmm.py:241")):
        t = next(t for t in timings[arch] if t["case"] == case)
        rows.append({"name": kernel, "route": "cuda", "source": src + source,
                     "replaces": "src/repro/kernels/" + replaces,
                     "launches": runs[arch]["launches"][kernel],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"],
                     "library_device_ms": t["library_device_ms"], "shape": t["shape"],
                     "dtype": "bfloat16", "path": f"training, {arch}, pallas_fused rung"})
    return rows


def _swap_slice(seed, dev, gen, K, results):
    """Phases F-H: the paper's PKM and top-K MLP, swapped into
    wt103-47m-dense by ``--ffn``, with their value sums on K6 forward and
    backward. F: K6 and the two autograd Functions at the swaps' shapes; G:
    one full-width step, kernels against plain versions; H: the trainer's
    main path. Returns the kernels line's K6 rows at F's shapes, with their
    launches from H."""
    import torch
    from repro_torch.core import routing
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    layers, timings = _phase_f(dev, gen, K, ops, results)
    torch.cuda.empty_cache()
    print(f"[F] took {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    results["phaseG"] = _phase_g(seed, dev, K, ops, routing)
    torch.cuda.empty_cache()
    print(f"[G] took {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    runs = results["phaseH"] = _phase_h(seed, dev, K, ops)
    print(f"[H] took {time.perf_counter() - t0:.1f} s", flush=True)

    rows = []
    for kind in SWAP["kinds"]:
        t = next(t for t in timings if t["layer"] == kind and t["case"] == "dedup")
        rows.append({"name": "gather_rows", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/gather_rows.cu",
                     "replaces": "src/repro/kernels/cvmm.py:621",
                     "launches": runs[kind]["launches"]["gather_rows"],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"],
                     "library_device_ms": t["library_device_ms"], "shape": t["shape"],
                     "dtype": "bfloat16",
                     "path": f"training, {SWAP['arch']} --ffn {kind}, "
                             "gathered_weighted_sum_dedup"})
    return rows


def _swap_layer(kind, dev, gen):
    """One random layer of ``SWAP["arch"]`` with its FFN swapped to ``kind``
    at the trainer's tokens a layer call, in bf16: (its value table, its
    selection of the table's rows)."""
    import torch
    from repro_torch.core import pkm, routing
    from repro_torch.core.dispatch import Selection
    from repro_torch.models import build_model, ffn

    cfg = build_model(SWAP["arch"], ffn=kind).cfg
    f = cfg.ffn
    params = {k: v.to(torch.bfloat16) for k, v in ffn.init_ffn(
        gen, cfg.d_model, f, cfg.n_layers, device=dev).items()}
    x = torch.randn((SWAP["batch"] * (SWAP["seq"] + 1), cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    if kind == "pkm":
        return params["values"], pkm.pkm_select(params, x, f)
    vals, idx = routing.top_k(torch.relu(x @ params["w1"]), f.topk_k)
    return params["w2"], Selection(idx=idx, weights=vals, n_items=f.d_ff)


def _phase_f(dev, gen, K, ops, results):
    """Phase F: K6 against its plain version on the swaps' dedup plans (and
    PKM's weighted GatherPlan), exactly and the same bits twice, in bf16 and
    float32; the autograd Functions' forward and gradients, kernels against
    plain versions within phase 3's tolerances; K6 timed as phase 6 does.
    Returns (the layers' numbers, the timings)."""
    import torch

    layers, errs, timings = {}, {}, []
    for kind in SWAP["kinds"]:
        table, sel = _swap_layer(kind, dev, gen)
        n, n_rows = sel.idx.shape[0], table.shape[0]
        plan = ops.make_dedup_gather_plan(sel.idx, sel.weights, n_rows)
        gplan = ops.make_gather_plan(sel.idx, sel.weights, n_rows) if kind == "pkm" else None
        n_unique = int((plan.row_src < n_rows).sum())
        layers[kind] = {"tokens": n, "selections": sel.idx.numel(), "table_rows": n_rows,
                        "unique_rows": n_unique, "u_pad": plan.u_pad}
        print(f"[F] --ffn {kind}: {n} tokens x {sel.idx.shape[1]} = {sel.idx.numel():,} "
              f"selections of {n_rows} rows of {table.shape[1]}; dedup plan: {n_unique} "
              f"rows selected, U_pad {plan.u_pad}"
              + (f"; GatherPlan M_pad {gplan.m_pad:,}" if gplan is not None else ""))
        cases = [("dedup", plan.row_src, None)]
        if gplan is not None:
            cases.append(("GatherPlan weighted", gplan.row_src,
                          gplan.weight_tiles.reshape(-1)))
        for dt in (torch.bfloat16, torch.float32):
            dn = str(dt).split(".")[1]
            vp = ops._pad_lane(table.to(dt), 1)
            for case, rs, wt in cases:
                got, again = K.gather_rows(vp, rs, wt), K.gather_rows(vp, rs, wt)
                want = K.gather_rows_plain(vp, rs, wt)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                exact, twice = same_bits(got, want), same_bits(got, again)
                print(f"[F] gather_rows --ffn {kind} {case} into {rs.numel():,} rows of "
                      f"{vp.shape[1]} {dn}: max_abs_err {err:.3g}, the plain version's bits "
                      f"{exact}, same bits twice {twice} {'ok' if exact and twice else 'BAD'}")
                if not exact:
                    fail(f"gather_rows disagrees with gather_rows_plain (--ffn {kind} {case} {dn})")
                if not twice:
                    fail(f"gather_rows gave different bits on a second call (--ffn {kind} {case})")
                errs[(kind, case, dn)] = err
                del got, again, want
        # the Functions, forward and both gradients, kernels against plain
        cot = torch.randn((n, table.shape[1]), generator=gen, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            dn = str(dt).split(".")[1]
            for fn in ("gathered_weighted_sum_dedup",) + (
                    ("gathered_weighted_sum",) if gplan is not None else ()):
                def run():
                    v = table.detach().to(dt).requires_grad_()
                    w = sel.weights.detach().float().requires_grad_()
                    if fn == "gathered_weighted_sum":
                        y = ops.gathered_weighted_sum(
                            v, ops.make_gather_plan(sel.idx, w, n_rows), n)
                    else:
                        y = ops.gathered_weighted_sum_dedup(
                            v, ops.make_dedup_gather_plan(sel.idx, w, n_rows), n)
                    (y.float() * cot).sum().backward()
                    return y.detach(), v.grad, w.grad
                before = K.LAUNCHES["gather_rows"]
                got = run()
                torch.cuda.synchronize()
                launched = K.LAUNCHES["gather_rows"] - before
                with plain_kernels(K):
                    want = run()
                for name, g, w in zip(("y", "dvalues", "dweights"), got, want):
                    ok, err, rel, lim = close(g, w, TOL[dn], dn, ulps=False)
                    print(f"[F] {fn} --ffn {kind} {name} {dn}: kernels vs plain max_abs_err "
                          f"{err:.3g}, normwise {rel:.3g} ({lim}) {'ok' if ok else 'BAD'}")
                    if not ok:
                        fail(f"{fn} (--ffn {kind}) {name} disagrees with the plain versions "
                             f"in {dn}")
                    errs[(kind, fn, name, dn)] = err
                print(f"[F] {fn} --ffn {kind} {dn}: {launched} K6 launches (1 forward, "
                      "1 backward)")
                if launched != 2:
                    fail(f"{fn} launched K6 {launched} times for one forward and backward")
                del got, want
        # K6 timed at the main path's dtype, device alone beside its bound,
        # its plain version and index_select (the weighted form has no
        # single library call)
        vp = ops._pad_lane(table.to(torch.bfloat16), 1)
        vz = torch.cat([vp, vp.new_zeros((1, vp.shape[1]))])
        row_bytes = vp.shape[1] * vp.element_size()
        for case, rs, wt in cases:
            nbytes = (n_unique + rs.numel()) * row_bytes + rs.numel() * 4 * (
                1 if wt is None else 2)
            lib = (lambda rs=rs: torch.index_select(vz, 0, rs)) if wt is None else None
            timings.append({
                "kernel": "gather_rows", "layer": kind, "case": case,
                "shape": f"--ffn {kind} {case}: {n_unique} of {n_rows} rows of "
                         f"{vp.shape[1]} into {rs.numel():,}",
                "dtype": "bfloat16", "path": f"training, {SWAP['arch']} --ffn {kind}",
                "ms": _time_ms(lambda: K.gather_rows(vp, rs, wt)),
                "device_ms": _device_ms(lambda: K.gather_rows(vp, rs, wt)),
                "plain_ms": _time_ms(lambda: K.gather_rows_plain(vp, rs, wt)),
                "library_ms": _time_ms(lib) if lib else None,
                "library_device_ms": _device_ms(lib) if lib else None,
                "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
                "max_abs_err": errs[(kind, case, "bfloat16")]})
        del table, sel, plan, gplan, cot, vp, vz
    for t in timings:
        lib = (f"index_select {t['library_ms']:.4f} ms ({t['library_device_ms']:.4f} device "
               "alone)" if t["library_ms"] is not None else "no library call")
        print(f"[F] {t['kernel']} {t['shape']} bf16: kernel {t['ms']:.4f} ms "
              f"({t['device_ms']:.4f} device alone), plain {t['plain_ms']:.4f} ms, {lib}, "
              f"bound {t['bound_ms']:.4f} ms (bytes)")
    results["phaseF"] = {"layers": layers, "timings": timings,
                         "errors": {" ".join(map(str, k)): v for k, v in errs.items()}}
    return layers, timings


def _phase_g(seed, dev, K, ops, routing):
    """Phase G: one full-width training step of each swap (the gradients of
    a first batch, then 3 train steps), kernels against plain versions on
    the same selections under deterministic algorithms. K6 copies rows
    exactly and nothing else differs, so the losses and every gradient leaf
    must be equal bit for bit; the same gate must reject a planted K6
    fault."""
    import torch
    from repro_torch.configs import OptimizerConfig
    from repro_torch.data import DataIterator, make_dataset
    from repro_torch.models import build_model

    out = {}
    fault = "K6 row read from its neighbour"
    for kind in SWAP["kinds"]:
        cfg = build_model(SWAP["arch"], ffn=kind).cfg
        stream = DataIterator(make_dataset("synthetic", cfg.vocab_size), SWAP["batch"],
                              SWAP["seq"] + 1, seed=seed)
        batches = [{"tokens": torch.as_tensor(stream.next()["tokens"], device=dev)}
                   for _ in range(3)]
        three_steps = _three_steps_fn(batches, OptimizerConfig(total_steps=3), seed, dev,
                                      batch=SWAP["batch"])
        want = dict.fromkeys(K.LAUNCHES, 0) | {"gather_rows": 8 * cfg.n_layers}
        with deterministic_algorithms(f"G --ffn {kind}"):
            lm = build_model(cfg)
            choices, (gk, lk), (gp, lp), launches = _kernels_and_plain(
                "pallas_fused", lm, three_steps, K, ops, routing)
            differ = [p for p in gp if not same_bits(gk[p], gp[p])]
            worst, leaf, median = _compare(gk, gp)
            print(f"[G] --ffn {kind}, {cfg.dtype}, depth {cfg.n_layers}, full width, "
                  f"{len(gp)} gradient leaves, same selections: {len(differ)} leaves not "
                  f"bit-equal, worst relative error {worst:.3g} at {leaf}; losses kernels "
                  f"{lk} plain {lp}, equal {lk == lp}; launches {launches} (expected "
                  f"{want}: 2 K6 a layer in each of 4 forward and backward passes)")
            if launches != want:
                fail(f"--ffn {kind}: the step launched {launches}, expected {want}")
            if differ or lk != lp:
                fail(f"--ffn {kind}: the kernels' step is not bit-equal to the plain "
                     f"versions' ({len(differ)} leaves, e.g. {differ[:3]})")
            with pinned_impl(ops, "pallas_fused"), \
                    pinned_routing(routing, choices, replay=True), planted_fault(K, fault):
                gf, lf = three_steps(lm)
            bad = [p for p in gp if not same_bits(gf[p], gp[p])]
            fworst = _compare(gf, gp)
            caught = bool(bad) or lf != lp
            print(f"[G] --ffn {kind}, planted fault ({fault}), same selections: "
                  f"{len(bad)} leaves not bit-equal, worst relative error {fworst[0]:.3g} at "
                  f"{fworst[1]}; losses {lf}: {'rejected' if caught else 'PASSED'}")
            if not caught:
                fail(f"phase G's gate let a planted K6 fault through (--ffn {kind})")
        out[kind] = {"leaves": len(gp), "not_bit_equal": len(differ), "worst": worst,
                     "losses_kernels": lk, "losses_plain": lp, "launches": launches,
                     "fault": {"leaves_not_bit_equal": len(bad), "worst": fworst[0],
                               "leaf": fworst[1], "losses": lf}}
        del lm, gk, gp, gf, three_steps, batches
        torch.cuda.empty_cache()
    return out


def _phase_h(seed, dev, K, ops):
    """Phase H: the trainer's main path with ``--ffn pkm``, ``--ffn topk``
    and without ``--ffn`` (the dense baseline), each SWAP's steps then the eval
    step on 4 held-out batches, a profiled step, and for PKM the share of
    the values the last batch selected. Returns the runs."""
    import torch
    from repro_torch.configs import OptimizerConfig
    from repro_torch.data import DataIterator, make_dataset
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model, stack
    from repro_torch.runtime import init_train_state, make_train_step

    runs = {}
    for kind in ("dense",) + SWAP["kinds"]:
        swap = [] if kind == "dense" else ["--ffn", kind]
        key = SWAP["arch"] + (f" --ffn {kind}" if swap else "")
        lm = build_model(SWAP["arch"], ffn=kind if swap else None)
        layers = lm.cfg.n_layers
        want = dict.fromkeys(K.LAUNCHES, 0) | ({"gather_rows": 2 * layers} if swap else {})
        argv = ["--arch", SWAP["arch"], *swap, "--steps", str(SWAP["steps"]), "--batch",
                str(SWAP["batch"]), "--seq", str(SWAP["seq"]), "--seed", str(seed),
                "--device", dev.type]
        run = _train_main_path("H", argv, want, K, train_cli,
                               eval_batches=SWAP["eval_batches"], keep_state=True)
        _print_run("H", run)
        state = run.pop("state")
        total = (SWAP["steps"] * 2 + SWAP["eval_batches"]) * layers if swap else 0
        evals = run["eval_losses"]
        print(f"[H] {key}: {run['n_params']:,} params (reference {PAPER_PARAMS[key]:,}); "
              f"K6 launches {run['launches']['gather_rows']} (expected {total}: 2 a layer "
              f"each step, 1 a layer each eval batch); eval loss on {len(evals)} held-out "
              f"batches (seed + 1000) {[round(x, 4) for x in evals]}, step-0 training loss "
              f"{run['losses'][0]:.4f}", flush=True)
        if run["n_params"] != PAPER_PARAMS[key]:
            fail(f"{key}: {run['n_params']} parameters, the reference has "
                 f"{PAPER_PARAMS[key]}")
        if run["launches"] != dict.fromkeys(K.LAUNCHES, 0) | {"gather_rows": total}:
            fail(f"{key}: the run and its eval launched {run['launches']}")
        if not all(math.isfinite(x) and x < run["losses"][0] for x in evals):
            fail(f"{key}: eval losses {evals} not finite and below the step-0 training "
                 f"loss {run['losses'][0]}")
        stream = DataIterator(make_dataset("synthetic", lm.cfg.vocab_size), SWAP["batch"],
                              SWAP["seq"] + 1, seed=seed)
        for _ in range(SWAP["steps"] - 1):
            stream.next()
        last = torch.as_tensor(stream.next()["tokens"], device=dev)
        if swap:
            usage = []
            apply_ffn = stack.apply_ffn

            def with_stats(params, x, cfg, **kw):
                y, aux = apply_ffn(params, x, cfg, collect_stats=True, **kw)
                usage.append(aux.pop("usage"))
                return y, aux

            stack.apply_ffn = with_stats
            try:
                with torch.no_grad():
                    lm.forward(state["params"], last)
            finally:
                stack.apply_ffn = apply_ffn
            share = [float((u["counts"] > 0).float().mean()) for u in usage]
            n_items = usage[0]["counts"].numel()
            print(f"[H] {key}: share of the {n_items:,} "
                  f"{'values' if kind == 'pkm' else 'W2 rows'} the last training batch "
                  f"selected, layer by layer: {[round(x, 3) for x in share]}")
            run["selected_share"] = share
        del state
        torch.cuda.empty_cache()
        opt = OptimizerConfig(total_steps=SWAP["steps"])
        pstate = init_train_state(lm, torch.Generator(device=dev).manual_seed(seed), opt,
                                  use_mems=True, batch=SWAP["batch"], device=dev)
        run["profile"], _ = _profile_train_step("H", lm, pstate, {"tokens": last},
                                                make_train_step(lm, opt), dev, K, ops)
        del lm, pstate
        torch.cuda.empty_cache()
        runs[kind] = run
    dense = runs["dense"]
    for kind in SWAP["kinds"]:
        r = runs[kind]
        print(f"[H] --ffn {kind} / dense: step {r['step_ms']:.2f} / {dense['step_ms']:.2f} ms "
              f"= {r['step_ms'] / dense['step_ms']:.2f}x; peak memory "
              f"{r['max_memory_allocated'] / 2**30:.2f} / "
              f"{dense['max_memory_allocated'] / 2**30:.2f} GiB; last-5 loss "
              f"{r['last5']:.4f} / {dense['last5']:.4f}")
    return runs


def _baselines_slice(seed, dev, gen, K, results, fused):
    """Phases I-K: the paper's MoE baselines and the trainer's options. I:
    the capacity dispatch against the sort path's kernels, its dropped
    share, one float32 step of S-BASE and of noisy top-k with the kernels
    against their plain versions, remat's gradients; J: the three
    baselines and the sigma-MoE swap trained; K: gradient accumulation,
    compression and remat through the trainer (``fused`` is phase 9's run,
    remat's "none"). Returns each run's kernel launches, for the kernels
    line."""
    import torch
    from repro_torch.core import routing
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    results["phaseI"] = _phase_i(seed, dev, gen, K, ops, routing)
    torch.cuda.empty_cache()
    print(f"[I] took {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    runs = results["phaseJ"] = _phase_j(seed, dev, K, ops)
    torch.cuda.empty_cache()
    print(f"[J] took {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    options = results["phaseK"] = _phase_k(seed, dev, K, fused)
    print(f"[K] took {time.perf_counter() - t0:.1f} s", flush=True)
    return {name: run["launches"] for name, run in {**runs, **options}.items()
            if "launches" in run}


def _baseline(kind, **overrides):
    """wt103-47m-moe with its FFN made the ``kind`` baseline
    (``BASELINES``)."""
    from repro_torch.configs import get_config
    cfg = get_config(BASE_RUN["arch"]).override(**overrides)
    return cfg.with_ffn(dataclasses.replace(cfg.ffn, **BASELINES[kind]))


def _per_layer(layers, k1, k2, k3, k4):
    """Every launch count at 0 but K1-K4's, ``layers`` times the given."""
    import repro_torch.kernels.cvmm as K
    return dict.fromkeys(K.LAUNCHES, 0) | {
        "fused_w1": k1 * layers, "fused_w2": k2 * layers, "dw_streamed": k3 * layers,
        "cvmm": k4 * layers}


def _phase_i(seed, dev, gen, K, ops, routing):
    """Phase I, the gates. (1) One wt103-47m-moe layer on phase 9's 32 x
    257 tokens: the capacity dispatch at a capacity that drops nothing
    against the sort path's kernels on the same routing (bf16 3e-2 and
    normwise 1e-2, float32 1e-4), launching no kernel itself; (2) at
    capacity factors 1.25 and 0.25, the dropped share equal to a host count
    of each expert's overflow; (3) one full-depth float32 step of S-BASE and
    of noisy top-k (phase 8's three_steps), the kernels against their plain
    versions on pinned routing, each gradient leaf and loss within 2e-3, with
    exact launches; (4) under deterministic algorithms, with dropout on, a
    bf16 step's gradients under remat "full" and "dots" bit-equal to the
    plain step's, the generator ending where the plain step's does, and
    exact launches (the recomputation relaunches K1 and K2)."""
    import torch
    from repro_torch.common import cdiv, map_leaves
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core import dispatch, moe
    from repro_torch.data import DataIterator, make_dataset
    from repro_torch.models import build_model
    from repro_torch.runtime import init_train_state

    out = {}
    cfg = get_config(BASE_RUN["arch"])
    f, d, layers = cfg.ffn, cfg.d_model, cfg.n_layers
    n, E, k = BASE_RUN["batch"] * (BASE_RUN["seq"] + 1), f.n_experts, f.k
    params = moe.init_moe(torch.Generator(device=dev).manual_seed(seed), d, f, layers,
                          device=dev)
    x32 = torch.randn((n, d), generator=gen, device=dev)
    for dn, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        x = x32.to(dt)
        with torch.no_grad():
            info = moe._route(params, x, f, E, None, False)
            counts = torch.bincount(info.idx.reshape(-1), minlength=E).tolist()
            K.reset_launch_counts()
            ys, _ = moe.apply_moe(params, x, f)
            sort_launches = dict(K.LAUNCHES)
            roomy = dataclasses.replace(f, dispatch="einsum",
                                        capacity_factor=(max(counts) + 1) / cdiv(n * k, E))
            K.reset_launch_counts()
            ye, aux = moe.apply_moe(params, x, roomy)
            einsum_launches = dict(K.LAUNCHES)
        ok, err, rel, lim = close(ye, ys, TOL[dn], dn, ulps=False)
        print(f"[I] capacity dispatch (capacity {dispatch._capacity(n, k, E, roomy.capacity_factor)}"
              f" >= the busiest expert's {max(counts)} rows) against the sort path's kernels, "
              f"{dn}, {n} tokens: max_abs_err {err:.3g}, normwise {rel:.3g} ({lim}); dropped "
              f"{float(aux['moe_dropped'])}; launches sort {sort_launches}, capacity "
              f"{einsum_launches}: {'ok' if ok else 'BAD'}")
        if not ok or float(aux["moe_dropped"]) != 0.0:
            fail(f"the capacity dispatch disagrees with the sort path's kernels ({dn})")
        if (sort_launches != _per_layer(1, 1, 1, 0, 0) or any(einsum_launches.values())):
            fail(f"launches: sort {sort_launches}, capacity {einsum_launches}")
        out[f"capacity vs sort {dn}"] = {"max_abs_err": err, "normwise": rel}
    for factor in (1.25, 0.25):         # on the last (float32) routing's loads
        cap = dispatch._capacity(n, k, E, factor)
        with torch.no_grad():
            _, aux = moe.apply_moe(params, x, dataclasses.replace(
                f, dispatch="einsum", capacity_factor=factor))
        host = sum(max(0, c - cap) for c in counts) / (n * k)
        got = float(aux["moe_dropped"])
        print(f"[I] capacity factor {factor}: capacity {cap} rows an expert, loads {counts}; "
              f"dropped {got:.6f}, host count of the overflow {host:.6f}")
        if abs(got - host) > 1e-6:
            fail(f"dropped share {got} != the host count {host} at factor {factor}")
        out[f"dropped at {factor}"] = {"dropped": got, "host": host, "capacity": cap}
    del params, x32, x

    opt = OptimizerConfig(total_steps=3)
    stream = DataIterator(make_dataset("synthetic", cfg.vocab_size), BASE_RUN["batch"],
                          BASE_RUN["seq"] + 1, seed=seed)
    batches = [{"tokens": torch.as_tensor(stream.next()["tokens"], device=dev)}
               for _ in range(3)]
    three_steps = _three_steps_fn(batches, opt, seed, dev, batch=BASE_RUN["batch"])
    tol = GRAD_TOL["float32"]
    for kind in ("sbase", "noisy_topk"):
        lm = build_model(_baseline(kind, dtype="float32"))
        choices, (gk, lk), (gp, lp), launches = _kernels_and_plain(
            "pallas_fused", lm, three_steps, K, ops, routing)
        worst, leaf, median = _compare(gk, gp)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
        want = _per_layer(4 * layers, 2, 1, 2, 1)        # 4 forward and backward passes
        print(f"[I] {kind}, float32, depth {layers}, full width, {len(gp)} gradient leaves, "
              f"pinned routing: worst relative error {worst:.3g} at {leaf}, median "
              f"{median:.3g}; losses kernels {lk} plain {lp}, worst relative {loss_err:.3g} "
              f"(tol {tol}); launches {launches}")
        if not (worst <= tol and loss_err <= tol):
            fail(f"{kind}: the kernels' float32 step disagrees with the plain versions'")
        if launches != want:
            fail(f"{kind}: the step launched {launches}, expected {want}")
        out[f"{kind} float32 step"] = {"worst_grad_rel": worst, "worst_leaf": leaf,
                                       "median": median, "losses_kernels": lk,
                                       "losses_plain": lp, "launches": launches}
        del lm, gk, gp
        torch.cuda.empty_cache()

    remat = {}
    with deterministic_algorithms("I remat"):
        for mode in ("none", "full", "dots"):
            lm = build_model(cfg, remat=mode)
            state = init_train_state(lm, torch.Generator(device=dev).manual_seed(seed), opt,
                                     use_mems=True, batch=BASE_RUN["batch"], device=dev)
            drop = torch.Generator(device=dev).manual_seed(seed + 1)
            K.reset_launch_counts()
            loss, _ = lm.loss(state["params"], batches[0], gen=drop, train=True,
                              mems=state["mems"])
            loss.backward()
            launches = dict(K.LAUNCHES)
            grads = {}
            map_leaves(state["params"], lambda path, p: grads.setdefault(path, p.grad))
            remat[mode] = (float(loss.detach()), grads, drop.get_state(), launches)
            del lm, state, loss
    l0, g0, s0, _ = remat["none"]
    for mode, want in (("none", _per_layer(layers, 2, 1, 2, 1)),
                       ("full", _per_layer(layers, 3, 2, 2, 1)),
                       ("dots", _per_layer(layers, 3, 2, 2, 1))):
        loss, grads, state, launches = remat[mode]
        differ = [p for p in g0 if not same_bits(grads[p], g0[p])]
        same_gen = bool(torch.equal(state, s0))
        print(f"[I] remat {mode}, bf16, dropout {cfg.dropout}, deterministic algorithms: loss "
              f"{loss} (none {l0}); {len(differ)} of {len(g0)} gradient leaves not bit-equal "
              f"to none's; generator state equal {same_gen}; launches {launches}")
        if differ or loss != l0 or not same_gen:
            fail(f"remat {mode}: not bit-equal to the plain step ({differ[:3]})")
        if launches != want:
            fail(f"remat {mode}: launched {launches}, expected {want}")
        out[f"remat {mode}"] = {"loss": loss, "not_bit_equal": len(differ),
                                "launches": launches}
    del remat, g0
    return out


def _ep_slice(seed, dev, gen, K, ops, results):
    """Phase P: expert parallelism on a real NCCL process group of one rank
    (a file store in a temporary directory) and the mesh (data 1, model 1).
    Returns the kernels line's K4 and K5 rows at the EP buffer's shapes."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device=dev)
            out, rows = _phase_p(seed, dev, gen, K, ops, mesh, results)
        finally:
            dist.destroy_process_group()
    results["phaseP"] = out
    return rows


def _phase_p(seed, dev, gen, K, ops, mesh, results):
    """Phase P's gates and numbers (see the module docstring), on ``mesh``;
    ``results`` holds phases 9 and 13's runs, printed beside its own."""
    import types

    import torch
    from repro_torch import sharding
    from repro_torch.common import map_leaves
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core import dispatch, moe, routing
    from repro_torch.data import DataIterator, make_dataset
    from repro_torch.models import build_model
    from repro_torch.runtime import init_train_state, make_train_step
    from repro_torch.sharding import mesh_context

    out, t0 = {}, time.perf_counter()
    cfg = get_config(EP["arch"])
    f, d, g, layers = cfg.ffn, cfg.d_model, cfg.ffn.expert_size, cfg.n_layers
    E, k, n = f.n_experts, f.k, EP["tokens"]
    ep = dataclasses.replace(f, dispatch="shard_map")
    params = moe.init_moe(torch.Generator(device=dev).manual_seed(seed), d, f, layers,
                          device=dev)
    params = {key: v.requires_grad_() for key, v in params.items()}
    x32 = torch.randn((n, d), generator=gen, device=dev)
    cot32 = torch.randn((n, d), generator=gen, device=dev)

    def layer(x, cfg_, backward):
        """(y, dropped, grads of x, we1, we2) of one layer, with the kernel
        launches and collectives of its forward and backward."""
        for p in params.values():
            p.grad = None
        x = x.detach().requires_grad_()
        K.reset_launch_counts()
        sharding.reset_call_counts()
        with mesh_context(mesh), torch.set_grad_enabled(backward):
            y, aux = moe.apply_moe(params, x, cfg_)
            fwd = dict(K.LAUNCHES) | dict(sharding.CALLS)
            grads = None
            if backward:
                (y * cot32.to(y.dtype)).float().sum().backward()
                grads = {"x": x.grad, "we1": params["we1"].grad, "we2": params["we2"].grad}
        bwd = {key: v - fwd[key] for key, v in (dict(K.LAUNCHES) | dict(sharding.CALLS)).items()}
        return y.detach(), float(aux["moe_dropped"]), grads, fwd, bwd

    gated = (*K.LAUNCHES, "all_to_all")     # every kernel and the all_to_alls
    zero = dict.fromkeys(gated, 0)
    want_fwd = zero | {"cvmm": 2, "all_to_all": 2}
    want_bwd = zero | {"cvmm": 2, "cvmm_dw": 2, "all_to_all": 2}
    choices = []
    for dn, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        x = x32.to(dt)
        choices.clear()
        with pinned_routing(routing, choices, replay=False):
            yk, dropped, gk, fwd, bwd = layer(x, ep, True)
        with pinned_routing(routing, choices, replay=True), plain_kernels(K):
            yp, _, gp, _, _ = layer(x, ep, True)
        ok, err, rel, lim = close(yk, yp, TOL[dn], dn, ulps=False)
        grad_rel = {name: (torch.linalg.norm((gk[name] - gp[name]).float())
                           / torch.linalg.norm(gp[name].float())).item() for name in gk}
        print(f"[P] EP layer {dn}, {n} tokens, top-{k} of {E}, d {d}, G {g}, capacity "
              f"{dispatch._capacity(n, k, E, ep.capacity_factor)}: K4/K5 against plain "
              f"versions on the same routing: max_abs_err {err:.3g}, normwise {rel:.3g} "
              f"({lim}); gradients' relative error {grad_rel}; launches and collectives "
              f"forward {fwd}, backward {bwd}: {'ok' if ok else 'BAD'}")
        if not ok:
            fail(f"the EP layer's kernels disagree with their plain versions ({dn})")
        if dn == "float32" and max(grad_rel.values()) > 2e-4:
            fail(f"the EP layer's float32 gradients stray from the plain versions': {grad_rel}")
        if ({key: fwd[key] for key in gated} != want_fwd
                or {key: bwd[key] for key in gated} != want_bwd):
            fail(f"EP layer launches: forward {fwd} (want {want_fwd}), backward {bwd} "
                 f"(want {want_bwd})")
        out[f"layer {dn}"] = {"max_abs_err": err, "normwise": rel, "grad_rel": grad_rel,
                              "forward": fwd, "backward": bwd}
        counts = torch.bincount(choices[0].reshape(-1), minlength=E).tolist()
        cap = dispatch._capacity(n, k, E, ep.capacity_factor)
        host = sum(max(0, c - cap) for c in counts) / (n * k)
        print(f"[P] dropped at capacity factor {ep.capacity_factor} ({cap} rows an expert, "
              f"loads {counts}): {dropped:.6f}, host count of the overflow {host:.6f}")
        if abs(dropped - host) > 1e-6:
            fail(f"EP dropped share {dropped} != the host count {host} ({dn})")
        out[f"dropped {dn}"] = {"dropped": dropped, "host": host, "capacity": cap}
        tight = dataclasses.replace(ep, capacity_factor=0.25)       # most pairs drop
        cap = dispatch._capacity(n, k, E, tight.capacity_factor)
        host = sum(max(0, c - cap) for c in counts) / (n * k)
        with pinned_routing(routing, choices, replay=True):
            _, dropped, _, _, _ = layer(x, tight, False)
        print(f"[P] dropped at capacity factor 0.25 ({cap} rows an expert): {dropped:.6f}, "
              f"host count of the overflow {host:.6f}")
        if abs(dropped - host) > 1e-6:
            fail(f"EP dropped share {dropped} != the host count {host} at 0.25 ({dn})")
        out[f"dropped at 0.25 {dn}"] = {"dropped": dropped, "host": host, "capacity": cap}
        roomy = dataclasses.replace(ep, capacity_factor=E / k)       # nothing drops
        with pinned_routing(routing, choices * 2, replay=True):
            ye, dropped_e, _, _, _ = layer(x, roomy, False)
            ys, _, _, sort_launches, _ = layer(x, f, False)
        ok, err, rel, lim = close(ye, ys, TOL[dn], dn, ulps=False)
        print(f"[P] EP layer at capacity factor {E / k:g} against the sort path's kernels "
              f"({sort_launches['fused_w1']} K1, {sort_launches['fused_w2']} K2), {dn}: "
              f"max_abs_err {err:.3g}, normwise {rel:.3g} ({lim}); dropped {dropped_e}: "
              f"{'ok' if ok else 'BAD'}")
        if not ok or dropped_e != 0.0:
            fail(f"the EP layer without drops disagrees with the sort path ({dn})")
        out[f"ep vs sort {dn}"] = {"max_abs_err": err, "normwise": rel}
    print(f"[P] the layer's gates took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows = _time_ep_kernels(dev, gen, K, ops, E, dispatch._capacity(n, k, E, ep.capacity_factor),
                            d, g)
    print(f"[P] the kernels' timing took {time.perf_counter() - t0:.1f} s", flush=True)
    del params, x32, cot32
    torch.cuda.empty_cache()

    # the training main path with dispatch="shard_map", in process
    t0 = time.perf_counter()
    lm = build_model(cfg.with_ffn(ep), ep_degree=mesh.shape["model"])
    want = dict.fromkeys(K.LAUNCHES, 0) | {"cvmm": 4 * layers, "cvmm_dw": 2 * layers}
    cli = types.SimpleNamespace(main=lambda argv, eval_batches=0: _train_in_process(
        lm, seed, dev, steps=EP["steps"], mesh=mesh))
    run = _train_main_path("P", [f"(in process: {EP['arch']} dispatch=shard_map on mesh "
                                 f"{mesh.shape}, {EP['steps']} steps)"], want, K, cli)
    _print_run("P", run)
    bad = [i for i, c in enumerate(run["collectives_per_step"])
           if c["all_to_all"] != 4 * layers]
    print(f"[P] collectives per step {run['collectives_per_step'][-1]}; steps off "
          f"{4 * layers} all_to_alls: {bad}; beside phase 9 (fused rung) "
          f"{results['training']['step_ms']:.2f} ms and phase 13 (unfused) "
          f"{results['training_unfused']['step_ms']:.2f} ms a step")
    if bad:
        fail(f"EP steps {bad} did not run 2 all_to_alls forward and 2 backward a layer")
    out["train"] = run
    for row in rows:
        row["launches"] = run["launches"][row["name"]]
    torch.cuda.empty_cache()
    print(f"[P] the EP run took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()

    # float32 at full depth: the mesh's EP step against no mesh (the capacity
    # dispatch on torch.bmm), same routing, under deterministic algorithms (as
    # phase B) so that the two differ only in K4/K5's arithmetic against
    # cuBLAS's, not in the combine's atomic order too
    opt = OptimizerConfig(total_steps=3)
    stream = DataIterator(make_dataset("synthetic", cfg.vocab_size), BASE_RUN["batch"],
                          BASE_RUN["seq"] + 1, seed=seed)
    batches = [{"tokens": torch.as_tensor(stream.next()["tokens"], device=dev)}
               for _ in range(3)]
    lm32 = build_model(cfg.with_ffn(ep).override(dtype="float32"))
    choices = []
    with deterministic_algorithms("P float32"):
        with pinned_routing(routing, choices, replay=False):
            gm, lmesh = _three_steps_fn(batches, opt, seed, dev, BASE_RUN["batch"],
                                        mesh)(lm32)
        with pinned_routing(routing, choices, replay=True):
            gn, lnone = _three_steps_fn(batches, opt, seed, dev, BASE_RUN["batch"])(lm32)
    worst, leaf, median = _compare(gm, gn)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lmesh, lnone))
    print(f"[P] float32, depth {layers}: EP on the mesh against no mesh (the capacity "
          f"dispatch on torch.bmm), pinned routing: worst relative gradient error "
          f"{worst:.3g} at {leaf}, median {median:.3g}; losses {lmesh} vs {lnone}, worst "
          f"relative {loss_err:.3g} (tol {GRAD_TOL['float32']})")
    if not (worst <= GRAD_TOL["float32"] and loss_err <= GRAD_TOL["float32"]):
        fail("the EP step on the mesh strays from the step with no mesh")
    out["float32 mesh vs none"] = {"worst_grad_rel": worst, "worst_leaf": leaf,
                                   "median": median, "losses_mesh": lmesh,
                                   "losses_none": lnone}
    del lm32, gm, gn
    torch.cuda.empty_cache()
    print(f"[P] the float32 gate took {time.perf_counter() - t0:.1f} s", flush=True)

    # the default sort dispatch: the mesh adds nothing at world size 1
    lm = build_model(cfg)
    sort = {}
    with deterministic_algorithms("P"):
        for name, m in (("mesh", mesh), ("none", None)):
            stream = DataIterator(make_dataset("synthetic", cfg.vocab_size), BASE_RUN["batch"],
                                  BASE_RUN["seq"] + 1, seed=seed)
            state = init_train_state(lm, torch.Generator(device=dev).manual_seed(seed), opt,
                                     use_mems=True, batch=BASE_RUN["batch"], device=dev,
                                     mesh=m)
            step = make_train_step(lm, OptimizerConfig(total_steps=EP["sort_steps"]), mesh=m)
            drop = torch.Generator(device=dev).manual_seed(seed + 1)
            K.reset_launch_counts()
            losses = []
            for _ in range(EP["sort_steps"]):
                batch = {"tokens": torch.as_tensor(stream.next()["tokens"], device=dev)}
                state, metrics = step(state, batch, drop)
                losses.append(float(metrics["loss"]))
            leaves = {}
            map_leaves(state["params"], lambda path, p: leaves.setdefault(path, p.detach()))
            sort[name] = (losses, leaves, dict(K.LAUNCHES))
    (lmesh, pm, km), (ln, pn, kn) = sort["mesh"], sort["none"]
    differ = [p for p in pn if not same_bits(pm[p], pn[p])]
    want = _per_layer(layers * EP["sort_steps"], 2, 1, 2, 1)
    print(f"[P] sort dispatch, {EP['sort_steps']} steps under the mesh against none: losses "
          f"{lmesh} vs {ln}; {len(differ)} of {len(pn)} parameters not bit-equal; launches "
          f"{km} and {kn} (want {want})")
    if lmesh != ln or differ:
        fail(f"the one-rank mesh changed the sort dispatch's steps ({differ[:3]})")
    if km != want or kn != want:
        fail(f"sort dispatch launches {km}, {kn}, expected {want}")
    out["sort mesh vs none"] = {"losses": lmesh, "not_bit_equal": len(differ),
                                "launches": km}
    return out, rows


def _time_ep_kernels(dev, gen, K, ops, E, cap, d, g):
    """K4 (the w1 and w2 forward products) and K5 (dW1, dW2) on the EP
    shard's dense (E, cap, ·) buffer in its tile layout (``ops._tile_layout``
    of E groups of ``cap`` rows), bf16: against their plain versions, timed
    as phase 10 does beside the bound, the plain version and ``torch.bmm``
    on the (E, cap, ·) buffers. Bounds: the buffer's rows (every one is an
    input), each input read once and each output written once at the real
    widths, and 2 rows d g operations a product. Returns the kernels line's
    rows (K4 w1 with w2 beside it, K5 dW1 with dW2)."""
    import torch
    from repro_torch.kernels.cvmm import LANE

    rows = E * cap
    sizes = torch.full((E,), cap, dtype=torch.int32, device=dev)
    new_pos, te, m_pad = ops._tile_layout(sizes, rows, E)
    bf = torch.bfloat16

    def padded(a):                     # (E, cap, w) -> (M_pad, round_up(w, LANE))
        w = a.shape[-1]
        out = a.new_zeros((m_pad, -(-w // LANE) * LANE))
        out[new_pos, :w] = a.reshape(rows, w)
        return out

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    x, u = rnd(E, cap, d), rnd(E, cap, g)
    dh, dy = rnd(E, cap, g), rnd(E, cap, d)
    w1, w2 = rnd(E, d, g, scale=d ** -0.5), rnd(E, g, d, scale=g ** -0.5)
    xp, up, dhp, dyp = padded(x), padded(u), padded(dh), padded(dy)
    w1p, w2p = ops._pad_w(w1), ops._pad_w(w2)
    b = 2
    specs = [("cvmm", "K4 h = x w1 (EP forward)", lambda: K.cvmm(xp, te, w1p),
              lambda: K.cvmm_plain(xp, te, w1p), lambda: torch.bmm(x, w1),
              rows * d * b + E * d * g * b + rows * g * b),
             ("cvmm", "K4 y = u w2 (EP forward)", lambda: K.cvmm(up, te, w2p),
              lambda: K.cvmm_plain(up, te, w2p), lambda: torch.bmm(u, w2),
              rows * g * b + E * d * g * b + rows * d * b),
             ("cvmm_dw", "K5 dW1 = x^T dh (EP backward)", lambda: K.cvmm_dw(xp, te, dhp, E),
              lambda: K.cvmm_dw_plain(xp, te, dhp, E),
              lambda: torch.bmm(x.transpose(1, 2), dh),
              rows * d * b + rows * g * b + E * d * g * 4),
             ("cvmm_dw", "K5 dW2 = u^T dy (EP backward)", lambda: K.cvmm_dw(up, te, dyp, E),
              lambda: K.cvmm_dw_plain(up, te, dyp, E),
              lambda: torch.bmm(u.transpose(1, 2), dy),
              rows * g * b + rows * d * b + E * d * g * 4)]
    flops = 2 * rows * d * g
    shape = f"EP buffer {E} x {cap} rows (M_pad {m_pad}), d {d}, G {g}"
    timed = []
    for name, case, fn, plain, lib, nbytes in specs:
        err = (fn().float() - plain().float()).abs().max().item()
        bb, bf_ = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
        row = {"case": case, "shape": shape, "dtype": "bfloat16", "max_abs_err": err,
               "ms": _time_ms(fn), "device_ms": _device_ms(fn), "plain_ms": _time_ms(plain),
               "library_ms": _time_ms(lib), "library_device_ms": _device_ms(lib),
               "bound_ms": 1e3 * max(bb, bf_), "bound_by": "bytes" if bb >= bf_ else "operations",
               "bound_bytes": nbytes, "bound_flops": flops}
        print(f"[P] {case} bf16, {shape}: kernel {row['ms']:.4f} ms ({row['device_ms']:.4f} "
              f"device alone), plain {row['plain_ms']:.4f} ms, library (torch.bmm) "
              f"{row['library_ms']:.4f} ms ({row['library_device_ms']:.4f} device alone), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); max_abs_err against plain {err:.3g}")
        lim = TOL["bfloat16"] * max(plain().float().abs().max().item(), 1.0)
        if not err <= lim:
            fail(f"{case}: the kernel differs from its plain version by {err} (limit {lim})")
        timed.append((name, row))
    out = []
    for name, source, replaces in (("cvmm", "cvmm.cu", "src/repro/kernels/cvmm.py:241"),
                                   ("cvmm_dw", "cvmm_dw.cu", "src/repro/kernels/cvmm.py:296")):
        first, second = [row for kernel, row in timed if kernel == name]
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/kernels/csrc/{source}", "replaces": replaces,
                    "launches": None, **{key: first[key] for key in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                        "device_ms", "library_device_ms", "shape", "case", "dtype")},
                    "second_case": second, "path": "expert parallelism (shard_map)"})
    return out


def _train_in_process(lm, seed, dev, steps=BASE_RUN["steps"], mesh=None):
    """``launch.train.main``'s loop and numbers for a model that has no
    ``--arch``/``--ffn`` name (the baselines, the EP config): BASE_RUN's
    batch and sequence, ``steps`` steps, the synthetic stream of ``seed``,
    dropout from ``seed + 1``, the trainer's optimizer, on ``mesh`` if
    given (then also each step's collectives); the step ends in a host read
    of the loss."""
    import torch
    from repro_torch import sharding
    from repro_torch.common import tree_leaves
    from repro_torch.configs import OptimizerConfig
    from repro_torch.data import DataIterator, make_dataset
    from repro_torch.kernels import cvmm as K
    from repro_torch.runtime import init_train_state, make_train_step

    b, s = BASE_RUN["batch"], BASE_RUN["seq"]
    opt = OptimizerConfig(total_steps=steps)
    stream = DataIterator(make_dataset("synthetic", lm.cfg.vocab_size), b, s + 1, seed=seed)
    state = init_train_state(lm, torch.Generator(device=dev).manual_seed(seed), opt,
                             use_mems=True, batch=b, device=dev, mesh=mesh)
    step = make_train_step(lm, opt, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {"losses": [], "step_s": [], "launches": [], "moe_dropped": [],
           "collectives": [], "tokens_per_step": b * s,
           "n_params": sum(p.numel() for p in tree_leaves(state["params"]))}
    for _ in range(steps):
        batch = {"tokens": torch.as_tensor(stream.next()["tokens"], device=dev)}
        before, calls = dict(K.LAUNCHES), dict(sharding.CALLS)
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        out["losses"].append(float(m["loss"]))
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"].append({key: K.LAUNCHES[key] - before[key] for key in before})
        out["collectives"].append({key: sharding.CALLS[key] - calls[key] for key in calls})
        out["moe_dropped"].append(float(m["moe_dropped"]))
    return out


def _phase_j(seed, dev, K, ops):
    """Phase J: S-BASE, noisy top-k and Switch (``BASELINES``, in process)
    and the sigma-MoE swap (``python -m repro_torch.launch.train --arch
    wt103-47m-dense --ffn sigma_moe``), BASE_RUN's steps each at full
    width and depth: finite, falling loss, exact launches every step (2 K1,
    1 K2, 2 K3 and 1 K4 a layer on the sort dispatch, none on the capacity
    dispatch), the dropped share, parameter counts equal to the
    reference's, and a profiled step."""
    import types

    import torch
    from repro_torch.configs import OptimizerConfig
    from repro_torch.data import DataIterator, make_dataset
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.runtime import init_train_state, make_train_step

    runs = {}
    b, s = BASE_RUN["batch"], BASE_RUN["seq"]
    for name in ("sbase", "noisy_topk", "switch", "--ffn sigma_moe"):
        if name.startswith("--ffn"):
            key, arch = "wt103-47m-dense --ffn sigma_moe", "wt103-47m-dense"
            lm = build_model(arch, ffn="sigma_moe")
            argv = ["--arch", arch, "--ffn", "sigma_moe", "--steps", str(BASE_RUN["steps"]),
                    "--batch", str(b), "--seq", str(s), "--seed", str(seed),
                    "--device", dev.type]
            cli = train_cli
        else:
            key = f"{BASE_RUN['arch']} {name}"
            lm = build_model(_baseline(name))
            argv = [f"(in process: {key}, batch {b} x seq {s}, {BASE_RUN['steps']} steps)"]
            cli = types.SimpleNamespace(main=lambda argv, eval_batches=0, lm=lm:
                                        _train_in_process(lm, seed, dev))
        layers = lm.cfg.n_layers
        sort = lm.cfg.ffn.dispatch == "sort"
        want = _per_layer(layers, 2, 1, 2, 1) if sort else dict.fromkeys(K.LAUNCHES, 0)
        run = _train_main_path("J", argv, want, K, cli)
        _print_run("J", run)
        dropped = [x / layers for x in run["moe_dropped_per_step"]]
        print(f"[J] {key}: {run['n_params']:,} params (reference {PAPER_PARAMS[key]:,}); "
              f"{lm.cfg.ffn.dispatch} dispatch; dropped share of the (token, expert) pairs, "
              f"mean over the layers, every fifth step: "
              f"{[round(x, 5) for x in dropped[::5]]}", flush=True)
        if run["n_params"] != PAPER_PARAMS[key]:
            fail(f"{key}: {run['n_params']} parameters, the reference has {PAPER_PARAMS[key]}")
        if sort and any(dropped):
            fail(f"{key}: the dropless sort dispatch reported drops {dropped}")
        run["dropped"] = dropped
        torch.cuda.empty_cache()
        opt = OptimizerConfig(total_steps=BASE_RUN["steps"])
        stream = DataIterator(make_dataset("synthetic", lm.cfg.vocab_size), b, s + 1,
                              seed=seed + 7)
        pstate = init_train_state(lm, torch.Generator(device=dev).manual_seed(seed), opt,
                                  use_mems=True, batch=b, device=dev)
        run["profile"], _ = _profile_train_step(
            "J", lm, pstate, {"tokens": torch.as_tensor(stream.next()["tokens"], device=dev)},
            make_train_step(lm, opt), dev, K, ops)
        del lm, pstate
        torch.cuda.empty_cache()
        runs[key] = run
    return runs


def _phase_k(seed, dev, K, fused):
    """Phase K: the trainer's options on wt103-47m-moe at phase 9's batch,
    10 steps each through ``python -m repro_torch.launch.train``:
    ``--grad-accum 2`` (microbatches of 16, memories of 16 rows; twice the
    launches), ``--grad-compression int8`` and ``bf16`` (every int8
    residual within half a quantization step of its stacked leaf, from the
    last step's compressed gradients), ``--remat full`` and ``dots`` (3 K1,
    2 K2, 2 K3 and 1 K4 a layer) with their peak memory beside phase 9's
    (no remat), full below it. Each: finite, falling loss and exact
    launches every step."""
    import torch
    from repro_torch.common import map_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.compress import stacked_path
    from repro_torch.runtime import steps as steps_mod

    layers = get_config(BASE_RUN["arch"]).n_layers
    base = ["--arch", BASE_RUN["arch"], "--steps", str(BASE_RUN["option_steps"]), "--batch",
            str(BASE_RUN["batch"]), "--seq", str(BASE_RUN["seq"]), "--seed", str(seed),
            "--device", dev.type]
    plain, remat = _per_layer(layers, 2, 1, 2, 1), _per_layer(layers, 3, 2, 2, 1)
    options = {"--grad-accum 2": _per_layer(2 * layers, 2, 1, 2, 1),
               "--grad-compression int8": plain, "--grad-compression bf16": plain,
               "--remat full": remat, "--remat dots": remat}
    runs = {}
    compress = steps_mod.compress_grads
    for option, want in options.items():
        last = {}

        def capture(grads, err, mode, *mesh_args):
            last["in"] = (grads, err)
            return compress(grads, err, mode, *mesh_args)

        steps_mod.compress_grads = capture
        try:
            run = _train_main_path("K", base + option.split(), want, K, train_cli,
                                   keep_state=True)
        finally:
            steps_mod.compress_grads = compress
        state = run.pop("state")
        _print_run("K", run)
        if option.endswith("int8"):
            grads, err_in = last["in"]
            totals, absmax = {}, {}
            map_leaves(grads, lambda path, g: totals.setdefault(path, g))
            map_leaves(err_in, lambda path, e: totals.__setitem__(
                path, (totals[path].float() + e).abs().max()))
            for path, top in totals.items():
                key = stacked_path(path)
                absmax[key] = max(absmax.get(key, 0.0), float(top))
            worst = []
            map_leaves(state["err"], lambda path, e: worst.append(
                (float(e.abs().max()) / (absmax[stacked_path(path)] / 254), path)))
            ratio, path = max(worst)
            print(f"[K] int8 residuals after step {BASE_RUN['option_steps'] - 1}: the largest "
                  f"|err| is {ratio:.6f} of half a quantization step (absmax/254 of its stacked "
                  f"leaf's g + e), at {'/'.join(map(str, path))}; {len(worst)} leaves")
            if ratio > 1 + 1e-5:
                fail(f"an int8 residual exceeds half a quantization step ({ratio} at {path})")
            run["err_worst_of_half_step"] = ratio
        del state
        last.clear()
        torch.cuda.empty_cache()
        runs[option] = run
    peak = {"none (phase 9)": fused["max_memory_allocated"],
            "dots": runs["--remat dots"]["max_memory_allocated"],
            "full": runs["--remat full"]["max_memory_allocated"]}
    print(f"[K] peak memory (max_memory_allocated) by remat: "
          f"{ {k: round(v / 2**30, 2) for k, v in peak.items()} } GiB")
    if not peak["full"] < peak["none (phase 9)"]:
        fail(f"--remat full did not lower the peak memory: {peak}")
    return runs | {"peak_by_remat": peak}


def _corpus_files():
    """The byte corpus's files, sorted: the Python sources under src/ and
    tests/ and the top-level Markdown files. The same list in a git checkout
    and in an unpacked archive of one."""
    files = [*ROOT.glob("src/**/*.py"), *ROOT.glob("tests/*.py"), *ROOT.glob("*.md")]
    return sorted(str(p.relative_to(ROOT)) for p in files)


def _resume_phase(seed, dev, train_cli, build):
    """Phase E: wt103-47m-moe at full width, checkpointed every 6 of 12
    steps. Run A and run C go through uninterrupted; run B fails at step 6,
    after step 6's checkpoint committed, and resumes from it. Gate: if A and
    C end bit-equal, B must equal A bit for bit; else B's worst per-leaf
    distance from A may be at most 2x C's (the card's index_add_ scatters
    sum in atomic order). The gate must reject a resume from a checkpoint
    whose dropout generator state, or data iterator state, is left at its
    fresh value (edited into copies of B's checkpoint)."""
    import contextlib
    import io
    import shutil

    import torch
    from repro_torch.common import map_leaves

    root = build / "ckpt"
    shutil.rmtree(root, ignore_errors=True)
    common = ["--arch", RESUME["arch"], "--steps", str(RESUME["steps"]), "--batch",
              str(RESUME["batch"]), "--seq", str(RESUME["seq"]), "--ckpt-every",
              str(RESUME["every"]), "--seed", str(seed), "--device", dev.type]
    half = RESUME["every"]

    def run(name, *extra):
        """The trainer's final state (params, moments, XL memories) and its
        printed output."""
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out = train_cli.main(common + ["--ckpt-dir", str(root / name), *extra])
        state, leaves = out["state"], {}
        map_leaves({"params": state["params"], "mu": state["opt"].mu,
                    "nu": state["opt"].nu, "mems": state.get("mems", {})},
                   lambda path, t: leaves.setdefault("/".join(map(str, path)), t.detach()))
        return leaves, out, text.getvalue()

    def distance(x, y):
        """(every leaf bit-equal, worst per-leaf ||x - y|| / ||y||, its leaf)."""
        same = all(same_bits(x[k], y[k]) for k in y)
        worst = max(((torch.linalg.norm((x[k] - y[k]).float())
                      / torch.linalg.norm(y[k].float()).clamp_min(1e-30)).item(), k)
                     for k in y)
        return same, worst[0], worst[1]

    a, out_a, _ = run("a")
    print(f"[E] run A: {RESUME['steps']} steps uninterrupted, final loss "
          f"{out_a['losses'][-1]:.6f}, {len(a)} state leaves", flush=True)
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            train_cli.main(common + ["--ckpt-dir", str(root / "b"), "--fail-at-step",
                                     str(half)])
        fail("run B did not fail at its injected step")
    except RuntimeError as e:
        print(f"[E] run B failed as injected: {e}")
    committed = sorted(p.name for p in (root / "b").glob("step_*")
                       if (p / "COMMITTED").exists())
    print(f"[E] run B's committed checkpoints after the failure: {committed}")
    if committed != [f"step_{half}"]:
        fail(f"run B left {committed}, not step {half}'s checkpoint alone")
    for name, edit in (("drop_rng", "rng"), ("drop_data", "data")):
        shutil.copytree(root / "b", root / name)
        _reset_checkpoint(root / name / f"step_{half}", edit, seed, dev)
    b, out_b, printed = run("b", "--resume")
    if f"[resume] restored step {half}" not in printed:
        fail(f"the resumed run B did not print '[resume] restored step {half}'")
    print(f"[E] run B resumed: '[resume] restored step {half}', final loss "
          f"{out_b['losses'][-1]:.6f}")
    c, out_c, _ = run("c")
    print(f"[E] run C: uninterrupted again, final loss {out_c['losses'][-1]:.6f}")

    c_same, c_worst, c_leaf = distance(c, a)

    def gate(x):
        same, worst, leaf = distance(x, a)
        ok = same if c_same else worst <= 2 * c_worst
        return ok, same, worst, leaf

    print(f"[E] C against A: bit-equal {c_same}, worst per-leaf relative distance "
          f"{c_worst:.3g} at {c_leaf}")
    out = {"c_vs_a": {"bit_equal": c_same, "worst": c_worst, "leaf": c_leaf},
           "losses": {"a": out_a["losses"], "b": out_b["losses"], "c": out_c["losses"]}}
    limit = "bit-equal" if c_same else f"<= 2 x {c_worst:.3g}"
    ok, same, worst, leaf = gate(b)
    print(f"[E] B (failed at {half}, resumed) against A: bit-equal {same}, worst "
          f"{worst:.3g} at {leaf} (gate: {limit}) {'ok' if ok else 'BAD'}")
    out["b_vs_a"] = {"bit_equal": same, "worst": worst, "leaf": leaf, "ok": ok}
    if not ok:
        fail("the resumed run strays from the uninterrupted one")
    del b
    for name, what in (("drop_rng", "the dropout generator's state"),
                       ("drop_data", "the data iterator's state")):
        x, _, printed = run(name, "--resume")
        bad_ok, same, worst, leaf = gate(x)
        print(f"[E] faulty resume, {what} left fresh: bit-equal {same}, worst {worst:.3g} "
              f"at {leaf}: {'PASSED, the gate is too loose' if bad_ok else 'rejected'}")
        out[name] = {"bit_equal": same, "worst": worst, "leaf": leaf, "rejected": not bad_ok}
        if bad_ok or f"[resume] restored step {half}" not in printed:
            fail(f"the resume gate let a resume without {what} through")
        del x
    shutil.rmtree(root, ignore_errors=True)
    return out


def _reset_checkpoint(path, what, seed, dev):
    """Leave one state of a committed checkpoint at the value a fresh run
    starts from, as a resume that does not restore it would: the dropout
    generator (``rng``, seeded ``seed + 1``) or the data iterator (step 0)."""
    import numpy as np
    import torch

    meta = json.loads((path / "meta.json").read_text())
    if what == "data":
        meta["extra"]["data"]["step"] = 0
        (path / "meta.json").write_text(json.dumps(meta))
        return
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    fresh = torch.Generator(device=dev).manual_seed(seed + 1).get_state().numpy()
    key = f"arr_{meta['keys'].index('rng')}"
    if arrays[key].shape != fresh.shape or np.array_equal(arrays[key], fresh):
        fail("the checkpoint's generator state is not a moved generator's")
    arrays[key] = fresh
    np.savez(path / "arrays.npz", **arrays)


def _long_prompt_slice(seed, dev, gen, K, K7, results):
    """Phases 15-18: K7 against its plain version, serve-long, prefill logits
    with K7 against plain versions, and K7's timing. Returns K7's row of the
    kernels line."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import routing
    from repro_torch.models import LM
    from repro_torch.serving import Engine, Request

    cfg = get_config(LONG["arch"])
    cfg = cfg.with_ffn(dataclasses.replace(cfg.ffn, dispatch="sort"))
    H, KV, Dh = cfg.attention.n_heads, cfg.attention.n_kv_heads, cfg.attention.head_dim
    chunk, pool, ps = LONG["prefill_chunk"], LONG["max_len"], LONG["page_size"]
    last = (LONG["prompt"] // chunk - 1) * chunk   # 3072: the prompt's last full chunk
    tail = last + chunk                            # 3328: its last, partial chunk
    layers = cfg.n_layers

    def qkv(b, sq, sk, h, kv, d, dt):
        return [torch.randn(shape, generator=gen, device=dev).to(dt)
                for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]

    def k7_args(causal, d, off, kv_len):
        return dict(causal=causal, scale=d ** -0.5, q_offset=off,
                    kv_len=None if kv_len is None else torch.tensor(kv_len, device=dev))

    # ------------------------------------------ 15. K7 against its plain version
    cases = ([(f"oracle {i}", b, sq, sk, h, kv, d, c, 0, None)
              for i, (b, sq, sk, h, kv, d, c) in enumerate(K7_ORACLE)]
             + [(f"granite chunk at {off}", 1, chunk, pool, H, KV, Dh, True, off,
                 (min(off + chunk, LONG["prompt"]),)) for off in (0, chunk, 1280, last, tail)]
             + [("granite B 2", 2, chunk, pool, H, KV, Dh, True, 512, (300, 768)),
                ("head size 16", 1, 100, 300, 4, 2, 16, True, 64, (164,))])
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for label, b, sq, sk, h, kv, d, causal, off, kl in cases:
            q, k, v = qkv(b, sq, sk, h, kv, d, dt)
            kw = k7_args(causal, d, off, kl)
            got, want = K7.flash_attention(q, k, v, **kw), K7.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            ok, err, rel, lim = close(got, want, K7_TOL[dn], dn)
            same = same_bits(got, K7.flash_attention(q, k, v, **kw))
            print(f"[15] flash_attention {label}: B {b} Sq {sq} Sk {sk} heads {h}/{kv} "
                  f"D {d} causal {causal} q_offset {off} kv_len {kl} {dn}: max_abs_err "
                  f"{err:.3g}, normwise {rel:.3g} ({lim}), same bits twice {same} "
                  f"{'ok' if ok and same else 'BAD'}")
            if not ok:
                fail(f"flash_attention disagrees with its plain version ({label}, {dn})")
            if not same:
                fail(f"flash_attention gave other bits on a second call ({label}, {dn})")
            errs[(label, dn)] = {"max_abs_err": err, "limit": lim, "normwise": rel,
                                 "same_bits_twice": same}
    # The bf16 gate must reject a subtly wrong K7: a softmax scale 10 % off,
    # three keys read past kv_len (only the B 2 case's first row has keys
    # there that the causal mask lets through), or a split merge that drops
    # the 64 keys at the second split's first key of serve-long's chunk or
    # counts them twice, emulated through the inputs: those keys removed
    # (or repeated in place) with kv_len and q_offset moved by 64, so the
    # causal mask is unchanged.
    bk = K7.FLASH_BK[Dh]
    _, _, splits, _ = K7.flash_schedule(1, chunk, H, KV, pool, last, True, K._sm_count(dev), bk)
    n_rt = -(-chunk * (H // KV) // K7.ROW_TILE)
    ranges = K7.flash_split_ranges(
        K7.flash_item_tiles(n_rt - 1, chunk, pool, H // KV, True, last, bk), splits)
    if len(ranges) < 2:
        fail(f"serve-long's chunk takes one split ({splits}): no boundary to fault")
    bound_key = ranges[1][0] * bk

    def tile_fault(k, v, kw, twice):
        if twice:
            k, v = (torch.cat([t[:, :bound_key + 64], t[:, bound_key:]], 1)[:, :pool]
                    for t in (k, v))
        else:
            k, v = (torch.cat([t[:, :bound_key], t[:, bound_key + 64:], t[:, :64]], 1)
                    for t in (k, v))
        shift = 64 if twice else -64
        return (k.contiguous(), v.contiguous(),
                dict(kw, q_offset=kw["q_offset"] + shift, kv_len=kw["kv_len"] + shift))

    for label, fault, b, off, kl in (
            (f"granite chunk at {last}", "scale x 1.1", 1, last, (last + chunk,)),
            ("granite B 2", "kv_len + 3", 2, 512, (300, 768)),
            (f"granite chunk at {last}", f"keys {bound_key}-{bound_key + 63} dropped", 1,
             last, (last + chunk,)),
            (f"granite chunk at {last}", f"keys {bound_key}-{bound_key + 63} twice", 1,
             last, (last + chunk,))):
        q, k, v = qkv(b, chunk, pool, H, KV, Dh, torch.bfloat16)
        kw = k7_args(True, Dh, off, kl)
        kb, vb, bad = k, v, kw
        if fault.startswith("scale"):
            bad = dict(kw, scale=kw["scale"] * 1.1)
        elif fault.startswith("kv_len"):
            bad = dict(kw, kv_len=kw["kv_len"] + 3)
        else:
            kb, vb, bad = tile_fault(k, v, kw, fault.endswith("twice"))
        ok, err, rel, lim = close(K7.flash_attention(q, kb, vb, **bad),
                                  K7.flash_attention_plain(q, k, v, **kw),
                                  K7_TOL["bfloat16"], "bfloat16")
        print(f"[15] faulty K7 ({fault}) at {label} bfloat16: max_abs_err {err:.3g}, "
              f"normwise {rel:.3g} ({lim}): "
              f"{'PASSED, the gate is too loose' if ok else 'rejected'}")
        if ok:
            fail(f"the bf16 gate let a faulty K7 ({fault}) through")
        errs[(label, f"bfloat16 {fault}")] = {"max_abs_err": err, "limit": lim,
                                              "normwise": rel, "rejected": not ok}
    results["phase15"] = {f"{a} {b}": e for (a, b), e in errs.items()}

    # --------------------------------------------------------- 16. serve-long
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.serving_params(lm.init(torch.Generator(device=dev).manual_seed(seed),
                                       device=dev))
    torch.cuda.synchronize()
    print(f"[16] serve-long: {cfg.name} sort dispatch, {layers} layers, d_model "
          f"{cfg.d_model}, {lm.dtype}; init {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(seed)
    lens = [LONG["prompt"]] * LONG["requests"]
    reqs = [Request(rid=i, max_new=LONG["max_new"],
                    prompt=rng.integers(1, cfg.vocab_size, size=LONG["prompt"]).tolist())
            for i in range(LONG["requests"])]
    engine_kw = dict(max_batch=LONG["max_batch"], max_len=pool, page_size=ps,
                     burst_steps=LONG["burst_steps"], prefill_chunk=chunk, device=dev)
    with Engine(lm, params, **engine_kw) as eng:     # warm-up: lazy inits
        eng.run([Request(rid="warm", prompt=list(range(1, chunk + chunk // 2)), max_new=2)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with Engine(lm, params, **engine_kw) as eng:
        outs = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        stats = dict(eng.stats)
    peak = torch.cuda.max_memory_allocated()
    chunks = sum(-(-n // chunk) for n in lens)
    moe_calls = layers * (stats["decode_steps"] + stats["prefill_chunks"])
    want = dict.fromkeys(K.LAUNCHES, 0) | {"cvmm": 3 * moe_calls, "gather_rows": moe_calls,
                                           "flash_attention": layers * chunks}
    n_tok, n_prompt = sum(len(v) for v in outs.values()), sum(lens)
    print(f"[16] {len(lens)} prompts of {LONG['prompt']} tokens ({n_prompt} in all), "
          f"{LONG['max_new']} new tokens each: "
          f"{len(outs)} requests, {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} tok/s "
          f"generated, {(n_prompt + n_tok) / wall:.1f} tok/s prompt and generated; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"[16] engine stats {stats}; launches {launches} (expected {want})")
    if len(outs) != len(reqs) or any(len(v) != LONG["max_new"] for v in outs.values()):
        fail(f"serve-long did not complete every request: {[len(v) for v in outs.values()]}")
    if any(not 0 <= t < cfg.vocab_size for v in outs.values() for t in v):
        fail("serve-long emitted a token outside the vocabulary")
    if stats["prefill_chunks"] != chunks or launches != want:
        fail(f"serve-long did not run every call on its kernels: {launches}")
    results["serve_long"] = {
        "prompt_lens": lens, "requests": len(outs), "tokens": n_tok, "wall_s": wall,
        "tok_per_s": n_tok / wall, "prompt_and_generated_per_s": (n_prompt + n_tok) / wall,
        "max_memory_allocated": peak, "stats": stats, "launches": launches,
        "prefill_chunk": _profile_prefill_chunk(lm, params, dev, last, chunk, pool, ps, rng,
                                                K)}
    del params, eng
    torch.cuda.empty_cache()

    # ----------------------- 17. end to end: prefill logits, K7 vs plain versions
    rng = np.random.default_rng([seed, 17])    # its own prompts, whatever phase 16 drew

    def compare(tag, got, want, dn):
        """Each chunk's logits through ``close`` and ``argmax_agrees``; the
        worst max_abs_err and normwise error, and whether every chunk passed."""
        worst, worst_rel, all_ok = 0.0, 0.0, True
        for i, (g, w) in enumerate(zip(got, want)):
            ok, err, rel, lim = close(g, w, E2E_TOL[dn], dn, ulps=False)
            same, flipped, gap = argmax_agrees(g, w, E2E_TOL[dn])
            print(f"[17] {tag} chunk {i} (start {i * chunk}): logits max_abs_err {err:.3g}, "
                  f"normwise {rel:.3g} ({lim}; max|want| {w.abs().max().item():.3g}), "
                  f"argmax: {flipped} rows differ, largest gap {gap:.3g} "
                  f"{'ok' if ok and same else 'BAD'}")
            all_ok = all_ok and ok and same
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
        return worst, worst_rel, all_ok

    def gate(tag, m, p, n_tokens, dn):
        prompt = rng.integers(1, cfg.vocab_size, size=n_tokens).tolist()
        choices = []
        K.reset_launch_counts()
        with pinned_routing(routing, choices, replay=False):
            got = _paged_prefill_logits(m, p, prompt, chunk, ps, dev)
        n_k7 = K.LAUNCHES["flash_attention"]
        with plain_kernels(K), pinned_routing(routing, choices, replay=True):
            want = _paged_prefill_logits(m, p, prompt, chunk, ps, dev)
        worst, worst_rel, ok = compare(f"{tag}, K7 vs plain", got, want, dn)
        if not ok:
            fail(f"{tag}: prefill with K7 disagrees with the plain versions")
        if n_k7 != m.cfg.n_layers * len(got):
            fail(f"{tag}: {n_k7} K7 launches, expected {m.cfg.n_layers * len(got)}")
        out = {"max_abs_err": worst, "normwise": worst_rel}
        if dn == "bfloat16":      # the gate must reject K7 with its scale 10 % off
            k7 = K7.flash_attention

            def faulty(q, k, v, *, scale, **kw):
                return k7(q, k, v, scale=scale * 1.1, **kw)

            K7.flash_attention = faulty
            try:
                with pinned_routing(routing, choices, replay=True):
                    bad = _paged_prefill_logits(m, p, prompt, chunk, ps, dev)
            finally:
                K7.flash_attention = k7
            b_err, b_rel, b_ok = compare(f"{tag}, faulty K7 (scale x 1.1) vs plain",
                                         bad, want, dn)
            print(f"[17] {tag}: the faulty K7 is {'PASSED' if b_ok else 'rejected'}")
            if b_ok:
                fail(f"{tag}: the bf16 gate let a faulty K7 (scale x 1.1) through")
            out["faulty_scale_1.1"] = {"max_abs_err": b_err, "normwise": b_rel}
        return out

    lm2 = LM(cfg.override(n_layers=2))
    p2 = lm2.serving_params(lm2.init(torch.Generator(device=dev).manual_seed(seed + 1),
                                     device=dev))
    results["phase17"] = {"bf16 depth 2, 600 tokens": gate(
        "bf16 depth 2, 600 tokens", lm2, p2, 600, "bfloat16")}
    del p2
    lm32 = LM(cfg.override(dtype="float32"))
    p32 = lm32.serving_params(lm32.init(torch.Generator(device=dev).manual_seed(seed + 2),
                                        device=dev))
    results["phase17"]["float32 full depth, 1024 tokens"] = gate(
        "float32 full depth, 1024 tokens", lm32, p32, 1024, "float32")
    del p32
    torch.cuda.empty_cache()

    # ------------------- 18. K7 at serve-long's last full chunk and serve's short one
    def time_k7(sq, sk, off, kvl):
        return _time_k7(K, K7, *qkv(1, sq, sk, H, KV, Dh, torch.bfloat16), off, kvl)

    timed = {"serve-long": time_k7(chunk, pool, last, last + chunk),
             "serve": time_k7(32, 128, 64, 96)}      # serve's Engine: chunks of 32, max_len 128
    for label, t in timed.items():
        sch = t["schedule"]
        print(f"[18] flash_attention at {label}'s chunk, {t['shape']} bfloat16: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"{t['library_ms']:.4f} ms ({t['library_backend']} backend, enable_gqa "
              f"{t['library_enable_gqa']}, K/V cut to kv_len, causal_lower_right; vs K7 "
              f"max_abs_err {t['library_vs_kernel_err']:.3g}); bound {t['bound_ms']:.4f} ms "
              f"({t['bound_operations'] or 'bytes'}; bytes {t['bounds_ms']['bytes']:.4f}, "
              f"products {t['bounds_ms']['products']:.4f}, exponentials "
              f"{t['bounds_ms']['exponentials']:.4f}: {t['bytes'] / 1e6:.2f} MB, "
              f"{t['flops'] / 1e9:.3f} GFLOP, {t['exps'] / 1e6:.2f} M exp2); device time "
              f"alone (calls queued behind a sleep): kernel {t['device_ms']:.4f} ms, "
              f"scaled_dot_product_attention {t['library_device_ms']:.4f} ms; schedule BK "
              f"{sch['bk']}, {sch['items']} items x {sch['splits']} splits = {sch['grid']} "
              f"blocks")
    # ptxas on the bf16 body at this head size and key tile (dynamic shared
    # memory: csrc/flash_attention.cu's ws::Shape, Q + a ring of at most 4
    # stages + 1,024 for alignment).
    bk = K7.FLASH_BK[Dh]
    dp = max(Dh, 64)
    stages = min(4, (232448 - 1024 - 128 * dp * 2) // (4 * bk * dp))
    lines = results["build"]["flash_attention"]["ptxas"].splitlines()
    entry = f"flash_fwd_bf16ILi{Dh}ELi{bk}E"
    report = [x.split("ptxas info    : ")[-1].strip()
              for i, ln in enumerate(lines) if "Compiling entry" in ln and entry in ln
              for x in lines[i + 1:i + 4] if "Function properties" not in x]
    print(f"[18] ptxas flash_fwd_bf16<{Dh}, {bk}>: {'; '.join(report)}; dynamic shared "
          f"memory {128 * dp * 2 + stages * 4 * bk * dp + 1024} bytes ({stages} stages)")
    long_t = timed["serve-long"]
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:65",
           "launches": launches["flash_attention"],
           "max_abs_err": errs[(f"granite chunk at {last}", "bfloat16")]["max_abs_err"],
           "ms": long_t["ms"], "plain_ms": long_t["plain_ms"], "bound_ms": long_t["bound_ms"],
           "bound_by": long_t["bound_by"], "library_ms": long_t["library_ms"],
           "bound_operations": long_t["bound_operations"], "shape": long_t["shape"],
           "dtype": "bfloat16", "path": "serving, serve-long prefill",
           "device_ms": long_t["device_ms"], "library_device_ms": long_t["library_device_ms"],
           "schedule": long_t["schedule"], "ptxas": report,
           "short_chunk": {key: timed["serve"][key] for key in (
               "shape", "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
               "bound_ms", "bound_by", "max_abs_err", "schedule")}}
    results["k7_timing"] = timed
    return row


def _k7_fault(fault):
    """The defines that build K7 with planted fault ``fault`` of K7_FAULTS."""
    return (f"K7_FAULT={fault}",)


def _arch_slice(seed, dev, gen, K, K7, results):
    """Phases L-N: K7 at head size 112 and the new groupings, zamba2-7b
    served at full width and depth, the other new archs at full width.
    Returns (K7's D 112 row, the launches of each phase's main path)."""
    t0 = time.perf_counter()
    row = _phase_l(dev, gen, K, K7, results)
    print(f"[L] took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = {HYBRID["arch"]: _phase_m(seed, dev, K, K7, results)}
    print(f"[M] took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(_phase_n(seed, dev, gen, K, K7, results))
    print(f"[N] took {time.perf_counter() - t0:.1f} s", flush=True)
    return row, launches


def _phase_l(dev, gen, K, K7, results):
    """Phase L: K7 at D 112 and at the new archs' groupings against its
    plain version (phase 15's gates), the planted padding faults rejected,
    and the D 112 prefill timed beside its bound and SDPA."""
    import torch
    from repro_torch.kernels import build
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for label, b, sq, sk, h, kv, d, causal, off, kl in D112_CASES:
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
            kw = dict(causal=causal, scale=d ** -0.5, q_offset=off,
                      kv_len=None if kl is None else torch.tensor(kl, device=dev))
            got, want = K7.flash_attention(q, k, v, **kw), K7.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            ok, err, rel, lim = close(got, want, K7_TOL[dn], dn)
            same = same_bits(got, K7.flash_attention(q, k, v, **kw))
            _, _, splits, _ = K7.flash_schedule(b, sq, h, kv, sk, off, causal, K._sm_count(dev),
                                                K7.FLASH_BK[d])
            print(f"[L] flash_attention {label}: B {b} Sq {sq} Sk {sk} heads {h}/{kv} D {d} "
                  f"causal {causal} q_offset {off} kv_len {kl} {dn} ({splits} splits): "
                  f"max_abs_err {err:.3g}, normwise {rel:.3g} ({lim}), same bits twice {same} "
                  f"{'ok' if ok and same else 'BAD'}")
            if not ok or not same:
                fail(f"flash_attention disagrees with its plain version or itself ({label}, {dn})")
            if label == "zamba2 split keys" and splits < 2:
                fail(f"{label}: {splits} split, no keys split over the card")
            errs[f"{label} {dn}"] = {"max_abs_err": err, "normwise": rel, "limit": lim,
                                     "same_bits_twice": same, "splits": splits}
            if dn == "bfloat16" and label.startswith("zamba2"):
                for fault, what in K7_FAULTS.items():
                    with build.selected("flash_attention", _k7_fault(fault)):
                        bad = K7.flash_attention(q, k, v, **kw)
                    b_ok, b_err, b_rel, _ = close(bad, want, K7_TOL[dn], dn)
                    print(f"[L] faulty K7 ({what}) at {label}: max_abs_err {b_err:.3g}, "
                          f"normwise {b_rel:.3g}: "
                          f"{'PASSED, the gate is too loose' if b_ok else 'rejected'}")
                    if b_ok:
                        fail(f"the bf16 gate let a faulty K7 ({what}) through at {label}")
                    errs[f"{label} faulty {fault}"] = {"max_abs_err": b_err, "normwise": b_rel,
                                                       "rejected": not b_ok}
    results["phaseL"] = errs
    b, sq, _, h, kv, d = D112_CASES[0][1:7]
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((b, sq, h, d), (b, sq, kv, d), (b, sq, kv, d)))
    t = _time_k7(K, K7, q, k, v, 0, sq)
    print(f"[L] flash_attention at zamba2's prefill, {t['shape']} bfloat16: kernel "
          f"{t['ms']:.4f} ms ({t['device_ms']:.4f} device alone), plain {t['plain_ms']:.4f} ms, "
          f"scaled_dot_product_attention {t['library_ms']:.4f} ms "
          f"({t['library_device_ms']:.4f} device alone; {t['library_backend']} backend, vs K7 "
          f"max_abs_err {t['library_vs_kernel_err']:.3g}); bound {t['bound_ms']:.4f} ms "
          f"({t['bound_operations'] or 'bytes'}; bytes {t['bounds_ms']['bytes']:.4f}, products "
          f"{t['bounds_ms']['products']:.4f}, exponentials {t['bounds_ms']['exponentials']:.4f}); "
          f"schedule {t['schedule']}")
    lines = results["build"]["flash_attention"]["ptxas"].splitlines()
    report = [x.split("ptxas info    : ")[-1].strip()
              for i, ln in enumerate(lines)
              if "Compiling entry" in ln and "flash_fwd_bf16ILi112ELi64E" in ln
              for x in lines[i + 1:i + 4] if "Function properties" not in x]
    print(f"[L] ptxas flash_fwd_bf16<112, 64>: {'; '.join(report)}")
    t["ptxas"] = report
    results["k7_d112_timing"] = t
    return t


def _k7_per_prefill(cfg) -> int:
    """K7 launches one prefill implies: every attention layer without a
    window (shared slots included), and for an encoder-decoder model each
    encoder layer and each decoder layer's cross-attention."""
    n = sum(1 for e in cfg.layer_pattern() if e.mixer in ("attn", "shared_attn")
            and not ((e.attn_kind or cfg.attention.kind) == "local" and cfg.attention.window))
    if cfg.is_encoder_decoder:
        n += cfg.n_encoder_layers + cfg.n_layers
    return n


def _serve_contiguous(lm, params, prompts, max_new, dev, K, patches=None, frames=None,
                      plans=False):
    """The main path of phases M and N: ``LM.prefill`` of the prompts on the
    contiguous cache, then ``max_new`` greedy ``LM.decode_step``s (the MoE on
    decode plans with ``plans``), every count at 0 just before and read
    after the prefill and after the decode. Returns the time to the first
    token, the decode rate, the peak memory, the launches and the logits."""
    import torch
    b, n = prompts.shape
    p = 0 if patches is None else patches.shape[1]
    vocab = lm.cfg.vocab_size

    def run():
        cache = lm.init_cache(b, p + n + max_new, device=dev)
        t0 = time.perf_counter()
        lg, cache = lm.prefill(params, prompts, cache, patches=patches, frames=frames)
        tok = lg[:, :vocab].argmax(-1)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        after_prefill = dict(K.LAUNCHES)
        logits, toks = [lg], [tok]
        t0 = time.perf_counter()
        with _decode_plans(b) if plans else nullcontext():
            for i in range(max_new):
                lg, cache = lm.decode_step(params, cache, tok, p + n + i)
                tok = lg[:, :vocab].argmax(-1)
                logits.append(lg)
                toks.append(tok)
        torch.cuda.synchronize()
        return ttft, time.perf_counter() - t0, after_prefill, logits, toks

    with torch.no_grad():
        run()                                    # warm-up: lazy inits
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        ttft, decode_s, after_prefill, logits, toks = run()
    after = dict(K.LAUNCHES)
    return {"ttft_s": ttft, "decode_s": decode_s, "decode_tok_per_s": b * max_new / decode_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches_prefill": after_prefill,
            "launches_decode": {k: after[k] - after_prefill[k] for k in after},
            "logits": torch.stack(logits, 1), "tokens": torch.stack(toks, 1)}


def _decode_vs_forward(tag, lm, params, prompts, dev, K, new, patches=None, frames=None,
                       plans=False):
    """The float32 gate of phases M and N: the prefill's and ``new`` decode
    steps' logits against one full forward's at the same positions, within
    E2E_TOL["float32"]. Returns the max_abs_err and the serve's launches."""
    import torch
    run = _serve_contiguous(lm, params, prompts, new, dev, K, patches, frames, plans)
    p = 0 if patches is None else patches.shape[1]
    n = prompts.shape[1]
    with torch.no_grad():
        tokens = torch.cat([prompts, run["tokens"][:, :-1]], 1)
        h, _, _ = lm.forward(params, tokens, prefix_embeds=patches, frames=frames)
        want = lm._unembed(params, h[:, p + n - 1:])
    vocab = lm.cfg.vocab_size
    ok, err, rel, lim = close(run["logits"][..., :vocab], want[..., :vocab],
                              E2E_TOL["float32"], "float32")
    print(f"[{tag}] float32: prefill and {new} decode steps' logits vs one forward's at "
          f"positions {p + n - 1}-{p + n + new - 1}: max_abs_err {err:.3g}, normwise "
          f"{rel:.3g} ({lim}) {'ok' if ok else 'BAD'}")
    if not ok:
        fail(f"{tag}: decode logits disagree with the forward's")
    return err, run


def _prefill_vs_plain(tag, label, lm, params, prompts, dev, K, dn, patches=None,
                      frames=None):
    """The prefill's logits with the kernels against their plain versions
    on the same inputs and expert choices, within E2E_TOL[dn] and
    ``argmax_agrees`` (phases M and N). Returns the max_abs_err."""
    import torch
    from repro_torch.core import routing
    b, n = prompts.shape
    n += 0 if patches is None else patches.shape[1]
    choices, logits = [], []
    for plain in (False, True):
        with (plain_kernels(K) if plain else nullcontext()), torch.no_grad(), \
                pinned_routing(routing, choices, replay=plain):
            lg, _ = lm.prefill(params, prompts, lm.init_cache(b, n, device=dev),
                               patches=patches, frames=frames)
        logits.append(lg[:, :lm.cfg.vocab_size])
    got, want = logits
    ok, err, rel, lim = close(got, want, E2E_TOL[dn], dn, ulps=False)
    same, flipped, gap = argmax_agrees(got, want, E2E_TOL[dn])
    print(f"[{tag}] {label} {dn}: prefill logits with the kernels vs their plain versions: "
          f"max_abs_err {err:.3g}, normwise {rel:.3g} ({lim}); argmax: {flipped} rows differ, "
          f"largest gap {gap:.3g} {'ok' if ok and same else 'BAD'}")
    if not ok or not same:
        fail(f"{lm.cfg.name} {dn}: prefill with the kernels disagrees with the plain versions")
    return err


def _phase_m(seed, dev, K, K7, results):
    """Phase M: zamba2-7b at full width and depth, bf16, from the contiguous
    cache; then its gates at one pattern period. Returns the serve's
    launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config(HYBRID["arch"])
    b, n, new = HYBRID["batch"], HYBRID["prompt"], HYBRID["max_new"]
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(b, n)), device=dev)
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.serving_params(lm.init(torch.Generator(device=dev).manual_seed(seed),
                                       device=dev))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[M] {cfg.name}: {cfg.n_layers} slots, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
          f"params in {lm.dtype}; init {time.perf_counter() - t0:.1f} s", flush=True)
    run = _serve_contiguous(lm, params, prompts, new, dev, K)
    del params
    torch.cuda.empty_cache()
    want = _k7_per_prefill(cfg)
    k7_pre = run["launches_prefill"]["flash_attention"]
    k7_dec = run["launches_decode"]["flash_attention"]
    finite = bool(torch.isfinite(run["logits"][..., :cfg.vocab_size]).all())
    print(f"[M] {b} prompts of {n} tokens, {new} greedy tokens each: time to first token "
          f"{run['ttft_s'] * 1e3:.1f} ms, decode {run['decode_tok_per_s']:.1f} tok/s "
          f"({run['decode_s'] * 1e3 / new:.1f} ms a step of {b}); max_memory_allocated "
          f"{run['max_memory_allocated'] / 2**30:.2f} GiB; K7 launches: prefill {k7_pre} "
          f"(expected {want}), decode {k7_dec} (expected 0); finite logits {finite}")
    if k7_pre != want or k7_dec != 0 or not finite:
        fail(f"zamba2-7b's serve: K7 {k7_pre} at prefill, {k7_dec} at decode; finite {finite}")
    out = {k: v for k, v in run.items() if k not in ("logits", "tokens")}
    out["n_params"] = n_params
    # Gates at one pattern period (5 SSM slots and the shared block)
    dcfg = cfg.override(n_layers=HYBRID["depth"])
    for dn in ("bfloat16", "float32"):
        lm6 = LM(dcfg.override(dtype=dn))
        p6 = lm6.serving_params(lm6.init(torch.Generator(device=dev).manual_seed(seed + 1),
                                         device=dev))
        out[f"depth{HYBRID['depth']}_{dn}_k7_vs_plain"] = _prefill_vs_plain(
            "M", f"depth {HYBRID['depth']}", lm6, p6, prompts, dev, K, dn)
        if dn == "float32":
            err, _ = _decode_vs_forward("M", lm6, p6, prompts, dev, K, HYBRID["gate_new"])
            out["decode_vs_forward_float32"] = err
        del p6
        torch.cuda.empty_cache()
    results["phaseM"] = out
    return run["launches_prefill"] | {"decode": run["launches_decode"]}


def _phase_n(seed, dev, gen, K, K7, results):
    """Phase N: mamba2-370m served at full width and depth as phase M, the
    other new archs at full width and one pattern period in float32:
    prefill and decode on the contiguous cache against the forward, K7
    launches against the count the config implies; llama4-scout's K4 and K6
    against their plain versions at its widths. Returns the launches of
    each arch's serve."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import LM

    out, launches = {}, {}
    rng = np.random.default_rng(seed + 3)
    for arch, depth in NEW_ARCHS.items():
        cfg = get_config(arch)
        if cfg.ffn.kind == "sigma_moe":
            cfg = cfg.with_ffn(dataclasses.replace(cfg.ffn, dispatch="sort"))
        if arch == "mamba2-370m":
            b, n, new = HYBRID["batch"], HYBRID["prompt"], HYBRID["max_new"]
            prompts = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(b, n)), device=dev)
            lm = LM(cfg)
            params = lm.serving_params(lm.init(torch.Generator(device=dev).manual_seed(seed),
                                               device=dev))
            run = _serve_contiguous(lm, params, prompts, new, dev, K)
            del params
            finite = bool(torch.isfinite(run["logits"][..., :cfg.vocab_size]).all())
            used = {k: v for k, v in run["launches_prefill"].items() if v} | {
                k: v for k, v in run["launches_decode"].items() if v}
            print(f"[N] {arch} bf16 at full depth ({cfg.n_layers} SSM layers): {b} prompts of "
                  f"{n}, {new} tokens each: time to first token {run['ttft_s'] * 1e3:.1f} ms, "
                  f"decode {run['decode_tok_per_s']:.1f} tok/s; max_memory_allocated "
                  f"{run['max_memory_allocated'] / 2**30:.2f} GiB; kernel launches {used} "
                  f"(none expected); finite {finite}")
            if used or not finite:
                fail(f"{arch}: launches {used}, finite {finite}")
            entry = {k: v for k, v in run.items() if k not in ("logits", "tokens")}
            lm = LM(cfg.override(n_layers=HYBRID["depth"], dtype="float32"))
            params = lm.init(torch.Generator(device=dev).manual_seed(seed + 1), device=dev)
            entry["decode_vs_forward_float32"], _ = _decode_vs_forward(
                "N", lm, params, prompts, dev, K, HYBRID["gate_new"])
            out[arch] = entry
            launches[arch] = {}
            del params
            torch.cuda.empty_cache()
            continue
        cfg = cfg.override(dtype="float32", **({"n_layers": depth} if depth else {}))
        b = NEW_RUN["batch"]
        n = NEW_RUN["long_prompt" if cfg.attention.window and cfg.pattern else "prompt"]
        prompts = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(b, n)), device=dev)
        patches = frames = None
        if cfg.n_vision_tokens:
            patches = torch.randn((b, cfg.n_vision_tokens, cfg.d_model), generator=gen,
                                  device=dev)
        if cfg.is_encoder_decoder:
            frames = torch.randn((b, cfg.n_audio_frames, cfg.d_model), generator=gen,
                                 device=dev)
        lm = LM(cfg)
        t0 = time.perf_counter()
        params = lm.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        moe = cfg.ffn.kind == "sigma_moe"
        enc = f" + {cfg.n_encoder_layers} encoder" if cfg.is_encoder_decoder else ""
        print(f"[N] {arch}: {cfg.n_layers} layers{enc}, "
              f"d_model {cfg.d_model}, {n_params / 1e9:.3f} B params in float32; init "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        err, run = _decode_vs_forward("N", lm, params, prompts, dev, K, NEW_RUN["decode"],
                                      patches, frames, plans=moe)
        vs_plain = _prefill_vs_plain("N", arch, lm, params, prompts, dev, K, "float32",
                                     patches, frames)
        want = _k7_per_prefill(cfg)
        want_dec = NEW_RUN["decode"] * cfg.n_layers if cfg.is_encoder_decoder else 0
        pre, dec = run["launches_prefill"], run["launches_decode"]
        print(f"[N] {arch}: prefill of {b} x {n} tokens"
              f"{' after ' + str(cfg.n_vision_tokens) + ' patches' if patches is not None else ''}"
              f"{' over ' + str(cfg.n_audio_frames) + ' frames' if frames is not None else ''}: "
              f"K7 launches {pre['flash_attention']} (expected {want}), in {NEW_RUN['decode']} "
              f"decode steps {dec['flash_attention']} (expected {want_dec}); launches prefill "
              f"{ {k: v for k, v in pre.items() if v} }, "
              f"decode { {k: v for k, v in dec.items() if v} }")
        if pre["flash_attention"] != want or dec["flash_attention"] != want_dec:
            fail(f"{arch}: K7 launches {pre['flash_attention']} at prefill, "
                 f"{dec['flash_attention']} at decode")
        if moe:
            steps = NEW_RUN["decode"] * cfg.n_layers
            exp = {"gather_rows": steps, "cvmm": 3 * steps}
            if pre["fused_w1"] < cfg.n_layers or pre["fused_w2"] < cfg.n_layers or any(
                    dec[k] != v for k, v in exp.items()):
                fail(f"{arch}: MoE launches prefill {pre}, decode {dec}; expected at least "
                     f"{cfg.n_layers} K1 and K2 at prefill and {exp} at decode")
        out[arch] = {"decode_vs_forward_float32": err, "n_params": n_params,
                     "prefill_vs_plain_float32": vs_plain,
                     "launches_prefill": pre, "launches_decode": dec,
                     "ttft_s": run["ttft_s"], "decode_tok_per_s": run["decode_tok_per_s"]}
        launches[arch] = pre | {"decode": dec}
        del params, run
        torch.cuda.empty_cache()
        if moe:
            out[arch]["kernels_vs_plain"] = _llama4_kernels(dev, gen, K, ops, cfg)
    results["phaseN"] = out
    return launches


def _llama4_kernels(dev, gen, K, ops, cfg):
    """Phase N: K4 and K6 at llama4-scout's decode-plan widths (d 5,120, G
    8,192, 16 experts, top-1 of 2 tokens: M_pad 2,048) against their plain
    versions, phase 3's gates."""
    import torch
    from repro_torch.common import round_up
    f = cfg.ffn
    E, d, G = f.n_experts, cfg.d_model, f.expert_size
    plan = ops.make_decode_plan(NEW_RUN["batch"], f.k, E, device=dev)
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for k, n in ((d, G), (G, d)):          # multiples of 128, as the kernel takes them
            k, n = round_up(k, 128), round_up(n, 128)
            x = torch.randn((plan.m_pad, k), generator=gen, device=dev).to(dt)
            w = (torch.randn((E, k, n), generator=gen, device=dev) * k ** -0.5).to(dt)
            got, again = K.cvmm(x, plan.tile_expert, w), K.cvmm(x, plan.tile_expert, w)
            ok, err, rel, lim = close(got, K.cvmm_plain(x, plan.tile_expert, w), TOL[dn], dn,
                                      ulps=False)
            twice = same_bits(got, again)
            print(f"[N] cvmm llama4-scout decode plan M_pad {plan.m_pad} {k}->{n} E {E} {dn}: "
                  f"max_abs_err {err:.3g}, normwise {rel:.3g} ({lim}), same bits twice {twice} "
                  f"{'ok' if ok and twice else 'BAD'}")
            if not ok or not twice:
                fail(f"cvmm disagrees with cvmm_plain or itself at llama4-scout's {k}->{n} {dn}")
            errs[f"cvmm {k}->{n} {dn}"] = err
            del w
        x = torch.randn((NEW_RUN["batch"], d), generator=gen, device=dev).to(dt)
        for weighted in (False, True):
            wt = (torch.rand((plan.gather.u_pad,), generator=gen, device=dev)
                  if weighted else None)
            err = (K.gather_rows(x, plan.gather.row_src, wt).float()
                   - K.gather_rows_plain(x, plan.gather.row_src, wt).float()).abs().max().item()
            print(f"[N] gather_rows llama4-scout n {NEW_RUN['batch']} d {d} into "
                  f"{plan.gather.row_src.numel()} rows weighted {weighted} {dn}: max_abs_err "
                  f"{err:.3g} (exact) {'ok' if err == 0 else 'BAD'}")
            if err != 0:
                fail(f"gather_rows disagrees with its plain version at llama4-scout's d {dn}")
            errs[f"gather_rows weighted {weighted} {dn}"] = err
    torch.cuda.empty_cache()
    return errs


def _time_k7(K, K7, q, k, v, off, kvl):
    """K7 on one causal bf16 call of q (B, Sq, H, D) at ``off`` over kv_len
    ``kvl`` (every batch row) of an Sk-key pool beside its plain version,
    the library call on K/V cut to kv_len with a lower-right causal mask
    (the mask is then exactly K7's), and the bound."""
    import torch
    import torch.nn.functional as F
    from torch.backends.cuda import (SDPAParams, can_use_efficient_attention,
                                     can_use_flash_attention)
    from torch.nn.attention.bias import causal_lower_right

    b, sq, H, Dh = q.shape
    sk, KV = k.shape[1], k.shape[2]
    kw = dict(causal=True, scale=Dh ** -0.5, q_offset=off,
              kv_len=torch.full((b,), kvl, device=q.device))
    qt, kt, vt = q.transpose(1, 2), k[:, :kvl].transpose(1, 2), v[:, :kvl].transpose(1, 2)
    gqa = can_use_flash_attention(SDPAParams(qt, kt, vt, None, 0.0, False, True))
    if not gqa:               # expand the KV heads here, outside the timing
        kt, vt = (t.repeat_interleave(H // KV, dim=1) for t in (kt, vt))
    sdpa_params = SDPAParams(qt, kt, vt, None, 0.0, False, gqa)
    backend = ("flash" if can_use_flash_attention(sdpa_params) else "efficient"
               if can_use_efficient_attention(sdpa_params) else "math")
    bias = causal_lower_right(sq, kvl)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias,
                                              scale=Dh ** -0.5, enable_gqa=gqa)

    got = K7.flash_attention(q, k, v, **kw).float()
    err = (got - K7.flash_attention_plain(q, k, v, **kw).float()).abs().max().item()
    lib_err = (sdpa().transpose(1, 2).float() - got).abs().max().item()
    if lib_err > K7_TOL["bfloat16"]:
        fail("scaled_dot_product_attention does not compute K7's function here")
    pairs = b * sum(min(kvl, off + i + 1) for i in range(sq))  # visible (row, key) pairs
    flops, exps = 4 * Dh * H * pairs, H * pairs                 # Q K^T and P V; exp2
    nbytes = (2 * q.numel() + 2 * b * kvl * KV * Dh) * q.element_size() + 8 * b
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S, "products": flops / PEAK_FLOPS["bfloat16"],
              "exponentials": exps / EXP_PER_S}
    worst = max(bounds, key=bounds.get)
    _, items, splits, grid = K7.flash_schedule(b, sq, H, KV, sk, off, True,
                                               K._sm_count(q.device), K7.FLASH_BK[Dh])
    return {"shape": (f"B {b} Sq {sq} at q_offset {off}, kv_len {kvl} of {sk} keys, heads "
                      f"{H}/{KV}, D {Dh}"),
            "ms": _time_ms(lambda: K7.flash_attention(q, k, v, **kw)),
            "plain_ms": _time_ms(lambda: K7.flash_attention_plain(q, k, v, **kw)),
            "library_ms": _time_ms(sdpa),
            "device_ms": _device_ms(lambda: K7.flash_attention(q, k, v, **kw)),
            "library_device_ms": _device_ms(sdpa),
            "bound_ms": 1e3 * bounds[worst],
            "bound_by": "bytes" if worst == "bytes" else "operations",
            "bound_operations": None if worst == "bytes" else worst,
            "bounds_ms": {n: 1e3 * x for n, x in bounds.items()},
            "max_abs_err": err, "library_vs_kernel_err": lib_err, "bytes": nbytes,
            "flops": flops, "exps": exps, "library_backend": backend,
            "library_enable_gqa": gqa,
            "schedule": {"bk": K7.FLASH_BK[Dh], "items": items, "splits": splits,
                         "grid": grid}}


@contextmanager
def _decode_plans(max_tokens: int):
    """Install a decode-plan provider, as the Engine does, for direct calls."""
    from repro_torch.core import dispatch
    from repro_torch.serving import DecodePlanCache, make_provider
    dispatch.set_decode_provider(make_provider(DecodePlanCache(), max_tokens=max_tokens))
    try:
        yield
    finally:
        dispatch.set_decode_provider(None)


def _profile_prefill_chunk(lm, params, dev, start, chunk, pool, ps, rng, K):
    """One full-width paged prefill chunk of ``chunk`` random tokens at
    ``start`` (mean of 3, host clock around synchronized calls), then one
    under torch.profiler (``_profile``), which must show one K7 device
    kernel per K7 wrapper call."""
    import torch

    n_pages = pool // ps
    cache = lm.init_paged_cache(1 + n_pages, ps, device=dev)
    table = torch.arange(1, 1 + n_pages, dtype=torch.int32, device=dev)[None]
    tokens = torch.as_tensor(rng.integers(1, lm.cfg.vocab_size, size=(1, chunk)), device=dev)

    def run():
        with torch.no_grad():
            lm.prefill_paged(params, tokens, cache, table, start, chunk)
        torch.cuda.synchronize()

    with _decode_plans(chunk):
        chunk_ms = _mean_ms(run, 3)
        print(f"[16] prefill chunk of {chunk} at {start}: {chunk_ms:.2f} ms (mean of 3)")
        calls = K.LAUNCHES["flash_attention"]
        prof = _profile("16", "prefill chunk", run)
        calls = K.LAUNCHES["flash_attention"] - calls
    kernels = prof["port_kernels"].get("K7 flash_attention", (0, 0.0))[0]
    print(f"[16] K7 in the profiled chunk: {calls} wrapper calls, {kernels} device kernels")
    if kernels != calls or calls != lm.cfg.n_layers:
        fail(f"profiled prefill chunk: {calls} K7 calls, {kernels} K7 device kernels, "
             f"{lm.cfg.n_layers} layers")
    return {"start": start, "chunk_ms": chunk_ms} | prof


def _train_main_path(tag, argv, want, K, train_cli, label="", eval_batches=0,
                     keep_state=False):
    """Run the trainer in process with every launch count at 0 just before;
    the loss must be finite and fall, and every step must launch exactly
    ``want``. Returns the run's numbers (with ``eval_batches``, the eval
    step's losses and cross-entropies on that many held-out batches; with
    ``keep_state``, the final train state under "state")."""
    import numpy as np
    import torch

    print(f"[{tag}] {label}python -m repro_torch.launch.train {' '.join(argv)}",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = train_cli.main(argv, eval_batches=eval_batches)
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
            "n_params": out["n_params"], "first5": first, "last5": last,
            "eval_losses": out.get("eval_losses"), "eval_ce": out.get("eval_ce"),
            "moe_dropped_per_step": out.get("moe_dropped"),
            "collectives_per_step": out.get("collectives"),
            **({"state": out["state"]} if keep_state else {})}


def _print_run(tag, run):
    print(f"[{tag}] step {run['step_ms']:.2f} ms (mean of steps 5-{len(run['step_s']) - 1}, "
          f"min {run['step_ms_min']:.2f}, max {run['step_ms_max']:.2f}); "
          f"{run['tokens_per_s']:.0f} tokens/s; max_memory_allocated "
          f"{run['max_memory_allocated'] / 2**30:.2f} GiB")


def _three_steps_fn(batches, opt, seed, dev, batch=TRAIN["batch"], mesh=None):
    """``three_steps(lm)``: the gradients of the first batch, then 3 train
    steps from the same initial state (XL memories for ``batch`` rows);
    returns (grads by leaf path, losses). With ``mesh``, all of it on the
    mesh (a one-rank mesh: the whole batch)."""
    import torch
    from repro_torch.common import map_leaves
    from repro_torch.runtime import init_train_state, make_train_step
    from repro_torch.sharding import mesh_context

    def three_steps(lm):
        state = init_train_state(lm, torch.Generator(device=dev).manual_seed(seed), opt,
                                 use_mems=True, batch=batch, device=dev, mesh=mesh)
        with mesh_context(mesh) if mesh is not None else nullcontext():
            loss, _ = lm.loss(state["params"], batches[0], train=True,
                              gen=torch.Generator(device=dev).manual_seed(seed + 1),
                              mems=state["mems"])
            loss.backward()
        grads = {}
        map_leaves(state["params"], lambda path, p: grads.setdefault(path, p.grad.clone()))
        step = make_train_step(lm, opt, mesh=mesh)
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


def _kernels_and_plain(rung, lm, three_steps, K, ops, routing, fault=None):
    """``three_steps(lm)`` on ``rung``'s kernels (with ``fault`` planted,
    see ``planted_fault``), then on the plain versions replaying the
    kernels' expert choices: (choices, kernels' (grads, losses), plain
    versions' (grads, losses), the kernels' launches)."""
    choices = []
    K.reset_launch_counts()
    with pinned_impl(ops, rung), pinned_routing(routing, choices, replay=False), \
            planted_fault(K, fault):
        kernels = three_steps(lm)
    launches = dict(K.LAUNCHES)
    with pinned_impl(ops, rung), plain_kernels(K), \
            pinned_routing(routing, choices, replay=True):
        plain = three_steps(lm)
    return choices, kernels, plain, launches


def _against_f32(rung, variant, choices, gk, gp, three_steps, K, ops, routing):
    """(kernels', bf16 plain versions') distance from float32 plain versions
    on the same expert choices, and the float32 losses."""
    from repro_torch.models import build_model
    with pinned_impl(ops, rung), plain_kernels(K), \
            pinned_routing(routing, choices, replay=True):
        gf, lf = three_steps(build_model(variant.override(dtype="float32")))
    return _compare(gk, gf), _compare(gp, gf), lf


def _depth2_verdict(tag, label, rung, variant, lm, choices, gk, gp, worst, loss_err,
                    three_steps, K, ops, routing):
    """Phase B's rule for a bf16 step at depth 2: every leaf and loss within
    GRAD_TOL of the plain versions (the fixed gate), else, where the losses
    pass but the worst leaf does not, the yardstick: the kernels' gradients
    no further from float32 plain versions than YARDSTICK times the bf16
    plain versions' (cuBLAS), worst leaf and median alike. At
    wt103-262m-moe the fixed gate's worst leaf, layer 0's XL ``w_r``, sits
    at the edge of bf16's noise: its bf16 gradient is about 4x GRAD_TOL
    from float32 for the plain versions and the kernels alike. The
    yardstick is read in every call, so that planted faults show that it
    alone rejects them. Returns (passed, record)."""
    tol = GRAD_TOL[variant.dtype]
    with pinned_impl(ops, rung), plain_kernels(K), \
            pinned_routing(routing, choices, replay=True):
        again = _compare(three_steps(lm)[0], gp)
    kern, lib, lf = _against_f32(rung, variant, choices, gk, gp, three_steps, K, ops,
                                 routing)
    fixed = worst <= tol and loss_err <= tol
    yard = kern[0] <= YARDSTICK * lib[0] and kern[2] <= YARDSTICK * lib[2]
    passed = fixed or (loss_err <= tol and yard)
    print(f"[{tag}] {label}: the plain versions' step run again against the first: "
          f"worst relative error {again[0]:.3g} at {again[1]} (the comparison's own "
          f"run-to-run noise); against float32 plain versions: kernels worst "
          f"{kern[0]:.3g} at {kern[1]}, median {kern[2]:.3g}; bf16 plain versions (cuBLAS) "
          f"worst {lib[0]:.3g} at {lib[1]}, median {lib[2]:.3g}; fixed gate "
          f"{'ok' if fixed else 'missed'}, yardstick ({YARDSTICK}x the latter's worst and "
          f"median) {'ok' if yard else 'missed'}: {'passed' if passed else 'NOT PASSED'}")
    return passed, {"plain_twice": again, "kernels_vs_f32": kern, "plain_bf16_vs_f32": lib,
                    "losses_f32": lf, "fixed_gate": fixed, "yardstick": yard,
                    "passed": passed}


def _depth2_gate(tag, variant, rung, three_steps, K, ops, routing, fault=None):
    """``_depth2_verdict`` on a fresh model of ``variant``, with ``fault``
    planted in the kernels' run. Returns (passed, record)."""
    import numpy as np
    from repro_torch.models import build_model

    lm = build_model(variant)
    choices, (gk, lk), (gp, lp), _ = _kernels_and_plain(rung, lm, three_steps, K, ops,
                                                        routing, fault)
    worst, leaf, median = _compare(gk, gp)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    if not all(np.isfinite(lk)):
        loss_err = float("inf")
    label = f"{variant.dtype}, depth {variant.n_layers}"
    print(f"[{tag}] {rung}, {label}: worst relative error {worst:.3g} at {leaf}, median "
          f"{median:.3g}; losses kernels {lk} plain {lp}, worst relative {loss_err:.3g} "
          f"(tol {GRAD_TOL[variant.dtype]})")
    passed, record = _depth2_verdict(tag, label, rung, variant, lm, choices, gk, gp, worst,
                                     loss_err, three_steps, K, ops, routing)
    record.update(worst_grad_rel=worst, worst_leaf=leaf, median=median,
                  losses_kernels=lk, losses_plain=lp)
    return passed, record


def _step_gates(tag, cfg, rung, three_steps, K, ops, routing, cross_rung=None,
                depth2_yardstick=False):
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
    sets for one function. With ``depth2_yardstick`` (phase B), the bf16
    depth-2 step is held to ``_depth2_verdict``'s rule instead."""
    import numpy as np
    import torch
    from repro_torch.models import build_model

    E = cfg.ffn.n_experts
    out = {}
    for variant, mode in ((cfg.override(n_layers=2),
                           "fixed, else yardstick" if depth2_yardstick else "fixed"),
                          (cfg.override(dtype="float32"), "fixed"), (cfg, "yardstick")):
        label = f"{variant.dtype}, depth {variant.n_layers}"
        lm = build_model(variant)
        choices, (gk, lk), (gp, lp), step_launches = _kernels_and_plain(
            rung, lm, three_steps, K, ops, routing)
        worst, leaf, median = _compare(gk, gp)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
        tol = GRAD_TOL[variant.dtype]
        print(f"[{tag}] {rung}, {label}, full width, {len(gp)} gradient leaves, same "
              f"expert choices: worst relative error {worst:.3g} at {leaf}, median "
              f"{median:.3g}; losses kernels {lk} plain {lp}, worst relative "
              f"{loss_err:.3g} ({f'tol {tol}' if mode != 'yardstick' else 'not a check'}); "
              f"launches {step_launches}")
        out[label] = {"worst_grad_rel": worst, "worst_leaf": leaf, "median": median,
                      "losses_kernels": lk, "losses_plain": lp,
                      "launches": step_launches}
        if not all(np.isfinite(lk)):
            fail(f"non-finite loss {lk}")
        if mode == "fixed, else yardstick":
            ok, record = _depth2_verdict(tag, label, rung, variant, lm, choices, gk, gp,
                                         worst, loss_err, three_steps, K, ops, routing)
            out[label].update(record)
            if not ok:
                fail(f"{rung}, {label}: the kernels' training step disagrees with the "
                     "plain versions' under the fixed gate and the yardstick alike")
        elif mode != "yardstick" and not (worst <= tol and loss_err <= tol):
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
            kern, lib, lf = _against_f32(rung, variant, choices, gk, gp, three_steps,
                                         K, ops, routing)
            print(f"[{tag}] {label}, same expert choices, against float32 plain "
                  f"versions: kernels worst {kern[0]:.3g} at {kern[1]}, median "
                  f"{kern[2]:.3g}; bf16 plain versions (cuBLAS) worst {lib[0]:.3g} at "
                  f"{lib[1]}, median {lib[2]:.3g}; limit {YARDSTICK}x the latter's "
                  f"worst and median; float32 losses {lf}")
            out[label].update(kernels_vs_f32=kern, plain_bf16_vs_f32=lib, losses_f32=lf)
            if not (kern[0] <= YARDSTICK * lib[0] and kern[2] <= YARDSTICK * lib[2]):
                fail(f"{label}: the kernels' gradients stray further from float32 than "
                     f"{YARDSTICK}x the bf16 plain versions'")
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


def _profile_train_step(tag, lm, state, batch, step, dev, K, ops):
    """One full-width training step under torch.profiler (``_profile``).
    Fails unless the profile holds exactly one device kernel of K1, K2, K3,
    K4, K5 and K6 per call of its wrapper in the step (which also shows that
    the profile names K2 and K4, one template's instances, apart). Returns
    the profile and the plan of the step's first MoE call (layer 0), None
    for a model without one."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = step(state, batch, gen)             # warm
    torch.cuda.synchronize()
    plans = []

    def run():
        nonlocal state
        with recorded_plans(ops, plans):
            state, m = step(state, batch, gen)
        float(m["loss"])
        torch.cuda.synchronize()

    K.reset_launch_counts()
    prof = _profile(tag, "training step", run, top_n=10)
    for kernel, label in (("fused_w1", "K1 fused_w1"), ("fused_w2", "K2 fused_w2"),
                          ("dw_streamed", "K3 dw_streamed"), ("cvmm", "K4 cvmm"),
                          ("cvmm_dw", "K5 cvmm_dw"), ("gather_rows", "K6 gather_rows")):
        calls, kernels = K.LAUNCHES[kernel], prof["port_kernels"].get(label, (0, 0.0))[0]
        print(f"[{tag}] {label}: {calls} wrapper calls, {kernels} device kernels in the "
              "profiled step")
        if kernels != calls:
            fail(f"{label} ran {kernels} device kernels for {calls} wrapper calls")
    prof["wrapper_calls"] = dict(K.LAUNCHES)
    return prof, (plans[0] if plans else None)


@contextmanager
def recorded_plans(ops, plans: list):
    """Append every plan ``ops.make_moe_plan`` builds meanwhile to ``plans``."""
    make = ops.make_moe_plan

    def record(*args, **kwargs):
        plans.append(make(*args, **kwargs))
        return plans[-1]

    ops.make_moe_plan = record
    try:
        yield plans
    finally:
        ops.make_moe_plan = make


def _profile(tag, label, run, top_n: int = 8):
    """``run()`` (one synchronized call) once under torch.profiler: wall
    time, device busy share, the kernels that take the time and this port's
    kernels among them. Fails when the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
    print(f"[{tag}] profiled {label}: {wall_ms:.2f} ms wall, device busy "
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
        print(f"[{tag}]   {name}: {n} launches, {ms:.3f} ms in the {label}, "
              f"{ms / n:.4f} ms each")
    if busy_ms <= 0:
        fail(f"the profiler saw no device time in the {label}")
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms, "kernel_launches": n_launch,
            "top": [(e.key, e.count, e.self_device_time_total / 1e3) for e in top],
            "port_kernels": ours}


def _port_kernel(symbol):
    """Which of this port's bf16 kernels a profiled CUDA symbol is, or None.
    K1, K2 and K4 are instances of row_gemm_wgmma<BN, GATHER, GLU, SAVE,
    GATE> (csrc/row_gemm.cuh): K2 has the gate, K1 gathers, K4 does neither.
    K3 and K5 are instances of dw_bf16<OPERANDS, GATE> (csrc/dw_gemm.cuh):
    K5 gathers neither operand (OPERANDS 0). K6 is gather_rows_kernel, K7
    flash_fwd_bf16<D, BK>."""
    if "gather_rows_kernel" in symbol:
        return "K6 gather_rows"
    if "flash_fwd_bf16<" in symbol:
        return "K7 flash_attention"
    if "dw_bf16<" in symbol:
        operands = symbol.split("dw_bf16<", 1)[1].split(",", 1)[0].strip()
        return "K5 cvmm_dw" if operands.endswith("0") else "K3 dw_streamed"
    if "row_gemm_wgmma<" in symbol:
        args = [a.strip() for a in symbol.split("row_gemm_wgmma<", 1)[1].split(">", 1)[0]
                .split(",")]
        if args[4] == "true":
            return "K2 fused_w2"
        return "K1 fused_w1" if args[1] == "true" else "K4 cvmm"
    return None


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
         routed_g + w_bf16 + routed_d + gates + te.numel() * 4,
         ("fused_w2, all experts", "bfloat16")),
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
               "ms": _time_ms(fn), "device_ms": _device_ms(fn), "plain_ms": _time_ms(plain),
               "library_ms": _time_ms(lib), "library_device_ms": _device_ms(lib),
               "bound_ms": 1e3 * max(bb, bf), "bound_by": "bytes" if bb >= bf else "operations",
               "bound_bytes": nbytes, "bound_flops": flops, "max_abs_err": errs[err_key]}
        out.append(row)
        print(f"[{tag}] {case} bf16: kernel {row['ms']:.4f} ms ({row['device_ms']:.4f} device "
              f"alone), plain {row['plain_ms']:.4f} ms, library (torch.bmm) "
              f"{row['library_ms']:.4f} ms ({row['library_device_ms']:.4f} device alone), "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.2f} GFLOP)")
    return out


def _time_dw_on_plans(tag, rung, K, plans, t, n, E):
    """The rung's dW kernels (K3's three variants on "pallas_fused", K5's
    dW1 and dW2 on "pallas") on each plan of ``plans`` (name -> plan of the
    same M_pad), bf16, by back-to-back events and device alone, with each
    plan's rows per expert: the split's balance under the router's skew,
    and (K3) the gate pass's cost beside the gather's."""
    out = {}
    for name, plan in plans.items():
        rs, te = plan.row_src, plan.tile_expert
        rows = plan.group_sizes.float()
        print(f"[{tag}] plan '{name}': rows per expert {plan.group_sizes.tolist()}, the "
              f"busiest {rows.max() / rows.mean():.2f}x the mean")
        if rung == "pallas_fused":
            cases = {"K3 stream_x (dW1)": lambda: K.dw_streamed(t["x"], t["dh"], rs, te, E,
                                                                stream_x=True),
                     "K3 stream_g, no gate (dW2)": lambda: K.dw_streamed(
                         t["u"], t["dy"], rs, te, E, stream_x=False),
                     "K3 stream_g gated (dW2)": lambda: K.dw_streamed(
                         t["u"], t["dy"], rs, te, E, stream_x=False,
                         gate=plan.gate_tiles.detach().reshape(-1))}
        else:
            valid = (rs < n)[:, None]
            xg, dyg = K.gather_rows_plain(t["x"], rs), K.gather_rows_plain(t["dy"], rs)
            dha, ua = t["dh"] * valid, t["u"] * valid
            cases = {"K5 dW1": lambda: K.cvmm_dw(xg, te, dha, E),
                     "K5 dW2": lambda: K.cvmm_dw(ua, te, dyg, E)}
        out[name] = {"rows_per_expert": plan.group_sizes.tolist()}
        for case, fn in cases.items():
            ms, dev_ms = _time_ms(fn), _device_ms(fn)
            out[name][case] = {"ms": ms, "device_ms": dev_ms}
            print(f"[{tag}]   {case} on '{name}': {ms:.4f} ms, {dev_ms:.4f} ms device alone")
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


KERNELS = ("cvmm", "gather_rows", "fused_w1", "fused_w2", "dw_streamed", "cvmm_dw",
           "flash_attention")


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
def planted_fault(K, fault):
    """Replace, for the block, one kernel wrapper by the kernel run on inputs
    that make it compute a known fault's output (phases 3 and 7 hold the
    kernels' own gates against the same faults): "K2 gate rows exchanged"
    applies row r + 8's gate to row r and r's to r + 8 in every 16-row
    group; "K4 stage dropped" leaves out the middle 64-deep stage of K;
    "K6 row read from its neighbour" copies row 6's source into row 5 of
    every 128-row block. ``None`` plants nothing."""
    if fault is None:
        yield
        return
    name = {"K2 gate rows exchanged": "fused_w2", "K4 stage dropped": "cvmm",
            "K6 row read from its neighbour": "gather_rows"}[fault]
    real = getattr(K, name)

    def swapped_gates(u, tile_expert, w, gate, **schedule):
        return real(u, tile_expert, w, gate.reshape(-1, 2, 8).flip(1).reshape(-1),
                    **schedule)

    def dropped_stage(x, tile_expert, w, **schedule):
        lo = x.shape[1] // 128 * 64
        x = x.clone()
        x[:, lo:lo + 64] = 0
        return real(x, tile_expert, w, **schedule)

    def neighbour_row(x, row_src, weight=None, **schedule):
        rs = row_src.clone()
        rs[5::128] = row_src[6::128]
        return real(x, rs, weight, **schedule)

    setattr(K, name, {"fused_w2": swapped_gates, "cvmm": dropped_stage,
                      "gather_rows": neighbour_row}[name])
    try:
        yield
    finally:
        setattr(K, name, real)


@contextmanager
def deterministic_algorithms(tag):
    """PyTorch's deterministic algorithms (``index_add_`` and the other
    scatters in a fixed order) for the block; prints which operations warned
    that they have none and stayed as they are."""
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split(" does not have")[0] for w in seen
                  if "deterministic" in str(w.message)})
    print(f"[{tag}] under deterministic algorithms; without one: {ops or 'none'}")


@contextmanager
def pinned_impl(ops, impl: str):
    """Pin the sort path's rung (``ops.set_default_impl``), unpinned after."""
    ops.set_default_impl(impl)
    try:
        yield
    finally:
        ops.set_default_impl(None)


def kernel_module(K, name: str):
    """The module that holds kernel ``name``'s wrapper: K7's own, else ``K``
    (``kernels/cvmm.py``)."""
    from repro_torch.kernels import flash_attention
    return flash_attention if name == "flash_attention" else K


@contextmanager
def plain_kernels(K):
    """Route every kernel wrapper to its plain version, for comparison."""
    mods = {name: kernel_module(K, name) for name in KERNELS}
    saved = {name: getattr(mods[name], name) for name in KERNELS}
    for name in KERNELS:
        setattr(mods[name], name, getattr(mods[name], name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(mods[name], name, fn)


def _profile_decode_step(lm, params, dev, batch: int = 8, pos: int = 64):
    """Latency of one full-width paged decode step at ``batch`` lanes (mean
    of 5, host clock around synchronized steps), then one step under
    torch.profiler (``_profile``)."""
    import torch

    cache = lm.init_paged_cache(1 + batch * 8, 16, device=dev)
    tables = torch.arange(1, 1 + batch * 8, dtype=torch.int32, device=dev).reshape(batch, 8)
    tok = torch.ones(batch, dtype=torch.int64, device=dev)
    positions = torch.full((batch,), pos, device=dev)

    def step():
        lm.decode_step_paged(params, cache, tok, positions, tables)
        torch.cuda.synchronize()

    with _decode_plans(batch):
        step_ms = _mean_ms(step, 5)
        print(f"[4] decode step, {batch} lanes at position {pos}: {step_ms:.2f} ms "
              f"(mean of 5)")
        return {"batch": batch, "step_ms": step_ms} | _profile("4", "decode step", step)


def _mean_ms(run, n: int) -> float:
    """Host time of ``run()`` (synchronized) in ms, mean of ``n`` after one
    warm-up call."""
    run()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    return (time.perf_counter() - t0) / n * 1e3


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


def _device_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()`` without the host's share: the device
    first sleeps while the host queues all ``iters`` calls, so CUDA events
    around them time the device alone (``_time_ms`` counts the host's gaps
    between launches when the host is the slower side). Fails if queuing
    outlasted the sleep."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    slept.record()
    torch.cuda._sleep(100_000_000)              # about 50 ms at the H100's clocks
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= slept.elapsed_time(start):
        fail(f"queuing {iters} calls took {host_ms:.1f} ms, longer than the device's sleep")
    return start.elapsed_time(end) / iters


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
