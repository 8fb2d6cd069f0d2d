// K7 · forward-only grouped-query attention with an online softmax:
//
//     out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / grp]) v[b, j, h / grp]
//
// over the keys j < min(Sk, kv_len[b]) and, when causal, j <= q_offset + i
// (grp = H / KV, the reference's _gqa_expand grouping). A row with no
// visible key is zero, as in the chunked flash_attention it replaces.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_kernel), with two masks added: q_offset, the
// absolute position of q[0] (a prefill chunk's start), and kv_len, the
// valid keys of each batch row, read on the device so the host never syncs.
//
// Layout: q (B, Sq, H, D), k and v (B, Sk, KV, D), out (B, Sq, H, D), all
// row-major and contiguous; H % KV == 0; kv_len (B,) int64 or null (= Sk);
// D in {16, 64, 112, 128}.
//
// What bounds it on an H100: at the Engine's long-prompt prefill chunk
// (granite-moe, 256 rows at q_offset 3,072 over 3,328 valid keys, 24 query
// heads on 8 KV heads of 64, bf16) the function needs 5.0 GFLOP of tensor
// products (0.0051 ms at 989 TFLOP/s), 19.7 M exponentials (0.0051 ms at
// the special-function units' 16 a clock an SM, ~3.9 T/s) and 8.4 MB
// (0.0025 ms at 3.35 TB/s): bound by operations, by the products and the
// exponentials about equally, so a fast kernel overlaps one with the other.
//
// bf16 design (flash_fwd_bf16), FlashAttention-3's layout on Hopper:
// - Packed GQA. A block owns (batch row, KV head, 128-row tile of the
//   flattened (position, head-in-group) rows): row r is position r / grp
//   of query head kv * grp + r % grp, so each K/V tile is read once for
//   all grp query heads, not once per head. Each row's causal limit is its
//   own position.
// - Split-KV. The item's host-known key range [0, min(Sk, q_offset + last
//   position + 1)) is cut into `splits` contiguous, balanced runs of whole
//   BK-key tiles, at least MIN_TILES each (fewer splits for a shorter
//   item); kernels/flash_attention.py's flash_schedule picks `splits` so
//   that items x splits fill about one wave of the card, one block an SM.
//   kv_len stays on the device: a split whose range starts at or past it
//   runs no tile and leaves an empty partial (m = -inf, l = 0, O = 0).
// - Warp specialisation. One producer thread keeps a ring of STAGES
//   (K, V) tiles full by 4-D TMA ((D, KV, Sk, B) maps, boxes of 64
//   columns x BK keys, 128-byte swizzled; keys past Sk, and D 16's padding
//   to 64 columns, are the box's zero fill, never read) under full/empty
//   mbarriers; it gives its registers to the consumers (setmaxnreg).
// - Two consumer warpgroups of 64 rows each load their Q rows once
//   (16-byte loads, swizzled by hand: the packed rows are strided runs TMA
//   cannot gather into one box for every grp) and run wgmma for both
//   products: S = Q K^T (both K-major in shared memory, m64nBKk16) and
//   O += P V with P from registers (the accumulator layout of S, rounded to
//   bf16 pairs, is the register-A layout) and V MN-major. m, l and O stay in
//   float32 registers and are rounded to bf16 once at the end.
// - Overlap. Each warpgroup issues tile j's Q K^T together with tile
//   j - 1's P V, then runs tile j's softmax while they run; the two
//   warpgroups take turns to issue on named barriers (ping-pong), so one's
//   exponentials run beside the other's products. The softmax costs a max,
//   an FMA, an ex2.approx and an add a score (the scale folded into the
//   FMA, the mask only on tiles that cross a row's limit), since issuing
//   it, not the products, set the tile's time (PERF.md).
// - Prologue and epilogue. Before the block's one barrier the producer
//   thread starts its first pass of the ring and the consumers their Q
//   loads; the output rows go through the warpgroup's Q area to 16-byte
//   stores of whole rows.
// - The merge, deterministic and in the same launch (dw_gemm.cuh's
//   pattern). With one split an item's block writes bf16 out directly.
//   Otherwise each split writes its float32 O, m and l to `scratch` and
//   adds one to its item's int32 counter; the block that arrives last
//   resets the counter to 0, reads every partial back (its own too) and
//   merges them in split order: M = max m_k, w_k = 2^(m_k - M), out =
//   sum w_k O_k / max(sum w_k l_k, 1e-20). No float atomics, so every call
//   gives the same bits; all-empty partials merge to zeros, never NaN.
// - Head sizes: D 64 and 128 as they are; D 16 (reduced configs only) and
//   D 112 (zamba2) in the same body, zero-padded to whole 64-column atoms in
//   shared memory (DP = 64 and 128): the Q loads zero the pad and the K/V
//   boxes zero-fill it, Q K^T takes D / 16 steps (one and seven), P V
//   computes DP - D zero columns that are never written (NV = D / 2
//   accumulators a thread, in the output and in a split's partial), and the
//   output rows are staged at the padded pitch, so that the swizzle of the
//   16-byte chunks stays inside each row.
// float32 (flash_fwd_f32), a correctness path the main path never takes:
// one block per (32-row query tile, query head, batch row) on plain FMAs
// (no TF32), so it keeps full float32 accuracy.
//
// Keys at or past kv_len[b] but inside the pool are read with the last
// tile and masked in the scores: like the plain version, a non-finite
// value there in V would still reach the output (0 x inf); the pools
// callers pass hold finite values.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

// Planted faults, for the card's gates only (never in the built library):
// 1 stages the output rows at D's pitch, so the swizzle of D 112's chunks
// runs past a row; 2 loads Q's pad columns from the next head and reads
// them in an eighth Q K^T step against K pad columns of 1.0 in odd keys (a
// pad the same in every key would shift a row's scores alike, which the
// softmax cannot see).
#ifndef K7_FAULT
#define K7_FAULT 0
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;  // the float32 body's block
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }
// 2^x in one special-function instruction (ex2.approx.ftz: about 2 ulp;
// results below 2^-126 flush to zero, weights of nothing next to the row's
// max 2^0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Visible key count of block rows [q0, q_end): keys below min(Sk, kv_len[b])
// and, when causal, at or below position q_offset + q_end - 1.
__device__ __forceinline__ int valid_keys(int sk, const long long* kv_len, int b) {
  long long n = sk;
  if (kv_len) n = kv_len[b] < n ? kv_len[b] : n;
  return n < 0 ? 0 : static_cast<int>(n);
}
__device__ __forceinline__ int needed_keys(int kvl, int causal, int q_offset, int q_end) {
  if (!causal) return kvl;
  const long long lim = static_cast<long long>(q_offset) + q_end;
  return lim < 0 ? 0 : (lim < kvl ? static_cast<int>(lim) : kvl);
}

// ---------------------------------------------------------------- bf16 path
namespace ws {
constexpr int ROWS = 128;                // packed rows an item: two warpgroups of 64
constexpr int CONSUMERS = 256;
constexpr int BLOCK = CONSUMERS + 128;   // and the producer warpgroup
constexpr int MIN_TILES = 4;             // key tiles a split at least (flash_schedule's)
constexpr int BUDGET = 232448 - 1024;    // dynamic shared memory (static, alignment)
// Named barriers: kSched + w, warpgroup w's turn to issue; kConsumers, both
// consumer warpgroups; kQ + w, warpgroup w's Q rows stored.
enum Bar { kSched = 1, kConsumers = 3, kQ = 4 };

template <int D, int BK>
struct Shape {
  static_assert(D == 16 || D == 64 || D == 112 || D == 128, "head sizes 16, 64, 112 and 128");
  static_assert(BK == 64 || BK == 128, "key tiles of 64 or 128");
  static constexpr int DP = (D + 63) / 64 * 64;  // a row's columns in shared memory
  // 16-deep steps of Q K^T (planted fault 2 also reads the pad)
  static constexpr int KSTEPS = K7_FAULT == 2 ? DP / 16 : D / 16;
  static constexpr int NO = DP / 2;            // O accumulators a thread holds
  static constexpr int NV = D / 2;             // of which it writes (D 16, 112: the rest pad)
  static constexpr int Q_BYTES = ROWS * DP * 2;          // [warpgroup][atom][64 rows][128 B]
  static constexpr int KV_BYTES = BK * DP * 2;           // K or V of a stage: [atom][BK][128 B]
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int FIT = (BUDGET - Q_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE + 1024;  // + aligning to 1,024
  static constexpr int SLOT = (NV + 4) * CONSUMERS;  // floats of one split's partial
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

// An item's key tiles known on the host (kernels/flash_attention.py's
// flash_item_tiles): the causal limit of its last row, or Sk.
__device__ __forceinline__ int item_tiles(int r0, int sq, int sk, int grp, int causal,
                                          int q_offset, int bk) {
  const int last = min(sq - 1, (r0 + ROWS - 1) / grp);
  long long keys = sk;
  if (causal) keys = min(keys, static_cast<long long>(q_offset) + last + 1);
  return keys <= 0 ? 0 : static_cast<int>((keys + bk - 1) / bk);
}
}  // namespace ws

template <int D, int BK>
__global__ void __launch_bounds__(ws::BLOCK, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
               const bf16* __restrict__ q, const long long* __restrict__ kv_len,
               bf16* __restrict__ out, float* __restrict__ scratch, int* __restrict__ counters,
               int sq, int sk, int h, int kvh, float scale_log2, int causal, int q_offset,
               int splits) {
  using namespace hopper;
  using ws::ROWS;
  using ws::CONSUMERS;
  using S = ws::Shape<D, BK>;
  constexpr int STAGES = S::STAGES, NO = S::NO, NV = S::NV;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int last_s;

  // This block's item (batch row, KV head, row tile) and split, and its run
  // of key tiles [lo, lo + n): the host-known split, cut at kv_len[b].
  const int grp = h / kvh;
  const int n_rt = (sq * grp + ROWS - 1) / ROWS;
  const int item = blockIdx.x / splits, split = blockIdx.x % splits;
  const int rt = item % n_rt, kv = item / n_rt % kvh, b = item / n_rt / kvh;
  const int r0 = rt * ROWS;
  const int n_all = ws::item_tiles(r0, sq, sk, grp, causal, q_offset, BK);
  const int n_split = min(splits, max(1, n_all / ws::MIN_TILES));
  if (split >= n_split) return;  // this item takes fewer splits
  const int lo = split * n_all / n_split;
  const int kvl = valid_keys(sk, kv_len, b);
  const int n = max(0, min((split + 1) * n_all / n_split, (kvl + BK - 1) / BK) - lo);

  const int tid = threadIdx.x;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const base_p = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t ring = base + S::Q_BYTES;
  auto load_tile = [&](int j) {  // (K, V) tile j into its stage, by TMA
    const int s = j % STAGES;
    mbar_arrive_expect_tx(&full[s], S::STAGE);
    const uint32_t st = ring + s * S::STAGE;
    const int key0 = (lo + j) * BK;
#pragma unroll
    for (int a = 0; a < S::DP / 64; ++a) {
      tma_load_4d(st + a * BK * 128, &map_k, a * 64, kv, key0, b, &full[s]);
      tma_load_4d(st + S::KV_BYTES + a * BK * 128, &map_v, a * 64, kv, key0, b, &full[s]);
    }
  };
  // Before the block's one barrier, the producer thread sets up the ring
  // and starts its first pass, and the consumers load their Q rows into
  // registers: 16-byte chunks, chunk c of the warpgroup's row r; rows past
  // the call and D 16's padding are zeros.
  constexpr int CH = S::DP / 8, QN = 64 * CH / 128;
  uint4 qv[QN];
  int qrow[QN];  // each copy's row of q (and out) as (B Sq H) rows, or -1 past Sq
  // The softmax scales scores by c > 0: a negative scale negates Q instead
  // (exact in bf16); a zero scale is a tiny one, so masked scores stay -inf.
  const uint32_t q_sign = scale_log2 < 0.0f ? 0x80008000u : 0u;
  const float c = fmaxf(fabsf(scale_log2), 1e-30f);
  if (tid == CONSUMERS) {
    tma_prefetch_map(&map_k);
    tma_prefetch_map(&map_v);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                // the TMA issuer's arrival, with its bytes
      mbar_init(&empty[s], CONSUMERS / 32);  // every consumer warp
    }
    mbar_init_fence();
    for (int j = 0; j < min(n, STAGES); ++j) load_tile(j);
  } else if (tid < CONSUMERS) {
#pragma unroll
    for (int i = 0; i < QN; ++i) {
      const int r = (tid % 128 + 128 * i) / CH, ch = (tid % 128 + 128 * i) % CH;
      const int row = r0 + tid / 128 * 64 + r, pos = row / grp;
      qrow[i] = pos < sq ? (b * sq + pos) * h + kv * grp + row % grp : -1;
      qv[i] = make_uint4(0, 0, 0, 0);
      if (qrow[i] >= 0 && (ch < D / 8 || K7_FAULT == 2))
        qv[i] = *reinterpret_cast<const uint4*>(q + static_cast<size_t>(qrow[i]) * D + ch * 8);
    }
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ------------------------------------------------------------- producer
    reg_dealloc<40>();
    if (tid == CONSUMERS) {
      for (int j = STAGES; j < n; ++j) {
        mbar_wait(&empty[j % STAGES], (j / STAGES - 1) & 1);
        load_tile(j);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    reg_alloc<232>();
    const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;

    // This warpgroup's 64 Q rows into the 128-byte swizzle: row r's chunk c
    // at 128 r + 16 (c ^ r % 8) of its 64-column atom.
    const uint32_t q_wg = base + wg * (64 * S::DP * 2);
#pragma unroll
    for (int i = 0; i < QN; ++i) {
      const int r = (tid % 128 + 128 * i) / CH, ch = (tid % 128 + 128 * i) % CH;
      *reinterpret_cast<uint4*>(base_p + (q_wg - base) + (ch / 8) * (64 * 128) + r * 128 +
                                (((ch % 8) ^ (r % 8)) << 4)) =
          make_uint4(qv[i].x ^ q_sign, qv[i].y ^ q_sign, qv[i].z ^ q_sign, qv[i].w ^ q_sign);
    }
    fence_proxy_async();  // the stores, before the wgmma that read them
    named_sync(ws::kQ + wg, 128);

    // The last key each of this thread's two rows (g and g + 8 of its
    // warp's 16) may see.
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pos = (r0 + wg * 64 + warp * 16 + g + 8 * i) / grp;
      const long long cap = causal ? static_cast<long long>(q_offset) + pos : kvl - 1;
      lim[i] = static_cast<int>(min(cap, static_cast<long long>(kvl - 1)));
    }

    // Accumulator v of a 64 x N product: row g + 8 (v / 2 % 2) of the
    // warp's 16, column 8 (v / 4) + 2 t + v % 2.
    float sacc[BK / 2], o[NO];
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int v = 0; v < NO; ++v) o[v] = 0.0f;
    float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.0f, 0.0f};

    auto issue_s = [&](uint32_t st) {  // sacc = Q K^T
#if K7_FAULT == 2
      if constexpr (S::DP > D) {  // K's pad columns (the last atom's last chunks): 1.0 in odd keys
        for (int i = tid % 128; i < BK * (S::DP - D) / 8; i += 128) {
          const int r = i / ((S::DP - D) / 8), c = 8 - (S::DP - D) / 8 + i % ((S::DP - D) / 8);
          const uint32_t one = r % 2 ? 0x3f803f80u : 0u;
          *reinterpret_cast<uint4*>(base_p + (st - base) + (S::DP / 64 - 1) * (BK * 128) +
                                    r * 128 + ((c ^ r % 8) << 4)) = make_uint4(one, one, one, one);
        }
        fence_proxy_async();
      }
#endif
#pragma unroll
      for (int kk = 0; kk < S::KSTEPS; ++kk) {
        const uint64_t da = k_sw128_desc(q_wg + (kk / 4) * (64 * 128) + (kk % 4) * 32);
        const uint64_t db = k_sw128_desc(st + (kk / 4) * (BK * 128) + (kk % 4) * 32);
        if constexpr (BK == 128)
          wgmma_m64n128k16<0, 0>(sacc, da, db, kk > 0);
        else
          wgmma_m64n64k16<0, 0>(sacc, da, db, kk > 0);
      }
    };
    auto issue_pv = [&](uint32_t st) {  // o += P V
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = mn_sw128_desc(st + S::KV_BYTES + kk * 16 * 128, BK * 128);
        if constexpr (S::DP == 128)
          wgmma_m64n128k16_rs(o, pf[kk], db);
        else
          wgmma_m64n64k16_rs(o, pf[kk], db);
      }
    };

    // One tile's softmax once its Q K^T has landed in sacc: scores masked
    // where the tile crosses a row's limit; each row's new running max over
    // its quad of lanes, taken on the raw scores (c > 0) and then scaled;
    // P = 2^(c s - max) into sacc, its row sums into rs, and the factor corr
    // that rescales O and l. Per score: a max, an FMA, an ex2 and an add.
    float corr[2], rs[2];
    auto softmax = [&](int j) {
      const int key0 = (lo + j) * BK;
      if (key0 + BK - 1 > min(lim[0], lim[1])) {  // the tile crosses a row's limit
#pragma unroll
        for (int v = 0; v < BK / 2; ++v)
          if (key0 + 8 * (v / 4) + 2 * t + v % 2 > lim[v / 2 % 2]) sacc[v] = neg_inf();
      }
      // Four partial maxima and sums a row (accumulators v, v + 2 of row
      // v / 2 % 2 go to chain v / 4 % 4), for independent instructions.
      float mx[2][4], sums[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[r][i] = neg_inf(), sums[r][i] = 0.0f;
#pragma unroll
      for (int v = 0; v < BK / 2; ++v)
        mx[v / 2 % 2][v / 4 % 4] = fmaxf(mx[v / 2 % 2][v / 4 % 4], sacc[v]);
      float base_r[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float top = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
        const float mn = fmaxf(m[r], top * c);
        base_r[r] = mn == neg_inf() ? 0.0f : mn;  // a row with nothing visible yet
        corr[r] = ex2(m[r] - base_r[r]);
        m[r] = mn;
      }
#pragma unroll
      for (int v = 0; v < BK / 2; ++v) {
        sacc[v] = ex2(fmaf(sacc[v], c, -base_r[v / 2 % 2]));
        sums[v / 2 % 2][v / 4 % 4] += sacc[v];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) rs[r] = (sums[r][0] + sums[r][1]) + (sums[r][2] + sums[r][3]);
    };
    // Once the previous tile's P V has landed: rescale O and l, and P as
    // the bf16 A operand of the next P V (16 keys a step, the accumulators
    // of two 8-key column blocks).
    auto rescale = [&]() {
#pragma unroll
      for (int v = 0; v < NO; ++v) o[v] *= corr[v / 2 % 2];
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          __nv_bfloat162 p2 = __floats2bfloat162_rn(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);
          pf[kk][i] = *reinterpret_cast<uint32_t*>(&p2);
        }
    };

    // The two warpgroups take turns to issue (warpgroup 0 first): tile 0's
    // Q K^T alone, then tile j's Q K^T with tile j - 1's P V, so every turn
    // but the first leaves two commit groups in flight in a fixed order.
    if (wg == 1) named_arrive(ws::kSched, CONSUMERS);
    if (n > 0) {
      mbar_wait(&full[0], 0);
      named_sync(ws::kSched + wg, CONSUMERS);
      wgmma_fence();
      issue_s(ring);
      wgmma_commit();
      named_arrive(ws::kSched + (wg ^ 1), CONSUMERS);
      wgmma_wait<0>();
      fence_operands(sacc);
      softmax(0);
      rescale();
    }
    for (int j = 1; j < n; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      named_sync(ws::kSched + wg, CONSUMERS);
      wgmma_fence();
      issue_s(ring + s * S::STAGE);
      wgmma_commit();
      issue_pv(ring + (j - 1) % STAGES * S::STAGE);
      wgmma_commit();
      named_arrive(ws::kSched + (wg ^ 1), CONSUMERS);
      wgmma_wait<1>();  // Q K^T has landed; P V may still run
      fence_operands(sacc);
      softmax(j);
      // Pins the exponentials above the wait: without it the compiler sank
      // them below, and the softmax no longer ran beside P V.
      fence_operands(sacc);
      fence_operands(rs);
      wgmma_wait<0>();  // the previous tile's P V has landed: its stage is free
      fence_operands(o);
      if (lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
      rescale();
    }
    if (n > 0) {
      wgmma_fence();
      issue_pv(ring + (n - 1) % STAGES * S::STAGE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
    }
    if (wg == 0) named_sync(ws::kSched, CONSUMERS);  // warpgroup 1's last turn
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }

    // The output rows: rounded to bf16 once into this warpgroup's Q area
    // (free once its last Q K^T is done; row r's 16-byte chunk c at
    // 16 (PCH r + (c ^ r % SW)) bytes, PCH chunks a row: D 16's 2, else the
    // padded row's CH, so that c ^ r % SW stays inside the row and a warp's
    // stores hit distinct banks), then stored 16 bytes a thread, whole rows
    // at a time.
    auto store = [&](const float (&acc)[NO], const float (&sum)[2]) {
      constexpr int NCH = D / 8;
      constexpr int PCH = D < 64 || K7_FAULT == 1 ? NCH : CH, SW = PCH < 8 ? PCH : 8;
      unsigned char* const stg = base_p + (q_wg - base);
      const float inv[2] = {1.0f / fmaxf(sum[0], 1e-20f), 1.0f / fmaxf(sum[1], 1e-20f)};
#pragma unroll
      for (int v = 0; v < NV; v += 2) {
        const int r = v / 2 % 2, rr = warp * 16 + g + 8 * r;
        *reinterpret_cast<__nv_bfloat162*>(stg + rr * PCH * 16 + ((v / 4 ^ rr % SW) << 4) + 4 * t) =
            __floats2bfloat162_rn(acc[v] * inv[r], acc[v + 1] * inv[r]);
      }
      named_sync(ws::kQ + wg, 128);
      // With D >= 64 a thread stores the rows it loaded Q from, so the
      // division by grp is not done again (done a row at a time, it cost
      // about as much as the stores); chunks past D are the pad.
      if constexpr (PCH == CH) {
#pragma unroll
        for (int i = 0; i < QN; ++i) {
          const int rr = (tid % 128 + 128 * i) / CH, ch = (tid % 128 + 128 * i) % CH;
          if (qrow[i] >= 0 && ch < NCH)
            *reinterpret_cast<uint4*>(out + static_cast<size_t>(qrow[i]) * D + ch * 8) =
                *reinterpret_cast<const uint4*>(stg + rr * PCH * 16 + ((ch ^ rr % SW) << 4));
        }
      } else {
        for (int i = tid % 128; i < 64 * NCH; i += 128) {
          const int rr = i / NCH, ch = i % NCH;
          const int row = r0 + wg * 64 + rr, pos = row / grp;
          if (pos < sq)
            *reinterpret_cast<uint4*>(
                out + (static_cast<size_t>(b * sq + pos) * h + kv * grp + row % grp) * D + ch * 8) =
                *reinterpret_cast<const uint4*>(stg + rr * PCH * 16 + ((ch ^ rr % SW) << 4));
        }
      }
    };
    if (n_split == 1) {
      store(o, l);
      return;
    }
    // A partial: thread tid's value v at v * CONSUMERS + tid of its slot.
    float* mine = scratch + static_cast<size_t>(blockIdx.x) * S::SLOT + tid;
#pragma unroll
    for (int v = 0; v < NV; ++v) __stcg(mine + v * CONSUMERS, o[v]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __stcg(mine + (NV + r) * CONSUMERS, m[r]);
      __stcg(mine + (NV + 2 + r) * CONSUMERS, l[r]);
    }
    __threadfence();
    named_sync(ws::kConsumers, CONSUMERS);
    if (tid == 0) {
      const bool last = atomicAdd(counters + item, 1) == n_split - 1;
      if (last) counters[item] = 0;  // zero again for the next call
      last_s = last;
    }
    named_sync(ws::kConsumers, CONSUMERS);
    if (!last_s) return;
    __threadfence();
    const float* slot0 = scratch + static_cast<size_t>(item) * splits * S::SLOT + tid;
    float top[2] = {neg_inf(), neg_inf()};
    for (int k = 0; k < n_split; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        top[r] = fmaxf(top[r], __ldcg(slot0 + k * S::SLOT + (NV + r) * CONSUMERS));
#pragma unroll
    for (int r = 0; r < 2; ++r) top[r] = top[r] == neg_inf() ? 0.0f : top[r];
    float sum[2] = {0.0f, 0.0f};
    for (int k = 0; k < n_split; ++k) {
      const float* p = slot0 + k * S::SLOT;
      float w[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        w[r] = ex2(__ldcg(p + (NV + r) * CONSUMERS) - top[r]);
        sum[r] = k ? sum[r] + w[r] * __ldcg(p + (NV + 2 + r) * CONSUMERS)
                   : w[r] * __ldcg(p + (NV + 2 + r) * CONSUMERS);
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float x = w[v / 2 % 2] * __ldcg(p + v * CONSUMERS);
        o[v] = k ? o[v] + x : x;
      }
    }
    store(o, sum);
  }
}

// ------------------------------------------------------------- float32 path
namespace fp {
constexpr int BQ = 32;  // query rows per block
constexpr int BK = 16;  // keys per tile
}  // namespace fp

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const long long* __restrict__ kv_len,
              float* __restrict__ out, int sq, int sk, int h, int kvh, float scale, int causal,
              int q_offset) {
  using namespace fp;
  constexpr int DJ = D / 4;  // output columns per thread
  __shared__ float q_s[BQ][D + 1];
  __shared__ float k_s[BK][D + 1];
  __shared__ float v_s[BK][D];
  __shared__ float p_s[BQ][BK + 1];
  __shared__ float m_s[BQ], l_s[BQ], c_s[BQ];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(kvh) * D;
  const float* qb = q + static_cast<size_t>(b) * sq * q_stride + static_cast<size_t>(hh) * D;
  const size_t kv_off = static_cast<size_t>(b) * sk * kv_stride +
                        static_cast<size_t>(hh / (h / kvh)) * D;
  const int kvl = valid_keys(sk, kv_len, b);
  const int q_end = min(q0 + BQ, sq);
  const int n_tiles = (needed_keys(kvl, causal, q_offset, q_end) + BK - 1) / BK;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    q_s[r][c] = q0 + r < sq ? qb[(q0 + r) * q_stride + c] : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = neg_inf();
    l_s[tid] = 0.0f;
  }
  float acc[DJ];
#pragma unroll
  for (int jj = 0; jj < DJ; ++jj) acc[jj] = 0.0f;
  const int row = tid / 4;  // this thread's row; its columns are tid % 4 + 4 jj

  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * BK;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = key0 + r < kvl;
      const size_t off = kv_off + (ok ? key0 + r : 0) * kv_stride + c;
      k_s[r][c] = ok ? k[off] : 0.0f;
      v_s[r][c] = ok ? v[off] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int col = tid % 4 + 4 * i;
      float s = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(q_s[row][d], k_s[col][d], s);
      const int key = key0 + col;
      const bool vis = key < kvl && (!causal || key <= q_offset + q0 + row);
      p_s[row][col] = vis ? s * scale : neg_inf();
    }
    __syncthreads();
    if (tid < BQ) {
      float mx = m_s[tid];
      for (int c = 0; c < BK; ++c) mx = fmaxf(mx, p_s[tid][c]);
      const float base = mx == neg_inf() ? 0.0f : mx;
      float sum = 0.0f;
      for (int c = 0; c < BK; ++c) {
        const float p = expf(p_s[tid][c] - base);
        p_s[tid][c] = p;
        sum += p;
      }
      const float corr = expf(m_s[tid] - base);
      c_s[tid] = corr;
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = mx;
    }
    __syncthreads();
    const float corr = c_s[row];
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int col = tid % 4 + 4 * jj;
      float a = acc[jj] * corr;
#pragma unroll
      for (int c = 0; c < BK; ++c) a = fmaf(p_s[row][c], v_s[c][col], a);
      acc[jj] = a;
    }
  }
  __syncthreads();
  if (q0 + row < sq) {
    const float inv = 1.0f / fmaxf(l_s[row], 1e-20f);
    float* orow = out + static_cast<size_t>(b) * sq * q_stride + (q0 + row) * q_stride +
                  static_cast<size_t>(hh) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) orow[tid % 4 + 4 * jj] = acc[jj] * inv;
  }
}

template <int D, int BK>
int launch_bf16(const void* q, const void* k, const void* v, const long long* kv_len, void* out,
                float* scratch, int* counters, int b, int sq, int sk, int h, int kvh, float scale,
                int causal, int q_offset, int splits, cudaStream_t s) {
  using S = ws::Shape<D, BK>;
  const long long n_rt = (static_cast<long long>(sq) * (h / kvh) + ws::ROWS - 1) / ws::ROWS;
  const long long grid = static_cast<long long>(b) * kvh * n_rt * splits;
  if (splits < 1 || grid > 0x7fffffff || (splits > 1 && (!scratch || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  // (D, KV, Sk, B) maps of K and V, boxes of 64 columns x BK keys of one
  // KV head and batch row.
  CUtensorMap map_k{}, map_v{};
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(kvh),
                              static_cast<cuuint64_t>(sk), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * kvh, 2ull * D * kvh * sk};
  const cuuint32_t box[4] = {64, 1, BK, 1};
  if (!hopper::tensor_map_bf16_nd(&map_k, k, 4, dims, strides, box) ||
      !hopper::tensor_map_bf16_nd(&map_v, v, 4, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_fwd_bf16<D, BK>;
  static bool smem_set[64] = {};  // per device, once: the call costs host time
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = true;
  }
  kern<<<static_cast<int>(grid), ws::BLOCK, S::SMEM, s>>>(
      map_k, map_v, static_cast<const bf16*>(q), kv_len, static_cast<bf16*>(out), scratch,
      counters, sq, sk, h, kvh, scale * LOG2E, causal, q_offset, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const long long* kv_len, void* out,
           float* scratch, int* counters, int b, int sq, int sk, int h, int kvh, float scale,
           int causal, int q_offset, int dtype, int bk, int splits, cudaStream_t s) {
  if (dtype == 1) {
    if (bk == 64)
      return launch_bf16<D, 64>(q, k, v, kv_len, out, scratch, counters, b, sq, sk, h, kvh,
                                scale, causal, q_offset, splits, s);
    if (bk == 128)
      return launch_bf16<D, 128>(q, k, v, kv_len, out, scratch, counters, b, sq, sk, h, kvh,
                                 scale, causal, q_offset, splits, s);
  } else if (dtype == 0) {
    dim3 grid((sq + fp::BQ - 1) / fp::BQ, h, b);
    flash_fwd_f32<D><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), kv_len, static_cast<float*>(out), sq, sk, h, kvh, scale,
        causal, q_offset);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_len: (B,) int64 on the device, or
// null for Sk. bf16 only: bk (64 or 128) keys a tile and `splits` blocks an
// item, from kernels/flash_attention.py's flash_schedule; with splits > 1,
// scratch holds grid x (D / 2 + 4) x 256 floats and counters one int32 per
// item, zero before the call and zero again after it. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape,
// head size or schedule the kernels do not take).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     const void* kv_len, void* out, void* scratch,
                                     void* counters, int b, int sq, int sk, int h, int kvh,
                                     int d, float scale, int causal, int q_offset, int dtype,
                                     int bk, int splits, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h <= 0 || h % kvh || b > 65535 || h > 65535 ||
      static_cast<long long>(b) * sq * h > 0x7fffffff)  // q's rows index as int
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* kl = static_cast<const long long*>(kv_len);
  float* sc = static_cast<float*>(scratch);
  int* ct = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, kl, out, sc, ct, b, sq, sk, h, kvh, scale, causal, q_offset,
                        dtype, bk, splits, s);
    case 64:
      return launch<64>(q, k, v, kl, out, sc, ct, b, sq, sk, h, kvh, scale, causal, q_offset,
                        dtype, bk, splits, s);
    case 112:
      return launch<112>(q, k, v, kl, out, sc, ct, b, sq, sk, h, kvh, scale, causal, q_offset,
                         dtype, bk, splits, s);
    case 128:
      return launch<128>(q, k, v, kl, out, sc, ct, b, sq, sk, h, kvh, scale, causal, q_offset,
                         dtype, bk, splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
