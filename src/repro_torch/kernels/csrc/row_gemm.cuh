// Row-tile grouped GEMM shared by K1 (fused_w1.cu), K2 (fused_w2.cu) and
// K4 (cvmm.cu):
//
//     h[t] = A[t] @ w[tile_expert[t]]     for every 128-row plan tile t
//
// with an epilogue that applies an activation (and GLU) or scales rows by a
// float32 gate, and writes u (and the pre-activations h, hg) rounded once.
//
// Layout contract (kernels/ops.py): every 128-row tile belongs to one
// expert; K_pad and N_pad are multiples of 128; all arrays row-major and
// contiguous. A is either tile-aligned (M_pad, K_pad), or, with GATHER, the
// unsorted (n_rows, K_pad) activations read through row_src: row r of the
// padded layout is A[row_src[r]], and a sentinel (any index outside
// [0, n_rows)) is a zero row that is never read. A tile whose tile_expert
// entry lies outside [0, E) is written as zeros.
//
// Two mainloops:
//
// row_gemm_wgmma (bf16, K1, K2 and K4): persistent and warp-specialised. About
// one block per SM walks the (128-row tile, BN-column block) items
// blockIdx.x, blockIdx.x + gridDim.x, ... (tile-major, so neighbouring
// blocks share A tiles and expert weights in L2). One producer thread keeps
// a ring of 3-5 stages full, each a 64-deep slice of the tile's 128 A rows
// (K-major) and of each weight's BN columns (MN-major), 128-byte swizzled:
// the weights, and A where it is tile-aligned (K2, K4), by TMA; with GATHER
// (K1) the whole producer warpgroup copies A's rows through row_src by
// 16-byte cp.async with the swizzle computed by hand, since TMA cannot
// gather rows, and stores a sentinel row as zeros. The producer runs on
// into the next item while the consumers finish this one. Two consumer
// warpgroups run wgmma (m64nBNk16) on 64 rows each with float32
// accumulators in registers; the epilogue applies the activation (chosen
// at compile time: a runtime choice per element cost 3x the mainloop), GLU
// and the saved h, hg, or (GATE, K2, also a compile-time flag) multiplies
// each float32 accumulator by its row's float32 gate, rounds once to bf16
// into shared memory and stores whole rows 16 bytes a thread, while the
// producer fills the next item's stages. BN is 256, 128 or 64
// (kernels/cvmm.py's row_gemm_schedule picks it and the grid): wide items
// read fewer L2 bytes per operation, narrow ones spread a small grid over
// more SMs; GLU takes 64 for each of its two products, save_preact at most
// 128 (shared memory for the staged outputs). Each output element is one
// block's float32 sum in a fixed order, so every call gives the same bits.
// row_gemm_f32 (float32, K1, K2 and K4): one block per (64-row, 64-column)
// output block, 16x16 threads with 4x4 outputs each on plain FMAs (no
// TF32), so it keeps full float32 accuracy.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace rowgemm {

using hopper::cp_async16;

constexpr int TM = 128;  // plan row tile: every tile belongs to one expert

enum Act { kIdentity = 0, kRelu = 1, kGelu = 2, kSilu = 3 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.0f);
    case kGelu: {  // the tanh approximation, as the reference's gelu
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case kSilu:
      return x / (1.0f + expf(-x));
    default:
      return x;
  }
}

// An activation as a type, so that a loop over accumulators calls
// activate() with a constant: a runtime act there can compile to every
// branch for each element.
template <int ACT>
struct ActTag {
  static constexpr int value = ACT;
};

__device__ __forceinline__ bool valid_row(int src, int n_rows) {
  return src >= 0 && src < n_rows;
}

using bf16 = __nv_bfloat16;

// ------------------------------------------------ bf16 path on Hopper
namespace ws {
constexpr int BM = 128, BK = 64;          // a stage: 128 A rows, 64 deep
constexpr int CONSUMERS = 256;            // two warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int A_BYTES = BM * BK * 2;      // [128 rows][64 k], K-major
constexpr int HALF = BK * 128;            // [64 k][64 columns], one MN-major atom
constexpr int BUDGET = 232448 - 2048;     // dynamic shared memory (static, alignment)
static_assert(BM == TM, "an item's rows are one plan tile");

// Shared memory of one instance: the ring of STAGES stages (A, then each
// weight's BN columns as 64-column atoms), then the output staging, NOUT
// outputs x two warpgroups x 64 rows of BN bf16, rows padded by 16 bytes
// (the fragment stores then hit 32 distinct banks).
template <int BN, bool GLU, bool SAVE>
struct Shape {
  static constexpr int NW = GLU ? 2 : 1;
  static constexpr int NOUT = 1 + SAVE + (SAVE && GLU);  // u, h, hg
  static constexpr int B_BYTES = BK * BN * 2;            // one weight's slice
  static constexpr int STAGE = A_BYTES + NW * B_BYTES;
  static constexpr int ROW = BN * 2 + 16;                // a staged output row
  static constexpr int OUT = NOUT * 2 * 64 * ROW;
  static constexpr int STAGES = (BUDGET - OUT) / STAGE < 5 ? (BUDGET - OUT) / STAGE : 5;
  static constexpr int SMEM = STAGES * STAGE + OUT + 1024;  // + aligning the ring
  static_assert(STAGES >= 3, "a ring of at least three stages");
};
}  // namespace ws

template <int BN, bool GATHER, bool GLU, bool SAVE, bool GATE>
__global__ void __launch_bounds__(ws::THREADS, 1)
row_gemm_wgmma(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_wg, const bf16* __restrict__ a,
               const int* __restrict__ row_src, int n_rows, const int* __restrict__ tile_expert,
               const float* __restrict__ gate, bf16* __restrict__ out_u,
               bf16* __restrict__ out_h, bf16* __restrict__ out_hg, int k_pad, int n_pad,
               int n_experts, int act, int n_items) {
  using namespace hopper;
  using namespace ws;
  using S = Shape<BN, GLU, SAVE>;
  static_assert(BN == 256 || BN == 128 || BN == 64, "items 64, 128 or 256 columns wide");
  static_assert(!GLU || BN == 64, "GLU's two products take 64 columns each");
  static_assert(!GATE || (!GATHER && !GLU && !SAVE), "the gate is K2's alone");
  constexpr int NW = S::NW, STAGES = S::STAGES, STAGE = S::STAGE;
  constexpr int NV = BN / 2;  // accumulators of one product a consumer thread holds
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  const int tid = threadIdx.x;
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const ring_p = smem_raw + (ring - smem_u32(smem_raw));
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the TMA issuer's arrival (with its bytes) and, with GATHER, each
      // producer thread's copies and stores
      mbar_init(&full[s], 1 + (GATHER ? 2 * 128 : 0));
      mbar_init(&empty[s], CONSUMERS / 32);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_cb = n_pad / BN, n_k = k_pad / BK;
  // Each role reads the next item's indices while it works on this one.
  auto expert_of = [&](int item) { return item < n_items ? tile_expert[item / n_cb] : -1; };

  if (tid < CONSUMERS) {
    // ------------------------------------------------------------ consumers
    // Accumulator v of thread tid: row 16 * warp + lane / 4 + 8 * (v / 2 % 2)
    // of its warpgroup's 64, column 8 * (v / 4) + 2 * (lane % 4) + v % 2.
    const int wgi = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
    const int row = warp * 16 + lane / 4, col = 2 * (lane % 4);
    unsigned char* const stg = ring_p + STAGES * STAGE + wgi * 64 * S::ROW;
    bf16* const outs[3] = {out_u, out_h, out_hg};
    int it = 0;  // slices consumed so far: the ring position
    int e = expert_of(blockIdx.x);
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int t = item / n_cb, n0 = item % n_cb * BN;
      const int e_next = expert_of(item + gridDim.x);
      // GATE: this thread's two rows' gates, read while the mainloop runs
      float g_lo = 1.0f, g_hi = 1.0f;
      if constexpr (GATE) {
        g_lo = gate[t * TM + wgi * 64 + row];
        g_hi = gate[t * TM + wgi * 64 + row + 8];
      }
      float acc[NW][NV];
#pragma unroll
      for (int q = 0; q < NW; ++q)
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[q][v] = 0.0f;
      if (e >= 0 && e < n_experts) {  // else zeros: act(0) = 0 for every act
        for (int ks = 0; ks < n_k; ++ks, ++it) {
          const int s = it % STAGES;
          mbar_wait(&full[s], (it / STAGES) & 1);
          fence_proxy_async();
          const uint32_t sa = ring + s * STAGE + wgi * (64 * 128);
          const uint32_t sb = ring + s * STAGE + A_BYTES;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t da = k_sw128_desc(sa + kk * 32);
            if constexpr (BN == 256) {
              wgmma_m64n256k16<0>(acc[0], da, mn_sw128_desc(sb + kk * 16 * 128, HALF));
            } else if constexpr (BN == 128) {
              wgmma_m64n128k16<0>(acc[0], da, mn_sw128_desc(sb + kk * 16 * 128, HALF));
            } else {
#pragma unroll
              for (int q = 0; q < NW; ++q)
                wgmma_m64n64k16<0>(acc[q], da,
                                   mn_sw128_desc(sb + q * S::B_BYTES + kk * 16 * 128, HALF));
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // the slice before this one is read
          if (ks > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int q = 0; q < NW; ++q) fence_operands(acc[q]);
        if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      // Epilogue, while the producer fills the next item's stages: u =
      // act(h) [* hg] (or, with GATE, h * gate[row]), h and hg rounded to
      // bf16 once into this warpgroup's staging rows, then read back 16
      // bytes a thread and stored whole rows at a time. The first barrier:
      // every thread of the warpgroup has read the previous item's staging
      // rows.
      named_sync(1 + wgi, 128);
      auto stage = [&](auto tag) {
        constexpr int ACT = decltype(tag)::value;
#pragma unroll
        for (int v = 0; v < NV; v += 2) {
          const int off = (row + 8 * (v / 2 % 2)) * S::ROW + (col + 8 * (v / 4)) * 2;
          auto put = [&](int o, float x, float y) {
            *reinterpret_cast<__nv_bfloat162*>(stg + o * 2 * 64 * S::ROW + off) =
                __floats2bfloat162_rn(x, y);
          };
          const float h0 = acc[0][v], h1 = acc[0][v + 1];
          if (SAVE) put(1, h0, h1);
          float u0 = activate(h0, ACT), u1 = activate(h1, ACT);
          if (GATE) {  // accumulators v and v + 1 lie in row + 8 * (v / 2 % 2)
            const float g = v / 2 % 2 ? g_hi : g_lo;
            u0 *= g;
            u1 *= g;
          }
          if (GLU) {
            const float g0 = acc[NW - 1][v], g1 = acc[NW - 1][v + 1];
            if (SAVE) put(2, g0, g1);
            u0 *= g0;
            u1 *= g1;
          }
          put(0, u0, u1);
        }
      };
      switch (GATHER ? act : kIdentity) {  // K2 and K4 have no activation
        case kRelu: stage(ActTag<kRelu>{}); break;
        case kGelu: stage(ActTag<kGelu>{}); break;
        case kSilu: stage(ActTag<kSilu>{}); break;
        default: stage(ActTag<kIdentity>{});
      }
      named_sync(1 + wgi, 128);
      constexpr int CH = BN / 8, RS = 128 / CH;  // 16-byte chunks a row; rows a pass
      const int c = tid % 128 % CH, r0 = tid % 128 / CH;
#pragma unroll
      for (int o = 0; o < S::NOUT; ++o)
#pragma unroll
        for (int j = 0; j < 64 / RS; ++j) {
          const int r = r0 + RS * j;
          const uint4 v = *reinterpret_cast<const uint4*>(stg + o * 2 * 64 * S::ROW +
                                                          r * S::ROW + c * 16);
          // One int row and column, then one 64-bit offset. Written as one
          // 64-bit product of the row's sum, the store compiled to code that
          // made the row-tile GEMMs 1.3-1.6x slower at wt103-47m-moe's
          // training shapes (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
          const int grow = t * TM + wgi * 64 + r, gcol = n0 + c * 8;
          *reinterpret_cast<uint4*>(outs[o] + (size_t)grow * n_pad + gcol) = v;
        }
      e = e_next;
    }
  } else {
    // ------------------------------------------------------------- producer
    // Thread 0 loads each stage's weight slices (64 x 64 boxes) and, for
    // tile-aligned A, its 128 x 64 box by TMA, 128-byte swizzled. With
    // GATHER every producer thread p copies the 16-byte chunk ca of A rows
    // ra + 16 i (i < 8) through row_src by cp.async, swizzled by hand: row
    // r's chunk c sits at byte 128 r + 16 (c ^ r % 8), as TMA places it.
    const int p = tid - CONSUMERS;
    if (!GATHER && p > 0) return;
    const int ca = p % 8, ra = p / 8;
    const int a_so = ra * 128 + ((ca ^ (ra % 8)) << 4);  // r % 8 == ra % 8
    constexpr uint32_t TX = (GATHER ? 0 : A_BYTES) + NW * S::B_BYTES;  // TMA bytes a stage
    int it = 0;
    auto rows_of = [&](int item, int (&src)[8]) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = item / n_cb * TM + ra + 16 * i;
        src[i] = GATHER && item < n_items ? row_src[r] : r;
      }
    };
    int e = expert_of(blockIdx.x), src[8];
    rows_of(blockIdx.x, src);
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int m0 = item / n_cb * TM, n0 = item % n_cb * BN;
      const int e_next = expert_of(item + gridDim.x);
      int src_next[8];
      rows_of(item + gridDim.x, src_next);
      if (e >= 0 && e < n_experts) {
        const bf16* ga = a + ca * 8;
        for (int ks = 0; ks < n_k; ++ks, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          const uint32_t st = ring + s * STAGE;
          if (p == 0) {
            mbar_arrive_expect_tx(&full[s], TX);
            if (!GATHER) tma_load_2d(st, &map_a, ks * BK, m0, &full[s]);
#pragma unroll
            for (int q = 0; q < NW; ++q)
#pragma unroll
              for (int j = 0; j < BN / 64; ++j)
                tma_load_2d(st + A_BYTES + q * S::B_BYTES + j * HALF, q == 0 ? &map_w : &map_wg,
                            n0 + 64 * j, e * k_pad + ks * BK, &full[s]);
          }
          if constexpr (GATHER) {
            unsigned char* const sa = ring_p + s * STAGE + a_so;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              if (valid_row(src[i], n_rows))
                cp_async16(sa + i * 16 * 128, ga + (size_t)src[i] * k_pad + ks * BK);
              else  // sentinel: a zero row, never read
                *reinterpret_cast<uint4*>(sa + i * 16 * 128) = make_uint4(0, 0, 0, 0);
            }
            cp_async_arrive(&full[s]);  // when the copies have landed
            mbar_arrive(&full[s]);      // the stores (release)
          }
        }
      }
      e = e_next;
#pragma unroll
      for (int i = 0; i < 8; ++i) src[i] = src_next[i];
    }
    if (GATHER) cp_async_wait_all();
  }
}

template <int BN, bool GATHER, bool GLU, bool SAVE, bool GATE>
cudaError_t launch_wgmma_bn(int grid, const bf16* a, const int* rs, int n_rows, const int* te,
                            const bf16* w, const bf16* wg, const float* gate, bf16* u, bf16* h,
                            bf16* hg, int m_pad, int k_pad, int n_pad, int n_experts, int act,
                            cudaStream_t s) {
  const long long items = (long long)(m_pad / TM) * (n_pad / BN);
  if (grid <= 0 || n_pad % BN || items > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr int smem = ws::Shape<BN, GLU, SAVE>::SMEM;
  CUtensorMap map_a{}, map_w{}, map_wg{};
  const uint64_t w_rows = (uint64_t)n_experts * k_pad;
  if ((!GATHER && !hopper::tensor_map_bf16(&map_a, a, m_pad, k_pad, ws::BM)) ||
      !hopper::tensor_map_bf16(&map_w, w, w_rows, n_pad, ws::BK) ||
      (GLU && !hopper::tensor_map_bf16(&map_wg, wg, w_rows, n_pad, ws::BK)))
    return cudaErrorInvalidValue;
  auto kern = row_gemm_wgmma<BN, GATHER, GLU, SAVE, GATE>;
  static bool smem_set[64] = {};  // per device, once: the call costs host time
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = true;
  }
  kern<<<grid, ws::THREADS, smem, s>>>(map_a, map_w, map_wg, a, rs, n_rows, te, gate, u, h,
                                       hg, k_pad, n_pad, n_experts, act,
                                       static_cast<int>(items));
  return cudaGetLastError();
}

// bf16 through row_gemm_wgmma with items bn columns wide on a persistent
// grid of `grid` blocks, both from kernels/cvmm.py's row_gemm_schedule: bn
// is 64, 128 or (without GLU and SAVE) 256; with GLU 64. GATE (K2) scales
// each row by gate[row]. The caller has checked the shapes.
template <bool GATHER, bool GLU, bool SAVE, bool GATE = false>
cudaError_t launch_wgmma(int bn, int grid, const bf16* a, const int* rs, int n_rows,
                         const int* te, const bf16* w, const bf16* wg, const float* gate,
                         bf16* u, bf16* h, bf16* hg, int m_pad, int k_pad, int n_pad,
                         int n_experts, int act, cudaStream_t s) {
  if (bn == 64)
    return launch_wgmma_bn<64, GATHER, GLU, SAVE, GATE>(grid, a, rs, n_rows, te, w, wg, gate,
                                                        u, h, hg, m_pad, k_pad, n_pad,
                                                        n_experts, act, s);
  if constexpr (!GLU) {
    if (bn == 128)
      return launch_wgmma_bn<128, GATHER, GLU, SAVE, GATE>(grid, a, rs, n_rows, te, w, wg,
                                                           gate, u, h, hg, m_pad, k_pad, n_pad,
                                                           n_experts, act, s);
    if constexpr (!SAVE) {
      if (bn == 256)
        return launch_wgmma_bn<256, GATHER, GLU, SAVE, GATE>(grid, a, rs, n_rows, te, w, wg,
                                                             gate, u, h, hg, m_pad, k_pad,
                                                             n_pad, n_experts, act, s);
    }
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------- float32 path
namespace fp {
constexpr int BM = 64, BN = 64, BK = 16;  // BM divides TM
constexpr int THREADS = 256;              // 16 x 16 threads, 4 x 4 outputs each
static_assert(TM % BM == 0, "a block never straddles two plan tiles");
}  // namespace fp

template <bool GATHER, bool GLU, bool SAVE, bool GATE>
__global__ void __launch_bounds__(fp::THREADS)
row_gemm_f32(const float* __restrict__ a, const int* __restrict__ row_src, int n_rows,
             const int* __restrict__ tile_expert, const float* __restrict__ w,
             const float* __restrict__ wg, const float* __restrict__ gate,
             float* __restrict__ out_u, float* __restrict__ out_h,
             float* __restrict__ out_hg, int k_pad, int n_pad, int n_experts, int act) {
  using namespace fp;
  constexpr int NW = GLU ? 2 : 1;
  __shared__ float a_s[BK][BM + 4];  // transposed slice of A
  __shared__ float b_s[NW][BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int e = tile_expert[m0 / TM];

  float acc[NW][4][4] = {};
  if (e >= 0 && e < n_experts) {
    const size_t w_off = (size_t)e * k_pad * n_pad + n0;
    const int ar = tid / 4, ac = (tid % 4) * 4;    // A: 64 rows x 16 cols
    const int br = tid / 16, bc = (tid % 16) * 4;  // w: 16 rows x 64 cols
    const int src = GATHER ? row_src[m0 + ar] : m0 + ar;
    const bool ok = !GATHER || valid_row(src, n_rows);
    for (int k0 = 0; k0 < k_pad; k0 += BK) {
      const float4 av = ok ? *reinterpret_cast<const float4*>(a + (size_t)src * k_pad + k0 + ac)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      a_s[ac + 0][ar] = av.x;
      a_s[ac + 1][ar] = av.y;
      a_s[ac + 2][ar] = av.z;
      a_s[ac + 3][ar] = av.w;
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(
            (q == 0 ? w : wg) + w_off + (size_t)(k0 + br) * n_pad + bc);
        b_s[q][br][bc + 0] = bv.x;
        b_s[q][br][bc + 1] = bv.y;
        b_s[q][br][bc + 2] = bv.z;
        b_s[q][br][bc + 3] = bv.w;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av4[i] = a_s[k][ty * 4 + i];
#pragma unroll
        for (int q = 0; q < NW; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b = b_s[q][k][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[q][i][j] = fmaf(av4[i], b, acc[q][i][j]);
          }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    const size_t off = (size_t)row * n_pad + n0 + tx * 4;
    const float s = GATE ? gate[row] : 1.0f;
    float u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      u[j] = activate(acc[0][i][j], act);
      if (GLU) u[j] *= acc[NW - 1][i][j];
      u[j] *= s;
    }
    *reinterpret_cast<float4*>(out_u + off) = make_float4(u[0], u[1], u[2], u[3]);
    if (SAVE)
      *reinterpret_cast<float4*>(out_h + off) =
          make_float4(acc[0][i][0], acc[0][i][1], acc[0][i][2], acc[0][i][3]);
    if (SAVE && GLU)
      *reinterpret_cast<float4*>(out_hg + off) = make_float4(
          acc[NW - 1][i][0], acc[NW - 1][i][1], acc[NW - 1][i][2], acc[NW - 1][i][3]);
  }
}

}  // namespace rowgemm
