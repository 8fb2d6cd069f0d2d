// Row-tile grouped GEMM shared by K1 (fused_w1.cu), K2 (fused_w2.cu) and
// K4 (cvmm.cu):
//
//     h[t] = A[t] @ w[tile_expert[t]]     for every 128-row plan tile t
//
// with an epilogue that applies an activation (and GLU), scales rows by a
// float32 gate, and writes u (and the pre-activations h, hg) rounded once.
//
// Layout contract (kernels/ops.py): every 128-row tile belongs to one
// expert; K_pad and N_pad are multiples of 128; all arrays row-major and
// contiguous. A is either tile-aligned (M_pad, K_pad), or, with GATHER, the
// unsorted (n_rows, K_pad) activations read through row_src: row r of the
// padded layout is A[row_src[r]], and a sentinel (any index outside
// [0, n_rows)) is a zero row that is never read.
//
// bf16: one block per (128-row tile, BN-column block), 8 warps of WMMA
// 16x16x16 fragments with float accumulators; 128x32 slices of A and 32xBN
// slices of w go through shared memory in a two-stage cp.async ring, so the
// next slice's loads overlap this slice's MMAs. With GLU a second weight
// (wg) is multiplied in the same pass and BN is 64, keeping the accumulator
// registers of the two products at the single product's count.
// float32: one block per (64-row, 64-column) output block, 16x16 threads
// with 4x4 outputs each on plain FMAs (no TF32), so it keeps full float32
// accuracy.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace rowgemm {

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ bool valid_row(int src, int n_rows) {
  return src >= 0 && src < n_rows;
}

// ---------------------------------------------------------------- bf16 path
namespace tc {
constexpr int BM = 128, BK = 32;
constexpr int WARPS_M = 4, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int A_LD = BK + 8;  // padded rows: fewer bank conflicts, and
constexpr int A_STAGE = BM * A_LD;  // fragment pointers stay 32-B aligned
static_assert(BM == TM, "one block row == one plan tile");
}  // namespace tc

using bf16 = __nv_bfloat16;
using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// Round one 16x16 float fragment to bf16 and write it to out (row-major,
// leading dimension ld) at (row0, col0); rows are scaled by gate[row] first
// when gate is given. The warp stages the fragment through st (256 floats).
__device__ __forceinline__ void store_frag(const AccFrag& f, float* st, bf16* out,
                                           int row0, int col0, int ld,
                                           const float* gate) {
  const int lane = threadIdx.x % 32;
  nvcuda::wmma::store_matrix_sync(st, f, 16, nvcuda::wmma::mem_row_major);
  __syncwarp();
  const int r = lane / 2, c = (lane % 2) * 8;
  const float s = gate ? gate[row0 + r] : 1.0f;
  __align__(16) __nv_bfloat162 v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = __floats2bfloat162_rn(st[r * 16 + c + 2 * q] * s, st[r * 16 + c + 2 * q + 1] * s);
  // One int row and column, then one 64-bit offset. Written as
  // (size_t)(row0 + r) * ld + col0 + c, the store compiled to code that made
  // K1, K2 and K4 1.3-1.6x slower at wt103-47m-moe's training shapes
  // (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
  const int row = row0 + r, col = col0 + c;
  *reinterpret_cast<uint4*>(out + (size_t)row * ld + col) = *reinterpret_cast<const uint4*>(v);
  __syncwarp();
}

template <int BN, bool GATHER, bool GLU, bool SAVE, bool GATE>
__global__ void __launch_bounds__(tc::THREADS)
row_gemm_bf16(const bf16* __restrict__ a, const int* __restrict__ row_src, int n_rows,
              const int* __restrict__ tile_expert, const bf16* __restrict__ w,
              const bf16* __restrict__ wg, const float* __restrict__ gate,
              bf16* __restrict__ out_u, bf16* __restrict__ out_h,
              bf16* __restrict__ out_hg, int k_pad, int n_pad, int n_experts, int act) {
  using namespace nvcuda;
  using namespace tc;
  constexpr int FM = BM / WARPS_M / 16;  // 2 fragments down
  constexpr int FN = BN / WARPS_N / 16;  // 4 (BN 128) or 2 (BN 64) across
  constexpr int B_LD = BN + 8;
  constexpr int B_STAGE = BK * B_LD;
  constexpr int NW = GLU ? 2 : 1;
  __shared__ __align__(128) bf16 a_s[2 * A_STAGE];
  __shared__ __align__(128) bf16 b_s[NW][2 * B_STAGE];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];
  __shared__ int src_s[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int e = tile_expert[blockIdx.y];

  if (e < 0 || e >= n_experts) {  // never in a valid plan; write zeros
    for (int i = tid; i < BM * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const size_t off = (size_t)(m0 + r) * n_pad + n0 + c;
      *reinterpret_cast<uint4*>(out_u + off) = make_uint4(0, 0, 0, 0);
      if (SAVE) *reinterpret_cast<uint4*>(out_h + off) = make_uint4(0, 0, 0, 0);
      if (SAVE && GLU) *reinterpret_cast<uint4*>(out_hg + off) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  if constexpr (GATHER) {
    for (int r = tid; r < BM; r += THREADS) src_s[r] = row_src[m0 + r];
    __syncthreads();
  }

  const size_t w_off = (size_t)e * k_pad * n_pad + n0;
  auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    bf16* as = a_s + st * A_STAGE;
#pragma unroll
    for (int i = 0; i < (BM * BK / 8) / THREADS; ++i) {  // 128 x 32 slice of A
      const int c = tid + i * THREADS;
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int src = GATHER ? src_s[r] : m0 + r;
      if (!GATHER || valid_row(src, n_rows))
        cp_async16(as + r * A_LD + col, a + (size_t)src * k_pad + k0 + col);
      else  // sentinel: a zero row, never read
        *reinterpret_cast<uint4*>(as + r * A_LD + col) = make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const bf16* wb = (q == 0 ? w : wg) + w_off;
      bf16* bs = b_s[q] + st * B_STAGE;
#pragma unroll
      for (int i = 0; i < (BK * BN / 8) / THREADS; ++i) {  // 32 x BN slice of w
        const int c = tid + i * THREADS;
        const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
        cp_async16(bs + r * B_LD + col, wb + (size_t)(k0 + r) * n_pad + col);
      }
    }
  };

  AccFrag acc[NW][FM][FN];
#pragma unroll
  for (int q = 0; q < NW; ++q)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[q][i][j], 0.0f);

  const int kt_n = k_pad / BK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    if (kt + 1 < kt_n) {
      load(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = a_s + (kt & 1) * A_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * FM * 16 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        const bf16* bs = b_s[q] + (kt & 1) * B_STAGE;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(fb[j], bs + kk * B_LD + wn * FN * 16 + j * 16, B_LD);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[q][i][j], fa[i], fb[j], acc[q][i][j]);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  // Epilogue: h (and hg) as they are, then u = act(h) [* hg] [* gate],
  // each rounded to bf16 once.
  float* st = stage[warp];
  const float* g = GATE ? gate : nullptr;
  const bool transform = GLU || act != kIdentity;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int row0 = m0 + wm * FM * 16 + i * 16;
      const int col0 = n0 + wn * FN * 16 + j * 16;
      if (SAVE) store_frag(acc[0][i][j], st, out_h, row0, col0, n_pad, nullptr);
      if (SAVE && GLU) store_frag(acc[NW - 1][i][j], st, out_hg, row0, col0, n_pad, nullptr);
      if (transform) {
#pragma unroll
        for (int t = 0; t < acc[0][i][j].num_elements; ++t) {
          float u = activate(acc[0][i][j].x[t], act);
          if (GLU) u *= acc[NW - 1][i][j].x[t];
          acc[0][i][j].x[t] = u;
        }
      }
      store_frag(acc[0][i][j], st, out_u, row0, col0, n_pad, g);
    }
  }
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
