// Expert weight-gradient walk shared by K3 (dw_streamed.cu) and K5
// (cvmm_dw.cu):
//
//     dW[e] = sum over the 128-row plan tiles t of expert e of  A[t]^T B[t]
//
// in float32, out (E, K_pad, N_pad), every element written.
//
// OPERANDS says where the rows of A (rows x K_pad) and B (rows x N_pad) come
// from:
//   kAligned  both tile-aligned (M_pad rows), read row by row; slack rows
//             are zero in both by the layout contract, so they add nothing
//             (K5, the unfused rung's dW);
//   kGatherA  A is the unsorted (n_rows, K_pad) array read through row_src,
//             B tile-aligned (K3 stream_x: dW1, dW1g);
//   kGatherB  A tile-aligned, B the unsorted (n_rows, N_pad) array read
//             through row_src, each row optionally scaled by gate[r] in
//             float32 and rounded back to B's type before the product, as
//             the reference does (K3 stream_g: dW2).
// With a gather, a sentinel row_src (outside [0, n_rows)) marks a slack
// slot: both of its operand rows are written as zeros and neither is read.
//
// The TPU grid walks the row tiles sequentially and accumulates in the output
// block. Hopper blocks run in no order, so here one block owns one
// (expert, 128-row block of K_pad, 128-column block of N_pad) output block
// and walks that expert's tiles itself: tile_expert does not decrease, so
// they are contiguous, found by binary search, and every row read lies inside
// [0, M_pad). No atomics, no split-K. An expert with no tiles writes zeros.
// bf16 runs WMMA 16x16x16 with float accumulators over 32-row slices in a
// two-stage cp.async ring; float32 runs 64x64 output blocks on plain FMAs
// (no TF32).
#pragma once

#include "row_gemm.cuh"

namespace dwgemm {

using rowgemm::bf16;
using rowgemm::cp_async16;
using rowgemm::cp_async_commit;
using rowgemm::cp_async_wait;
using rowgemm::valid_row;

constexpr int TM = rowgemm::TM;
enum Operands { kAligned = 0, kGatherA = 1, kGatherB = 2 };

// First and one-past-last tile of expert e in the non-decreasing tile_expert.
__device__ inline void tile_range(const int* te, int n_tiles, int e, int* lo, int* hi) {
  int a = 0, b = n_tiles;
  while (a < b) {
    const int m = (a + b) / 2;
    if (te[m] < e) a = m + 1; else b = m;
  }
  *lo = a;
  b = n_tiles;
  while (a < b) {
    const int m = (a + b) / 2;
    if (te[m] <= e) a = m + 1; else b = m;
  }
  *hi = a;
}

// Rows of A and B behind padded row `row`; ok is false for a sentinel slot.
struct Rows {
  size_t a, b;
  bool ok;
};
template <int OPERANDS>
__device__ __forceinline__ Rows operand_rows(const int* row_src, int n_rows, int row) {
  if (OPERANDS == kAligned) return {(size_t)row, (size_t)row, true};
  const int src = row_src[row];
  const bool ok = valid_row(src, n_rows);
  return OPERANDS == kGatherA ? Rows{(size_t)src, (size_t)row, ok}
                              : Rows{(size_t)row, (size_t)src, ok};
}

// ---------------------------------------------------------------- bf16 path
namespace tc {
constexpr int BI = 128, BJ = 128, BR = 32;  // output 128 x 128, 32 rows a slice
constexpr int WARPS_I = 4, WARPS_J = 2;     // 8 warps, each 32 x 64
constexpr int THREADS = 32 * WARPS_I * WARPS_J;
constexpr int FI = BI / WARPS_I / 16, FJ = BJ / WARPS_J / 16;
constexpr int LD = 128 + 8;                 // padded rows, 32-B aligned fragments
constexpr int STAGE = BR * LD;
static_assert(TM % BR == 0, "slices never straddle two plan tiles");
}  // namespace tc

template <int OPERANDS, bool GATE>
__global__ void __launch_bounds__(tc::THREADS)
dw_bf16(const bf16* __restrict__ a, const bf16* __restrict__ b,
        const int* __restrict__ row_src, int n_rows, const int* __restrict__ tile_expert,
        int n_tiles, const float* __restrict__ gate, float* __restrict__ out, int k_pad,
        int n_pad) {
  using namespace nvcuda;
  using namespace tc;
  __shared__ __align__(128) bf16 a_s[2 * STAGE];
  __shared__ __align__(128) bf16 b_s[2 * STAGE];
  __shared__ int range[2];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wi = warp / WARPS_J, wj = warp % WARPS_J;
  const int e = blockIdx.z;
  const int i0 = blockIdx.y * BI, j0 = blockIdx.x * BJ;
  if (tid == 0) tile_range(tile_expert, n_tiles, e, &range[0], &range[1]);
  __syncthreads();
  const int r_begin = range[0] * TM;
  const int n_slices = (range[1] - range[0]) * (TM / BR);

  // One 32-row slice of both operands; sentinel rows are zeros in both.
  auto load = [&](int sl, int st) {
    bf16* as = a_s + st * STAGE;
    bf16* bs = b_s + st * STAGE;
#pragma unroll
    for (int i = 0; i < (BR * 128 / 8) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / 16, col = (c % 16) * 8;
      const Rows rw = operand_rows<OPERANDS>(row_src, n_rows, r_begin + sl * BR + r);
      if (rw.ok) {
        cp_async16(as + r * LD + col, a + rw.a * k_pad + i0 + col);
        cp_async16(bs + r * LD + col, b + rw.b * n_pad + j0 + col);
      } else {
        *reinterpret_cast<uint4*>(as + r * LD + col) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(bs + r * LD + col) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FI][FJ];
#pragma unroll
  for (int i = 0; i < FI; ++i)
#pragma unroll
    for (int j = 0; j < FJ; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (n_slices > 0) {
    load(0, 0);
    cp_async_commit();
  }
  for (int sl = 0; sl < n_slices; ++sl) {
    if (sl + 1 < n_slices) {
      load(sl + 1, (sl + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = a_s + (sl & 1) * STAGE;
    bf16* bs = b_s + (sl & 1) * STAGE;
    if (GATE) {  // dy row * gate in float32, rounded back to bf16
      for (int p = tid; p < BR * 64; p += THREADS) {
        const int r = p / 64, c = (p % 64) * 2;
        const float g = gate[r_begin + sl * BR + r];
        __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(bs + r * LD + c);
        const float2 f = __bfloat1622float2(*v);
        *v = __floats2bfloat162_rn(f.x * g, f.y * g);
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      // A^T: a col_major fragment of the row-major (rows x K) slice.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[FI];
#pragma unroll
      for (int i = 0; i < FI; ++i)
        wmma::load_matrix_sync(fa[i], as + kk * LD + wi * FI * 16 + i * 16, LD);
#pragma unroll
      for (int j = 0; j < FJ; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, bs + kk * LD + wj * FJ * 16 + j * 16, LD);
#pragma unroll
        for (int i = 0; i < FI; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  float* ob = out + (size_t)e * k_pad * n_pad;
#pragma unroll
  for (int i = 0; i < FI; ++i)
#pragma unroll
    for (int j = 0; j < FJ; ++j)
      wmma::store_matrix_sync(
          ob + (size_t)(i0 + wi * FI * 16 + i * 16) * n_pad + j0 + wj * FJ * 16 + j * 16,
          acc[i][j], n_pad, wmma::mem_row_major);
}

// ------------------------------------------------------------- float32 path
namespace fp {
constexpr int BI = 64, BJ = 64, BR = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
static_assert(TM % BR == 0, "slices never straddle two plan tiles");
}  // namespace fp

template <int OPERANDS, bool GATE>
__global__ void __launch_bounds__(fp::THREADS)
dw_f32(const float* __restrict__ a, const float* __restrict__ b,
       const int* __restrict__ row_src, int n_rows, const int* __restrict__ tile_expert,
       int n_tiles, const float* __restrict__ gate, float* __restrict__ out, int k_pad,
       int n_pad) {
  using namespace fp;
  __shared__ __align__(16) float a_s[BR][BI + 4];
  __shared__ __align__(16) float b_s[BR][BJ + 4];
  __shared__ int range[2];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int e = blockIdx.z;
  const int i0 = blockIdx.y * BI, j0 = blockIdx.x * BJ;
  if (tid == 0) tile_range(tile_expert, n_tiles, e, &range[0], &range[1]);
  __syncthreads();
  const int r_begin = range[0] * TM, r_end = range[1] * TM;

  float acc[4][4] = {};
  const int lr = tid / 16, lc = (tid % 16) * 4;  // 16 rows x 64 cols, one float4 each
  for (int r0 = r_begin; r0 < r_end; r0 += BR) {
    const int row = r0 + lr;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    const Rows rw = operand_rows<OPERANDS>(row_src, n_rows, row);
    if (rw.ok) {
      av = *reinterpret_cast<const float4*>(a + rw.a * k_pad + i0 + lc);
      bv = *reinterpret_cast<const float4*>(b + rw.b * n_pad + j0 + lc);
      if (GATE) {
        const float g = gate[row];
        bv = make_float4(bv.x * g, bv.y * g, bv.z * g, bv.w * g);
      }
    }
    *reinterpret_cast<float4*>(&a_s[lr][lc]) = av;
    *reinterpret_cast<float4*>(&b_s[lr][lc]) = bv;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = a_s[r][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = b_s[r][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* ob = out + (size_t)e * k_pad * n_pad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(ob + (size_t)(i0 + ty * 4 + i) * n_pad + j0 + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// dtype: 0 float32, 1 bfloat16 (of a and b). The caller has checked the
// shapes: m_pad a multiple of TM, k_pad and n_pad multiples of 128.
template <int OPERANDS, bool GATE>
void launch(const void* a, const void* b, const int* rs, int n_rows, const int* te,
            int n_tiles, const float* gate, float* out, int k_pad, int n_pad, int n_experts,
            int dtype, cudaStream_t s) {
  if (dtype == 1) {
    dim3 grid(n_pad / tc::BJ, k_pad / tc::BI, n_experts);
    dw_bf16<OPERANDS, GATE><<<grid, tc::THREADS, 0, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), rs, n_rows, te, n_tiles,
        gate, out, k_pad, n_pad);
  } else {
    dim3 grid(n_pad / fp::BJ, k_pad / fp::BI, n_experts);
    dw_f32<OPERANDS, GATE><<<grid, fp::THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), rs, n_rows, te, n_tiles,
        gate, out, k_pad, n_pad);
  }
}

}  // namespace dwgemm
