// K3 · expert weight gradient with one operand gathered from unsorted rows:
//     dW[e] = sum over the 128-row tiles t of expert e of  A[t]^T B[t]
// in float32, out (E, K_pad, N_pad).
//
// Replaces the TPU kernel src/repro/kernels/cvmm.py:cvmm_dw_streamed_pallas
// (_dw_stream_x_kernel, _dw_stream_g_kernel, _dw_stream_g_gate_kernel), and
// the zeroing of experts without rows that follows it there
// (src/repro/kernels/ops.py:_mask_empty).
//
//   stream_x = 1: A is the unsorted x (n_rows, K_pad) read through row_src,
//                 B the tile-aligned (M_pad, N_pad) cotangent  -> dW1, dW1g
//   stream_x = 0: A is tile-aligned (M_pad, K_pad), B the unsorted dy
//                 (n_rows, N_pad) read through row_src, each row scaled by
//                 gate[r] in float32 and rounded back to dy's type before the
//                 product, as the reference does                  -> dW2
//
// A sentinel row_src (outside [0, n_rows)) marks a slack slot: both of its
// operand rows are written as zeros and neither is read, so slack adds
// nothing, whatever the tile-aligned operand holds there.
//
// The TPU grid walks the row tiles sequentially and accumulates in the output
// block. Hopper blocks run in no order, so here one block owns one
// (expert, 128-row block of K_pad, 128-column block of N_pad) output block
// and walks that expert's tiles itself: tile_expert does not decrease, so
// they are contiguous, found by binary search. No atomics, no split-K. An
// expert with no tiles writes zeros. bf16 runs WMMA 16x16x16 with float
// accumulators over 32-row slices in a two-stage cp.async ring; float32 runs
// 64x64 output blocks on plain FMAs (no TF32).
//
// What bounds it on an H100: at wt103-47m-moe's training shape (8,224
// tokens x top-4 = 32,896 routed rows, 16 experts, d_model 412 x G 128,
// bf16) dW1 must move 18.7 MB (x 6.8 MB, the cotangent 8.4 MB, dW 3.4 MB in
// float32, row_src 0.13 MB) for 3.5 GFLOP: bytes bound it, 5.6 us at the
// H100 SXM data sheet's 3.35 TB/s (700 W limit). The kernel works on the
// padded layout (M_pad 34,944 rows, K_pad 512), which the bound does not
// count. This kernel
// sits far above that: 16 experts give 64 blocks of work for 132 SMs, and
// the block of the busiest expert, which walks the most tiles, sets the
// time (PERF.md). Split-K over tiles is for later.
#include "row_gemm.cuh"

using rowgemm::bf16;
using rowgemm::cp_async16;
using rowgemm::cp_async_commit;
using rowgemm::cp_async_wait;
using rowgemm::valid_row;

namespace {

constexpr int TM = rowgemm::TM;

// First and one-past-last tile of expert e in the non-decreasing tile_expert.
__device__ void tile_range(const int* te, int n_tiles, int e, int* lo, int* hi) {
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

template <bool STREAM_X, bool GATE>
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
      const int row = r_begin + sl * BR + r;
      const int src = row_src[row];
      if (valid_row(src, n_rows)) {
        const size_t ra = STREAM_X ? (size_t)src : (size_t)row;
        const size_t rb = STREAM_X ? (size_t)row : (size_t)src;
        cp_async16(as + r * LD + col, a + ra * k_pad + i0 + col);
        cp_async16(bs + r * LD + col, b + rb * n_pad + j0 + col);
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

template <bool STREAM_X, bool GATE>
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
    const int src = row_src[row];
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (valid_row(src, n_rows)) {
      const size_t ra = STREAM_X ? (size_t)src : (size_t)row;
      const size_t rb = STREAM_X ? (size_t)row : (size_t)src;
      av = *reinterpret_cast<const float4*>(a + ra * k_pad + i0 + lc);
      bv = *reinterpret_cast<const float4*>(b + rb * n_pad + j0 + lc);
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

template <bool STREAM_X, bool GATE>
void launch(const void* a, const void* b, const int* rs, int n_rows, const int* te,
            int n_tiles, const float* gate, float* out, int k_pad, int n_pad, int n_experts,
            int dtype, cudaStream_t s) {
  if (dtype == 1) {
    dim3 grid(n_pad / tc::BJ, k_pad / tc::BI, n_experts);
    dw_bf16<STREAM_X, GATE><<<grid, tc::THREADS, 0, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), rs, n_rows, te, n_tiles,
        gate, out, k_pad, n_pad);
  } else {
    dim3 grid(n_pad / fp::BJ, k_pad / fp::BI, n_experts);
    dw_f32<STREAM_X, GATE><<<grid, fp::THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), rs, n_rows, te, n_tiles,
        gate, out, k_pad, n_pad);
  }
}

}  // namespace

// stream_x = 1: x (n_rows, K_pad) unsorted, g (M_pad, N_pad) tile-aligned.
// stream_x = 0: x (M_pad, K_pad) tile-aligned, g (n_rows, N_pad) unsorted,
// gate (M_pad,) float32 or null. row_src (M_pad,) and tile_expert
// (M_pad/128,) int32; out (E, K_pad, N_pad) float32, every element written.
// dtype (of x and g): 0 float32, 1 bfloat16. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape the kernel does not
// take).
extern "C" int repro_dw_streamed(const void* x, const void* g, const void* row_src,
                                 const void* tile_expert, const void* gate, void* out,
                                 int n_rows, int m_pad, int k_pad, int n_pad, int n_experts,
                                 int stream_x, int dtype, void* stream) {
  if (m_pad <= 0 || m_pad % TM || k_pad <= 0 || k_pad % 128 || n_pad <= 0 || n_pad % 128 ||
      n_experts <= 0 || n_experts > 65535 || (dtype != 0 && dtype != 1) ||
      (stream_x && gate != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* rs = static_cast<const int*>(row_src);
  const int* te = static_cast<const int*>(tile_expert);
  const float* gt = static_cast<const float*>(gate);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = m_pad / TM;
  if (stream_x)
    launch<true, false>(x, g, rs, n_rows, te, n_tiles, gt, o, k_pad, n_pad, n_experts, dtype, s);
  else if (gt)
    launch<false, true>(x, g, rs, n_rows, te, n_tiles, gt, o, k_pad, n_pad, n_experts, dtype, s);
  else
    launch<false, false>(x, g, rs, n_rows, te, n_tiles, gt, o, k_pad, n_pad, n_experts, dtype, s);
  return static_cast<int>(cudaGetLastError());
}
