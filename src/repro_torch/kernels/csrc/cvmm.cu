// K4 · grouped GEMM over expert-pure row tiles:
//     out[t] = x_pad[t] @ w[tile_expert[t]]     for every 128-row tile t
//
// Replaces the TPU kernel src/repro/kernels/cvmm.py:cvmm_pallas (_fwd_kernel).
//
// Layout contract (kernels/ops.py): rows are sorted by expert and each
// expert's range is padded to a multiple of TM = 128, so every 128-row tile
// belongs to one expert. x_pad (M_pad, K_pad), w (E, K_pad, N_pad) and
// out (M_pad, N_pad) are row-major and contiguous; tile_expert is
// (M_pad / 128,) int32. K_pad and N_pad are multiples of 128.
//
// What bounds it on an H100: at the serving decode shape (M_pad = 40 * 128,
// 1536 -> 512, bf16) the weights are 40 x 1536 x 512 x 2 B = 63 MB per call
// against 16 MB of activations, and w1, w1g and w2 together are about
// 189 MB per layer: the kernel is bound by weight bytes (bytes / 3.35 TB/s
// exceeds flops / 989 TFLOP/s by about 3x).
//
// Design: one block per (128-row tile, 128-column block); the block reads its
// own tile_expert entry, so a weight block is read once per row tile that
// uses it and never for another expert. bf16 runs on the tensor cores through
// WMMA 16x16x16 fragments with float accumulators; 128x32 slices of x and
// 32x128 slices of w go through shared memory in a two-stage cp.async ring so
// the next slice's loads overlap this slice's MMAs. The result is rounded to
// bf16 once, in the epilogue. float32 runs on a plain FMA path (no TF32), so
// it keeps full float32 accuracy. Not done yet: wgmma, TMA, and skipping the
// slack tiles that hold no routed row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;  // plan row tile: every tile belongs to one expert

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

// ---------------------------------------------------------------- bf16 path
namespace tc {
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WARPS_M = 4, WARPS_N = 2;  // 8 warps, each a 32 x 64 sub-tile
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int FM = BM / WARPS_M / 16;  // 2 fragments down
constexpr int FN = BN / WARPS_N / 16;  // 4 fragments across
constexpr int A_LD = BK + 8;           // padded rows: fewer bank conflicts,
constexpr int B_LD = BN + 8;           // fragment pointers stay 32-B aligned
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
static_assert(BM == TM, "one block row == one plan tile");
}  // namespace tc

__global__ void __launch_bounds__(tc::THREADS)
cvmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const int* __restrict__ tile_expert,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ out, int k_pad, int n_pad,
                 int n_experts) {
  using namespace nvcuda;
  using namespace tc;
  __shared__ __align__(128) __nv_bfloat16 a_s[2 * A_STAGE];
  __shared__ __align__(128) __nv_bfloat16 b_s[2 * B_STAGE];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int e = tile_expert[blockIdx.y];

  if (e < 0 || e >= n_experts) {  // never in a valid plan; write zeros
    for (int i = tid; i < BM * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * n_pad + n0 + c) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const __nv_bfloat16* xa = x + (size_t)m0 * k_pad;
  const __nv_bfloat16* wb = w + (size_t)e * k_pad * n_pad + n0;

  auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    __nv_bfloat16* as = a_s + st * A_STAGE;
    __nv_bfloat16* bs = b_s + st * B_STAGE;
#pragma unroll
    for (int i = 0; i < (BM * BK / 8) / THREADS; ++i) {  // 128 x 32 slice of x
      const int c = tid + i * THREADS;
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      cp_async16(as + r * A_LD + col, xa + (size_t)r * k_pad + k0 + col);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN / 8) / THREADS; ++i) {  // 32 x 128 slice of w
      const int c = tid + i * THREADS;
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      cp_async16(bs + r * B_LD + col, wb + (size_t)(k0 + r) * n_pad + col);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

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
    const __nv_bfloat16* as = a_s + (kt & 1) * A_STAGE;
    const __nv_bfloat16* bs = b_s + (kt & 1) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * FM * 16 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * B_LD + wn * FN * 16 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  // Epilogue: each warp stages one 16x16 float fragment at a time, rounds it
  // to bf16 and writes it as 16-byte rows (two lanes per row).
  float* st = stage[warp];
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      __align__(16) __nv_bfloat162 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = __floats2bfloat162_rn(st[r * 16 + c + 2 * q], st[r * 16 + c + 2 * q + 1]);
      const int row = m0 + wm * FM * 16 + i * 16 + r;
      const int col = n0 + wn * FN * 16 + j * 16 + c;
      *reinterpret_cast<uint4*>(out + (size_t)row * n_pad + col) =
          *reinterpret_cast<const uint4*>(v);
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------- float32 path
namespace fp {
constexpr int BM = 64, BN = 64, BK = 16;  // BM divides TM
constexpr int THREADS = 256;              // 16 x 16 threads, 4 x 4 outputs each
static_assert(TM % BM == 0, "a block never straddles two plan tiles");
}  // namespace fp

__global__ void __launch_bounds__(fp::THREADS)
cvmm_f32_kernel(const float* __restrict__ x, const int* __restrict__ tile_expert,
                const float* __restrict__ w, float* __restrict__ out, int k_pad,
                int n_pad, int n_experts) {
  using namespace fp;
  __shared__ float a_s[BK][BM + 4];  // transposed slice of x
  __shared__ float b_s[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int e = tile_expert[m0 / TM];

  float acc[4][4] = {};
  if (e >= 0 && e < n_experts) {
    const float* wb = w + (size_t)e * k_pad * n_pad + n0;
    const int ar = tid / 4, ac = (tid % 4) * 4;    // x: 64 rows x 16 cols
    const int br = tid / 16, bc = (tid % 16) * 4;  // w: 16 rows x 64 cols
    for (int k0 = 0; k0 < k_pad; k0 += BK) {
      const float4 av =
          *reinterpret_cast<const float4*>(x + (size_t)(m0 + ar) * k_pad + k0 + ac);
      a_s[ac + 0][ar] = av.x;
      a_s[ac + 1][ar] = av.y;
      a_s[ac + 2][ar] = av.z;
      a_s[ac + 3][ar] = av.w;
      const float4 bv = *reinterpret_cast<const float4*>(wb + (size_t)(k0 + br) * n_pad + bc);
      b_s[br][bc + 0] = bv.x;
      b_s[br][bc + 1] = bv.y;
      b_s[br][bc + 2] = bv.z;
      b_s[br][bc + 3] = bv.w;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = a_s[k][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = b_s[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + (size_t)(m0 + ty * 4 + i) * n_pad + n0 + tx * 4) = v;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int repro_cvmm(const void* x, const void* tile_expert, const void* w,
                          void* out, int m_pad, int k_pad, int n_pad, int n_experts,
                          int dtype, void* stream) {
  if (m_pad <= 0 || m_pad % TM || k_pad <= 0 || k_pad % 128 || n_pad <= 0 ||
      n_pad % 128 || n_experts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid(n_pad / tc::BN, m_pad / tc::BM);
    cvmm_bf16_kernel<<<grid, tc::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(tile_expert),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out), k_pad,
        n_pad, n_experts);
  } else if (dtype == 0) {
    dim3 grid(n_pad / fp::BN, m_pad / fp::BM);
    cvmm_f32_kernel<<<grid, fp::THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(tile_expert),
        static_cast<const float*>(w), static_cast<float*>(out), k_pad, n_pad, n_experts);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
