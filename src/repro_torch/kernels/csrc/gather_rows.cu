// K6 · row gather into a tile-aligned block:
//     out[s] = x[row_src[s]]                    (zero on a sentinel)
//     out[s] = bf16/f32(float(x[row_src[s]]) * weight[s])   with weights
//
// Replaces the TPU kernel src/repro/kernels/cvmm.py:cvmm_gather_rows_pallas
// (_gather_rows_kernel and _gather_rows_weighted_kernel).
//
// x (N, K_pad) and out (M_pad, K_pad) are row-major and contiguous; row_src
// is (M_pad,) int32 with a sentinel (any index outside [0, N); the plans use
// N) on slack slots; weight, if given, is (M_pad,) float32. M_pad is a
// multiple of 128 and every row is a multiple of 16 bytes (K_pad 8 in bf16
// is one 16-byte vector a row).
//
// What bounds it on an H100: pure data movement, with no arithmetic to speak
// of. It must read each routed row once and write every output row once;
// at the serving decode shape (n <= 64 token rows of 1536 bf16 into a
// 128-row block, mostly sentinels) that is under 0.5 MB, at serve-long's
// prefill chunk (256 rows) 1.6 MB: a few microseconds' latency, not bytes,
// bounds a call, so the design is about how many copies are in flight at
// once across the card.
//
// Design: the TPU version streams rows through VMEM with DMA chunk tables
// (ops._plan_runs), because its copies need static shapes; here the copy is
// spread over the whole card. The grid is (group of rows, slice of a row's
// 16-byte vectors) with one warp per row slice: ROWS warps a block, each
// lane VPL vectors 32 apart, so neighbouring lanes touch neighbouring
// addresses. A warp reads its row's row_src entry once (one broadcast
// load), then each lane starts all of its loads before any of its stores,
// so every copy of the block is in flight at once; a sentinel row is
// stored as zeros without a read. kernels/cvmm.py's gather_rows_schedule
// picks ROWS and VPL from (M_pad, the row's bytes, the SM count) so that
// the decode gather (128 rows of 192 vectors in bf16) and the prefill
// chunk's (256 rows) each get on the order of 100-200 blocks. A slice
// never reads past its row: a lane whose vector lies beyond the row does
// nothing (at K_pad 8 in bf16, 31 of a warp's lanes). The weighted form
// multiplies in float32 and rounds once, as the reference does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;

__device__ __forceinline__ uint4 scale_vec(uint4 v, float s, float*) {
  float4 f = *reinterpret_cast<float4*>(&v);
  f.x *= s;
  f.y *= s;
  f.z *= s;
  f.w *= s;
  return *reinterpret_cast<uint4*>(&f);
}

__device__ __forceinline__ uint4 scale_vec(uint4 v, float s, __nv_bfloat16*) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    h[q] = __floats2bfloat162_rn(f.x * s, f.y * s);
  }
  return v;
}

// Block: ROWS warps, warp w copying output row blockIdx.x * ROWS + w;
// lane l moves vectors v0 + l + 32 i (i < VPL) of it, v0 = blockIdx.y *
// 32 * VPL.
template <typename T, int VPL>
__global__ void __launch_bounds__(256)
gather_rows_kernel(const T* __restrict__ x, const int* __restrict__ row_src,
                   const float* __restrict__ weight, T* __restrict__ out, int n_rows,
                   int m_pad, int nvec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = blockIdx.x * (blockDim.x / 32) + warp;
  if (slot >= m_pad) return;
  const int v0 = blockIdx.y * 32 * VPL + lane;
  const int src = row_src[slot];
  // One int row and column, then one 64-bit offset (PERF.md: a 64-bit
  // product of the sum cost the row-tile GEMMs 1.3-1.6x).
  uint4* const dst = reinterpret_cast<uint4*>(out) + (size_t)slot * nvec;
  if (src < 0 || src >= n_rows) {  // sentinel: zeros, never read
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = v0 + 32 * i;
      if (v < nvec) dst[v] = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const uint4* const s = reinterpret_cast<const uint4*>(x) + (size_t)src * nvec;
  uint4 buf[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {  // every load in flight before a store
    const int v = v0 + 32 * i;
    buf[i] = v < nvec ? __ldg(s + v) : make_uint4(0, 0, 0, 0);
  }
  if (weight != nullptr) {
    const float wt = weight[slot];
#pragma unroll
    for (int i = 0; i < VPL; ++i) buf[i] = scale_vec(buf[i], wt, static_cast<T*>(nullptr));
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = v0 + 32 * i;
    if (v < nvec) dst[v] = buf[i];
  }
}

template <typename T, int VPL>
void launch(const void* x, const int* rs, const float* wt, void* out, int n_rows, int m_pad,
            int nvec, int rows, cudaStream_t s) {
  const dim3 grid(m_pad / rows, (nvec + 32 * VPL - 1) / (32 * VPL));
  gather_rows_kernel<T, VPL><<<grid, 32 * rows, 0, s>>>(
      static_cast<const T*>(x), rs, wt, static_cast<T*>(out), n_rows, m_pad, nvec);
}

template <typename T>
void launch_vpl(const void* x, const int* rs, const float* wt, void* out, int n_rows,
                int m_pad, int nvec, int rows, int vpl, cudaStream_t s) {
  if (vpl == 1)
    launch<T, 1>(x, rs, wt, out, n_rows, m_pad, nvec, rows, s);
  else if (vpl == 2)
    launch<T, 2>(x, rs, wt, out, n_rows, m_pad, nvec, rows, s);
  else
    launch<T, 4>(x, rs, wt, out, n_rows, m_pad, nvec, rows, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; weight may be null. rows (1, 2, 4 or 8
// warps a block, one output row each) and vpl (1, 2 or 4 vectors a lane):
// kernels/cvmm.py's gather_rows_schedule. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int repro_gather_rows(const void* x, const void* row_src, const void* weight,
                                 void* out, int n_rows, int m_pad, int k_pad, int dtype,
                                 int rows, int vpl, void* stream) {
  const int elem = dtype == 1 ? 2 : 4;
  if (m_pad <= 0 || m_pad % TM || k_pad <= 0 || (k_pad * elem) % 16 || n_rows < 0 ||
      (dtype != 0 && dtype != 1) || (rows != 1 && rows != 2 && rows != 4 && rows != 8) ||
      (vpl != 1 && vpl != 2 && vpl != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = k_pad * elem / 16;
  if ((nvec + 32 * vpl - 1) / (32 * vpl) > 65535)  // grid.y's limit
    return static_cast<int>(cudaErrorInvalidValue);
  const int* rs = static_cast<const int*>(row_src);
  const float* wt = static_cast<const float*>(weight);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_vpl<__nv_bfloat16>(x, rs, wt, out, n_rows, m_pad, nvec, rows, vpl, s);
  else
    launch_vpl<float>(x, rs, wt, out, n_rows, m_pad, nvec, rows, vpl, s);
  return static_cast<int>(cudaGetLastError());
}
