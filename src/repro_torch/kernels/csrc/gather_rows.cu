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
// multiple of 128 and every row is a multiple of 16 bytes.
//
// What bounds it on an H100: pure data movement, with no arithmetic to speak
// of. It must read each routed row once and write every output row once;
// at the serving decode shape (n <= 64 token rows of 1536 bf16 into a
// 128-row tile) that is under 0.5 MB, so a call is bound by launch latency
// long before it is bound by bytes.
//
// Design: the TPU version streams rows through VMEM with DMA chunk tables
// (ops._plan_runs), because its copies need static shapes. Here each block
// takes one 128-row output tile and each warp copies whole rows with 16-byte
// vector loads and stores straight from row_src, neighbouring lanes on
// neighbouring addresses; sentinel rows are written as zeros without a read.
// The weighted form multiplies in float32 and rounds once, as the reference
// does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;
constexpr int THREADS = 256;

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const T* __restrict__ x, const int* __restrict__ row_src,
                   const float* __restrict__ weight, T* __restrict__ out, int n_rows,
                   int k_pad) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = k_pad * (int)sizeof(T) / 16;
  for (int r = warp; r < TM; r += THREADS / 32) {
    const size_t slot = (size_t)blockIdx.x * TM + r;
    const int src = row_src[slot];
    uint4* dst = reinterpret_cast<uint4*>(out + slot * k_pad);
    if (src < 0 || src >= n_rows) {
      for (int v = lane; v < nvec; v += 32) dst[v] = make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint4* s = reinterpret_cast<const uint4*>(x + (size_t)src * k_pad);
    if (weight != nullptr) {
      const float wt = weight[slot];
      for (int v = lane; v < nvec; v += 32)
        dst[v] = scale_vec(__ldg(s + v), wt, static_cast<T*>(nullptr));
    } else {
      for (int v = lane; v < nvec; v += 32) dst[v] = __ldg(s + v);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; weight may be null. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape the
// kernel does not take).
extern "C" int repro_gather_rows(const void* x, const void* row_src, const void* weight,
                                 void* out, int n_rows, int m_pad, int k_pad, int dtype,
                                 void* stream) {
  const int elem = dtype == 1 ? 2 : 4;
  if (m_pad <= 0 || m_pad % TM || k_pad <= 0 || (k_pad * elem) % 16 || n_rows < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(m_pad / TM);
  if (dtype == 1) {
    gather_rows_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(row_src),
        static_cast<const float*>(weight), static_cast<__nv_bfloat16*>(out), n_rows,
        k_pad);
  } else {
    gather_rows_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(row_src),
        static_cast<const float*>(weight), static_cast<float*>(out), n_rows, k_pad);
  }
  return static_cast<int>(cudaGetLastError());
}
