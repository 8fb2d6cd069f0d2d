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
// The expert walk (dw_gemm.cuh, shared with K5): one block per (expert,
// 128 x 128 output block) walking the expert's contiguous tiles, no
// atomics; an expert with no tiles writes zeros.
//
// What bounds it on an H100: at wt103-47m-moe's training shape (8,224
// tokens x top-4 = 32,896 routed rows, 16 experts, d_model 412 x G 128,
// bf16) dW1 must move 18.7 MB (x 6.8 MB, the cotangent 8.4 MB, dW 3.4 MB in
// float32, row_src 0.13 MB) for 3.5 GFLOP: bytes bound it, 5.6 us at the
// H100 SXM data sheet's 3.35 TB/s (700 W limit). The kernel works on the
// padded layout (M_pad 34,944 rows, K_pad 512), which the bound does not
// count. This kernel sits far above that: 16 experts give 64 blocks of
// work for 132 SMs, and the block of the busiest expert, which walks the
// most tiles, sets the time (PERF.md). Split-K over tiles is for later.
#include "dw_gemm.cuh"

using namespace dwgemm;

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
    launch<kGatherA, false>(x, g, rs, n_rows, te, n_tiles, gt, o, k_pad, n_pad, n_experts, dtype, s);
  else if (gt)
    launch<kGatherB, true>(x, g, rs, n_rows, te, n_tiles, gt, o, k_pad, n_pad, n_experts, dtype, s);
  else
    launch<kGatherB, false>(x, g, rs, n_rows, te, n_tiles, gt, o, k_pad, n_pad, n_experts, dtype, s);
  return static_cast<int>(cudaGetLastError());
}
