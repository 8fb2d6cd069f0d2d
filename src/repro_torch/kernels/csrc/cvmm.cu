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
// Design: the row-tile GEMM of row_gemm.cuh (shared with K1 and K2) with
// tile-aligned rows, no activation and no gate: one block per (128-row tile,
// 128-column block) that reads its own tile_expert entry, so a weight block
// is read once per row tile that uses it and never for another expert; bf16
// on WMMA with a two-stage cp.async ring and one rounding in the epilogue,
// float32 on plain FMAs (no TF32). Not done yet: wgmma, TMA, and skipping
// the slack tiles that hold no routed row.
#include "row_gemm.cuh"

using namespace rowgemm;

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int repro_cvmm(const void* x, const void* tile_expert, const void* w,
                          void* out, int m_pad, int k_pad, int n_pad, int n_experts,
                          int dtype, void* stream) {
  if (m_pad <= 0 || m_pad % TM || k_pad <= 0 || k_pad % 128 || n_pad <= 0 ||
      n_pad % 128 || n_experts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* te = static_cast<const int*>(tile_expert);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid(n_pad / 128, m_pad / tc::BM);
    row_gemm_bf16<128, false, false, false, false><<<grid, tc::THREADS, 0, s>>>(
        static_cast<const bf16*>(x), nullptr, m_pad, te, static_cast<const bf16*>(w),
        nullptr, nullptr, static_cast<bf16*>(out), nullptr, nullptr, k_pad, n_pad,
        n_experts, kIdentity);
  } else if (dtype == 0) {
    dim3 grid(n_pad / fp::BN, m_pad / fp::BM);
    row_gemm_f32<false, false, false, false><<<grid, fp::THREADS, 0, s>>>(
        static_cast<const float*>(x), nullptr, m_pad, te, static_cast<const float*>(w),
        nullptr, nullptr, static_cast<float*>(out), nullptr, nullptr, k_pad, n_pad,
        n_experts, kIdentity);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
