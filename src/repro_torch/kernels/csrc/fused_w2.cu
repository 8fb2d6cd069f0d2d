// K2 · grouped GEMM with the per-row gate multiply in the epilogue:
//     y[t] = (u[t] @ w2[tile_expert[t]]) * gate[t]     for every 128-row tile t
// accumulated in float32, scaled by the float32 gate, rounded once.
//
// Replaces the TPU kernel src/repro/kernels/cvmm.py:cvmm_fused_w2_pallas
// (_fused_w2_kernel).
//
// The WMMA row-tile loop of row_gemm.cuh (row_gemm_bf16: tile-aligned
// rows, no gather; K1 and K4 run its persistent wgmma mainloop) with the gate
// in the epilogue, so the forward never makes a separate pass for
// y * gate. The scatter-add of y back to the tokens stays outside.
//
// What bounds it on an H100: at wt103-47m-moe's training shape (32,896
// routed rows, G 128 -> d_model 412, bf16) the function must move 37.4 MB
// (u 8.4 MB, weights 1.7 MB, y 27.1 MB, gates 0.13 MB) for 3.5 GFLOP:
// bytes bound it, 11.2 us at the H100 SXM data sheet's 3.35 TB/s (700 W
// limit). The kernel works on the padded layout (M_pad 34,944 rows, N_pad
// 512), which the bound does not count. Not done yet: wgmma, TMA, skipping
// all-slack tiles.
#include "row_gemm.cuh"

using namespace rowgemm;

// u (M_pad, G_pad); tile_expert (M_pad/128,) int32; w2 (E, G_pad, N_pad);
// gate (M_pad,) float32; y (M_pad, N_pad). dtype: 0 float32, 1 bfloat16.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int repro_fused_w2(const void* u, const void* tile_expert, const void* w2,
                              const void* gate, void* y, int m_pad, int g_pad, int n_pad,
                              int n_experts, int dtype, void* stream) {
  if (m_pad <= 0 || m_pad % TM || g_pad <= 0 || g_pad % 128 || n_pad <= 0 || n_pad % 128 ||
      n_experts <= 0 || gate == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* te = static_cast<const int*>(tile_expert);
  const float* g = static_cast<const float*>(gate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid(n_pad / 128, m_pad / tc::BM);
    row_gemm_bf16<128, false, false, false, true><<<grid, tc::THREADS, 0, s>>>(
        static_cast<const bf16*>(u), nullptr, m_pad, te, static_cast<const bf16*>(w2),
        nullptr, g, static_cast<bf16*>(y), nullptr, nullptr, g_pad, n_pad, n_experts,
        kIdentity);
  } else if (dtype == 0) {
    dim3 grid(n_pad / fp::BN, m_pad / fp::BM);
    row_gemm_f32<false, false, false, true><<<grid, fp::THREADS, 0, s>>>(
        static_cast<const float*>(u), nullptr, m_pad, te, static_cast<const float*>(w2),
        nullptr, g, static_cast<float*>(y), nullptr, nullptr, g_pad, n_pad, n_experts,
        kIdentity);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
