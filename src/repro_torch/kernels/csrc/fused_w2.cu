// K2 · grouped GEMM with the per-row gate multiply in the epilogue:
//     y[t] = (u[t] @ w2[tile_expert[t]]) * gate[t]     for every 128-row tile t
// accumulated in float32, scaled by the float32 gate, rounded once.
//
// Replaces the TPU kernel src/repro/kernels/cvmm.py:cvmm_fused_w2_pallas
// (_fused_w2_kernel).
//
// What bounds it on an H100: at wt103-47m-moe's training shape (32,896
// routed rows, G 128 -> d_model 412, bf16) the function must move 37.4 MB
// (u 8.4 MB, weights 1.7 MB, y 27.1 MB, gates 0.13 MB) for 3.5 GFLOP:
// bytes bound it, 11.2 us at the H100 SXM data sheet's 3.35 TB/s (700 W
// limit). The kernel works on the padded layout (M_pad 34,944 rows, N_pad
// 512), which the bound does not count.
//
// Design: bf16 runs the persistent, warp-specialised wgmma mainloop of
// row_gemm.cuh (row_gemm_wgmma, shared with K1 and K4) with tile-aligned
// rows loaded by TMA, as K4 does, and the gate as a compile-time flag: the
// epilogue multiplies each float32 accumulator by its row's gate before
// the one rounding (a consumer thread holds rows r and r + 8 of each
// 16-row group, so it reads two gates an item), and the forward never
// makes a separate pass for y * gate. The gate is a template flag, not a
// runtime branch, because a per-element runtime choice in that epilogue
// cost 3x the mainloop (PERF.md). At the training shape the schedule
// (kernels/cvmm.py's row_gemm_schedule) gives 546 items of 256 columns on
// one block per SM. The scatter-add of y back to the tokens stays outside.
// float32 keeps row_gemm_f32 (plain FMAs, no TF32). Not done: skipping
// all-slack tiles.
#include "row_gemm.cuh"

using namespace rowgemm;

// u (M_pad, G_pad); tile_expert (M_pad/128,) int32; w2 (E, G_pad, N_pad);
// gate (M_pad,) float32; y (M_pad, N_pad). dtype: 0 float32, 1 bfloat16.
// bn and grid (bf16 only): the item width and the persistent grid of
// kernels/cvmm.py's row_gemm_schedule. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int repro_fused_w2(const void* u, const void* tile_expert, const void* w2,
                              const void* gate, void* y, int m_pad, int g_pad, int n_pad,
                              int n_experts, int dtype, int bn, int grid, void* stream) {
  if (m_pad <= 0 || m_pad % TM || g_pad <= 0 || g_pad % 128 || n_pad <= 0 || n_pad % 128 ||
      n_experts <= 0 || gate == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* te = static_cast<const int*>(tile_expert);
  const float* g = static_cast<const float*>(gate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(launch_wgmma<false, false, false, true>(
        bn, grid, static_cast<const bf16*>(u), nullptr, m_pad, te,
        static_cast<const bf16*>(w2), nullptr, g, static_cast<bf16*>(y), nullptr, nullptr,
        m_pad, g_pad, n_pad, n_experts, kIdentity, s));
  } else if (dtype == 0) {
    dim3 grid2(n_pad / fp::BN, m_pad / fp::BM);
    row_gemm_f32<false, false, false, true><<<grid2, fp::THREADS, 0, s>>>(
        static_cast<const float*>(u), nullptr, m_pad, te, static_cast<const float*>(w2),
        nullptr, g, static_cast<float*>(y), nullptr, nullptr, g_pad, n_pad, n_experts,
        kIdentity);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The shared memory of the bf16 instance for items bn wide, as
// repro_cvmm_smem.
extern "C" int repro_fused_w2_smem(int bn, int* dynamic, int* stat) {
  return static_cast<int>(smem_wgmma<false, false, false, true>(bn, dynamic, stat));
}
