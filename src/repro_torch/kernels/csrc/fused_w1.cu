// K1 · gather-fused grouped GEMM with an activation (and GLU) epilogue:
//     h[t] = x[row_src[t]] @ w1[tile_expert[t]]      for every 128-row tile t
//     u[t] = act(h[t])            or  act(h[t]) * (x[row_src[t]] @ w1g[e])
// and, with save_preact, h (and hg) too.
//
// Replaces the TPU kernel src/repro/kernels/cvmm.py:cvmm_fused_w1_pallas
// (_fused_w1_body, _k_w1{,_save,_glu,_glu_save}).
//
// The TPU kernel streams the unsorted rows HBM->VMEM through DMA chunks
// (run_start/run_off), because its copies need static shapes. Here the
// producer warpgroup of row_gemm.cuh's persistent wgmma mainloop
// (row_gemm_wgmma, shared with K4) copies each item's 128 A rows straight
// through row_src with 16-byte cp.async, swizzled by hand (TMA cannot
// gather rows), and its first thread loads the weight slices by TMA; a
// sentinel row is stored as zeros and never read, so the port's plan
// needs no chunk table. The backward pass reuses this kernel with the
// identity activation for t0 = gather(dy) @ w2^T, given a contiguous copy
// of w2 transposed.
//
// What bounds it on an H100: at wt103-47m-moe's training shape (8,224
// tokens x top-4 = 32,896 routed rows, d_model 412 -> G 128, bf16), forward
// with h saved, the function must move 25.4 MB (x 6.8 MB, weights 1.7 MB,
// u and h 8.4 MB each, row_src 0.13 MB) for 3.5 GFLOP: bytes bound it,
// 7.6 us at the H100 SXM data sheet's 3.35 TB/s against 3.5 us at its
// 989 TFLOP/s (both at the 700 W limit). The kernel works on the padded
// layout (K_pad 512, M_pad 34,944 rows: 273 items of 128 x 128, about two
// for each of the 132 SMs), which the bound does not count. With so few
// items a block's fixed cost weighs heavily, so the blocks are persistent:
// the ring's first fill is paid once per block, and each item's epilogue
// (the activation, chosen at compile time, GLU, h and hg, one rounding)
// is staged through shared memory and stored whole rows at a time while
// the producer fills the next item's stages. With GLU, items are 64
// columns wide so that both products' accumulators fit. float32 keeps
// row_gemm_f32 (plain FMAs, no TF32). Not done: skipping all-slack tiles.
#include "row_gemm.cuh"

using namespace rowgemm;

template <bool GLU, bool SAVE>
static cudaError_t launch(const void* x, const int* rs, int n_rows, const int* te,
                          const void* w1, const void* w1g, void* u, void* h, void* hg,
                          int m_pad, int k_pad, int g_pad, int n_experts, int act, int dtype,
                          int bn, int grid, cudaStream_t s) {
  if (dtype == 1)
    return launch_wgmma<true, GLU, SAVE>(
        bn, grid, static_cast<const bf16*>(x), rs, n_rows, te, static_cast<const bf16*>(w1),
        static_cast<const bf16*>(w1g), nullptr, static_cast<bf16*>(u), static_cast<bf16*>(h),
        static_cast<bf16*>(hg), m_pad, k_pad, g_pad, n_experts, act, s);
  dim3 grid2(g_pad / fp::BN, m_pad / fp::BM);
  row_gemm_f32<true, GLU, SAVE, false><<<grid2, fp::THREADS, 0, s>>>(
      static_cast<const float*>(x), rs, n_rows, te, static_cast<const float*>(w1),
      static_cast<const float*>(w1g), nullptr, static_cast<float*>(u),
      static_cast<float*>(h), static_cast<float*>(hg), k_pad, g_pad, n_experts, act);
  return cudaGetLastError();
}

// x (n_rows, K_pad); row_src (M_pad,) int32; tile_expert (M_pad/128,) int32;
// w1, w1g (E, K_pad, G_pad); u, h, hg (M_pad, G_pad). GLU iff w1g is given,
// save_preact iff h is given (and hg with GLU). act: 0 identity, 1 relu,
// 2 gelu (tanh), 3 silu. dtype: 0 float32, 1 bfloat16. bn and grid (bf16
// only): the item width and the persistent grid of kernels/cvmm.py's
// row_gemm_schedule. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int repro_fused_w1(const void* x, const void* row_src, const void* tile_expert,
                              const void* w1, const void* w1g, void* u, void* h, void* hg,
                              int n_rows, int m_pad, int k_pad, int g_pad, int n_experts,
                              int act, int dtype, int bn, int grid, void* stream) {
  const bool glu = w1g != nullptr, save = h != nullptr;
  if (m_pad <= 0 || m_pad % TM || k_pad <= 0 || k_pad % 128 || g_pad <= 0 || g_pad % 128 ||
      n_experts <= 0 || act < 0 || act > 3 || (dtype != 0 && dtype != 1) ||
      (save && glu && hg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* rs = static_cast<const int*>(row_src);
  const int* te = static_cast<const int*>(tile_expert);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (glu && save)
    err = launch<true, true>(x, rs, n_rows, te, w1, w1g, u, h, hg, m_pad, k_pad, g_pad,
                             n_experts, act, dtype, bn, grid, s);
  else if (glu)
    err = launch<true, false>(x, rs, n_rows, te, w1, w1g, u, h, hg, m_pad, k_pad, g_pad,
                              n_experts, act, dtype, bn, grid, s);
  else if (save)
    err = launch<false, true>(x, rs, n_rows, te, w1, w1g, u, h, hg, m_pad, k_pad, g_pad,
                              n_experts, act, dtype, bn, grid, s);
  else
    err = launch<false, false>(x, rs, n_rows, te, w1, w1g, u, h, hg, m_pad, k_pad, g_pad,
                               n_experts, act, dtype, bn, grid, s);
  return static_cast<int>(err);
}

// The shared memory of the bf16 instance for items bn wide with GLU and
// save_preact as given, as repro_cvmm_smem.
extern "C" int repro_fused_w1_smem(int bn, int glu, int save, int* dynamic, int* stat) {
  cudaError_t err;
  if (glu && save)
    err = smem_wgmma<true, true, true>(bn, dynamic, stat);
  else if (glu)
    err = smem_wgmma<true, true, false>(bn, dynamic, stat);
  else if (save)
    err = smem_wgmma<true, false, true>(bn, dynamic, stat);
  else
    err = smem_wgmma<true, false, false>(bn, dynamic, stat);
  return static_cast<int>(err);
}
