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
// What bounds it on an H100 (bf16; 3.35 TB/s and 989 TFLOP/s, the SXM data
// sheet at 700 W):
//   serving decode (M_pad 5,120 = 40 experts x one tile, 1,536 -> 512 or
//     512 -> 1,536): bytes. It must move 84 MB (the weights alone 63 MB)
//     for 8 GFLOP: 0.025 ms against 0.008 ms. The grid is small (160 items
//     of 128 x 128 for w1 on 132 SMs), so each SM needs many bytes in
//     flight to reach HBM's rate.
//   serve-long's prefill chunk (M_pad 81,920 = 40 x 2,048 rows, the same
//     widths): operations, 129 GFLOP in 0.130 ms, with the bytes (399 MB,
//     0.119 ms) close behind; with 128 x 128 items the blocks would read
//     2 GB from L2.
//   training (M_pad 34,944, K_pad 128 or 512): bytes, about 0.011 ms; the
//     dX call's K_pad 128 is only two 64-deep slices, so a block's fixed
//     cost (the ring's first fill, the epilogue) is most of its time.
//
// Design: bf16 runs the persistent, warp-specialised wgmma mainloop of
// row_gemm.cuh (row_gemm_wgmma, shared with K1) with tile-aligned rows, no
// activation and no gate. About one block per SM walks (128-row tile,
// column block) items; one producer thread keeps a ring of 64-deep slices
// full by TMA (32-48 KB a stage, 3-5 stages in flight) and runs on into
// the next item, so a block's first fill is paid once per launch, not once
// per item, and each item's epilogue overlaps the next item's loads.
// Items are 256 columns wide at the prefill chunk (half the L2 reads of
// 128), 128 or 64 where wider ones would leave the SMs fewer than two
// each (decode's w1). float32 keeps row_gemm_f32 (plain FMAs, no TF32).
// Not done: skipping slack tiles that hold no routed row (the kernel
// cannot tell them from tile_expert), thread-block clusters sharing a
// weight slice by TMA multicast.
#include "row_gemm.cuh"

using namespace rowgemm;

// dtype: 0 = float32, 1 = bfloat16. bn and grid (bf16 only): the item width
// and the persistent grid of kernels/cvmm.py's row_gemm_schedule. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// the kernels do not take).
extern "C" int repro_cvmm(const void* x, const void* tile_expert, const void* w,
                          void* out, int m_pad, int k_pad, int n_pad, int n_experts,
                          int dtype, int bn, int grid, void* stream) {
  if (m_pad <= 0 || m_pad % TM || k_pad <= 0 || k_pad % 128 || n_pad <= 0 ||
      n_pad % 128 || n_experts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* te = static_cast<const int*>(tile_expert);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(launch_wgmma<false, false, false>(
        bn, grid, static_cast<const bf16*>(x), nullptr, m_pad, te,
        static_cast<const bf16*>(w), nullptr, nullptr, static_cast<bf16*>(out), nullptr,
        nullptr, m_pad, k_pad, n_pad, n_experts, kIdentity, s));
  } else if (dtype == 0) {
    dim3 grid2(n_pad / fp::BN, m_pad / fp::BM);
    row_gemm_f32<false, false, false, false><<<grid2, fp::THREADS, 0, s>>>(
        static_cast<const float*>(x), nullptr, m_pad, te, static_cast<const float*>(w),
        nullptr, nullptr, static_cast<float*>(out), nullptr, nullptr, k_pad, n_pad,
        n_experts, kIdentity);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
