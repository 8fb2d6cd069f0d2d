// K5 · expert weight gradient of the unfused planned rung, both operands
// tile-aligned:
//     dW[e] = sum over the 128-row tiles t of expert e of  x_pad[t]^T g_pad[t]
// in float32, out (E, K_pad, N_pad).
//
// Replaces the TPU kernel src/repro/kernels/cvmm.py:cvmm_dw_pallas
// (_dw_kernel), the dW of the unfused rung's backward
// (src/repro/kernels/ops.py:_planned_bwd).
//
// The expert walk of dw_gemm.cuh (shared with K3) with neither operand
// gathered and no gate: the expert's tiles split into chunks of at most
// `chunk` tiles, one block per (chunk, 128 x 128 output block), combined
// in chunk order by the block that finishes an expert's output block last
// (no float atomics, the same bits on every call); zeros for an expert
// with no tiles. Slack rows, inside an expert's last tile and in the
// trailing slack tiles that _tile_layout clamps to the last expert, are
// zero in both operands by the layout contract, so they add nothing; every
// row read lies inside [0, M_pad).
//
// What bounds it on an H100: at wt103-47m-moe's training shape (32,896
// routed rows, 16 experts, d_model 412 x G 128, bf16) dW1 must move 38.9 MB
// (x 27.1 MB, the cotangent 8.4 MB, dW 3.4 MB in float32) for 3.5 GFLOP:
// bytes bound it, 11.6 us at the H100 SXM data sheet's 3.35 TB/s (700 W
// limit). The kernel reads the padded layout (M_pad 34,944 rows, K_pad
// 512), which the bound does not count. What the design does about it, as
// in K3: about 270 blocks of at most 5 tiles, so skew does not set the
// time; a 4-stage ring of 64-row stages keeps up to 128 KB of loads in
// flight per SM; wgmma on both operands in shared memory.
#include "dw_gemm.cuh"

using namespace dwgemm;

// x_pad (M_pad, K_pad) and g_pad (M_pad, N_pad) tile-aligned, in one dtype
// (0 float32, 1 bfloat16); tile_expert (M_pad/128,) int32, non-decreasing;
// out (E, K_pad, N_pad) float32, every element written; scratch, counters,
// chunk and slots as for repro_dw_streamed. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape the kernel does not
// take).
extern "C" int repro_cvmm_dw(const void* x_pad, const void* tile_expert, const void* g_pad,
                             void* out, void* scratch, void* counters, int m_pad, int k_pad,
                             int n_pad, int n_experts, int dtype, int chunk, int slots,
                             void* stream) {
  if (m_pad <= 0 || m_pad % TM || k_pad <= 0 || k_pad % 128 || n_pad <= 0 || n_pad % 128 ||
      n_experts <= 0 || n_experts > 65535 || (dtype != 0 && dtype != 1) || chunk <= 0 ||
      slots < n_slots(m_pad / TM, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<kAligned, false>(
      x_pad, g_pad, nullptr, m_pad, static_cast<const int*>(tile_expert), m_pad / TM, nullptr,
      static_cast<float*>(out), static_cast<float*>(scratch), static_cast<int*>(counters),
      k_pad, n_pad, n_experts, chunk, dtype, static_cast<cudaStream_t>(stream)));
}

// The shared memory of the bf16 instance (every chunk size launches the
// same one), as repro_cvmm_smem.
extern "C" int repro_cvmm_dw_smem(int* dynamic, int* stat) {
  return static_cast<int>(smem<kAligned, false>(dynamic, stat));
}
