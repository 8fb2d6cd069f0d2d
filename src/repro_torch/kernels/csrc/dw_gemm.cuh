// Expert weight-gradient walk shared by K3 (dw_streamed.cu) and K5
// (cvmm_dw.cu):
//
//     dW[e] = sum over the 128-row plan tiles t of expert e of  A[t]^T B[t]
//
// in float32, out (E, K_pad, N_pad), every element written.
//
// OPERANDS says where the rows of A (rows x K_pad) and B (rows x N_pad) come
// from:
//   kAligned  both tile-aligned (M_pad rows), read row by row; slack rows
//             are zero in both by the layout contract, so they add nothing
//             (K5, the unfused rung's dW);
//   kGatherA  A is the unsorted (n_rows, K_pad) array read through row_src,
//             B tile-aligned (K3 stream_x: dW1, dW1g);
//   kGatherB  A tile-aligned, B the unsorted (n_rows, N_pad) array read
//             through row_src, each row optionally scaled by gate[r] in
//             float32 and rounded back to B's type before the product, as
//             the reference does (K3 stream_g: dW2).
// With a gather, a sentinel row_src (outside [0, n_rows)) marks a slack
// slot: both of its operand rows are written as zeros and neither is read.
//
// The split. The TPU grid walks an expert's row tiles in order and sums in
// the output block. Here the tiles are cut into chunks of at most `chunk`
// consecutive tiles of one expert, at every multiple of `chunk` and at
// every expert's first tile, and one block takes one (chunk, output block)
// item, so the busiest expert costs more blocks, not a longer walk. Items
// per output block: item q < ceil(n_tiles / chunk) is the chunk starting at
// tile q * chunk; item ceil(n_tiles / chunk) + e is expert e's first chunk
// when that does not start on a multiple of `chunk`, or expert e's zeros
// when it has no tiles. Each block finds its item from tile_expert on the
// device (tile_expert does not decrease, so an expert's tiles are
// contiguous); items with nothing to do exit.
//
// The combine, deterministic and in the same launch. An expert of one
// chunk writes its output block directly. Otherwise each chunk writes its
// float32 partial into `scratch`, then adds one to an integer arrival
// counter of its (expert, output block); the block that arrives last sums
// the expert's partials in chunk order, writes the block, and resets the
// counter to 0. So every call gives the same bits whatever order the
// blocks run in, with no float atomics. Partial slots: chunk j of expert e
// (first tile lo) sits in slot 2 * (lo / chunk + j) for j > 0 and slot
// 2 * (lo / chunk) + (lo % chunk != 0) for j = 0; only one expert with
// several chunks starts inside any `chunk` tiles, so slots never collide,
// and 2 * ceil(n_tiles / chunk) of them suffice.
//
// bf16: warp-specialised. One producer warpgroup fills a ring of STAGES
// stages, each 64 rows of A's 128 columns and B's 128 columns of the
// output block, stored row-major with the 128-byte swizzle: gathered and
// aligned rows by cp.async, 16 bytes a thread, with the swizzle computed by
// hand (TMA has no row gather), and with GATE each gathered row through
// registers, scaled by its gate in float32 and rounded to bf16 on the way
// into shared memory. Two consumer warpgroups run wgmma m64n128k16 on both
// operands in shared memory (rows are the reduction, so A^T and B are both
// MN-major: the transpose bits), 64 output rows each, with full/empty
// mbarriers between the roles. float32 runs 64x64 output blocks on plain
// FMAs (no TF32) through the same split and combine. The PTX primitives
// (mbarriers, wgmma, descriptors) are hopper.cuh's, shared with K1 and K4.
#pragma once

#include "hopper.cuh"
#include "row_gemm.cuh"

namespace dwgemm {

using namespace hopper;
using rowgemm::bf16;
using rowgemm::valid_row;

constexpr int TM = rowgemm::TM;
enum Operands { kAligned = 0, kGatherA = 1, kGatherB = 2 };

// Rows of A and B behind padded row `row` whose row_src entry is `src`; ok
// is false for a sentinel slot.
struct Rows {
  size_t a, b;
  bool ok;
};
template <int OPERANDS>
__device__ __forceinline__ Rows operand_rows(int src, int n_rows, int row) {
  if (OPERANDS == kAligned) return {(size_t)row, (size_t)row, true};
  const bool ok = valid_row(src, n_rows);
  return OPERANDS == kGatherA ? Rows{(size_t)src, (size_t)row, ok}
                              : Rows{(size_t)row, (size_t)src, ok};
}

// ------------------------------------------------------------------ split
__host__ __device__ inline int n_chunks(int n_tiles, int chunk) {
  return (n_tiles + chunk - 1) / chunk;
}

// Sum of v over the block's threads, for every thread (all must call).
__device__ inline int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, n_warps = blockDim.x / 32;
  __syncthreads();  // red may hold an earlier sum
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  v = 0;
  for (int i = 0; i < n_warps; ++i) v += red[i];
  return v;
}

// One block's work: tiles [t0, t1) of expert e, its chunk k of count; e is
// -1 when the item has nothing to do, and t0 == t1 for an expert with no
// tiles (a block of zeros).
struct Item {
  int e, t0, t1, lo, k, count, slot0;
};

// Item q, found by all of the block's threads together (red: 32 ints of
// shared memory). Expert e's tiles are [lo, hi) with lo the count of
// tile_expert entries below e and hi of those up to e: one parallel pass
// over tile_expert, not a binary search of dependent loads.
__device__ inline Item find_item(const int* te, int n_tiles, int n_experts, int chunk, int q,
                                 int* red) {
  Item w = {-1, 0, 0, 0, 0, 1, 0};
  const int nb = n_chunks(n_tiles, chunk);
  if (q >= nb + n_experts) return w;
  const int e = q < nb ? te[q * chunk] : q - nb;
  if (e < 0 || e >= n_experts) return w;
  int below = 0, upto = 0;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    const int v = te[t];
    below += v < e;
    upto += v <= e;
  }
  const int lo = block_sum(below, red), hi = block_sum(upto, red);
  if (q < nb) {
    if (q * chunk < lo || q * chunk >= hi) return w;  // only if tile_expert decreased
    w.t0 = q * chunk;
    w.t1 = min(hi, w.t0 + chunk);
  } else {
    if (lo == hi) {
      w.e = e;
      return w;
    }
    if (lo % chunk == 0) return w;  // its first chunk is item lo / chunk
    w.t0 = lo;
    w.t1 = min(hi, (lo / chunk + 1) * chunk);
  }
  w.e = e;
  w.lo = lo;
  w.k = w.t0 / chunk - lo / chunk;
  w.count = (hi - 1) / chunk - lo / chunk + 1;
  w.slot0 = 2 * (lo / chunk) + (lo % chunk != 0);
  return w;
}

__device__ __forceinline__ int chunk_slot(const Item& w, int j, int chunk) {
  return j == 0 ? w.slot0 : 2 * (w.lo / chunk + j);
}

// The end of a block's item: NT threads hold NV float32 sums each (thread
// tid's v-th at index v * NT + tid of the block's partial), `store` writes
// such an array into the output block, `sync` is a barrier of the NT
// threads. A one-chunk expert stores directly; otherwise see "The combine":
// the last block reads every partial back, its own too, so each sum is the
// same chain of float32 additions whichever block comes last.
template <int NV, int NT, class Sync, class Store>
__device__ __forceinline__ void finish(float (&acc)[NV], const Item& w, int chunk, int ob,
                                       int n_ob, int tid, float* __restrict__ scratch,
                                       size_t slot_floats, int* __restrict__ counters,
                                       int* last_s, Sync sync, Store store) {
  if (w.count == 1) {
    store(acc);
    return;
  }
  const size_t part = (size_t)ob * NV * NT + tid;
  float* mine = scratch + (size_t)chunk_slot(w, w.k, chunk) * slot_floats + part;
#pragma unroll
  for (int v = 0; v < NV; ++v) __stcg(mine + v * NT, acc[v]);
  __threadfence();
  sync();
  if (tid == 0) {
    int* c = counters + (size_t)w.slot0 * n_ob + ob;
    const bool last = atomicAdd(c, 1) == w.count - 1;
    if (last) *c = 0;  // zero again for the next call
    *last_s = last;
  }
  sync();
  if (!*last_s) return;
  __threadfence();
  for (int j = 0; j < w.count; ++j) {
    const float* p = scratch + (size_t)chunk_slot(w, j, chunk) * slot_floats + part;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float x = __ldcg(p + v * NT);
      acc[v] = j ? acc[v] + x : x;
    }
  }
  store(acc);
}

// ---------------------------------------------------------------- bf16 path
namespace tc {
constexpr int BI = 128, BJ = 128;  // output block
constexpr int BR = 64;             // rows a stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;     // two warpgroups, 64 output rows each
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int NV = BI * BJ / CONSUMERS;   // accumulators a consumer thread
constexpr int HALF = BR * 128;     // bytes of [BR rows][64 columns] bf16
constexpr int OPERAND = 2 * HALF;  // an operand's 128 columns
constexpr int STAGE = 2 * OPERAND;  // A, then B
constexpr int SMEM = STAGES * STAGE + 1024;  // + aligning the ring to 1 KB
static_assert(TM % BR == 0, "stages never straddle two plan tiles");
static_assert(NV == 64, "one m64n128 accumulator a consumer thread");
}  // namespace tc

template <int OPERANDS, bool GATE>
__global__ void __launch_bounds__(tc::THREADS, 1)
dw_bf16(const bf16* __restrict__ a, const bf16* __restrict__ b,
        const int* __restrict__ row_src, int n_rows, const int* __restrict__ tile_expert,
        int n_tiles, const float* __restrict__ gate, float* __restrict__ out,
        float* __restrict__ scratch, int* __restrict__ counters, int k_pad, int n_pad,
        int n_experts, int chunk) {
  using namespace tc;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int red[32], last_s;

  const int tid = threadIdx.x;
  const int n_bj = n_pad / BJ, n_ob = (k_pad / BI) * n_bj;
  const int ob = blockIdx.x % n_ob;
  const int i0 = ob / n_bj * BI, j0 = ob % n_bj * BJ;
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Item w = find_item(tile_expert, n_tiles, n_experts, chunk, blockIdx.x / n_ob, red);
  if (w.e < 0) return;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 2 * 128);       // each producer thread's copies and stores
      mbar_init(&empty[s], CONSUMERS / 32);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_st = (w.t1 - w.t0) * (TM / BR);
  const int r0 = w.t0 * TM;

  if (tid < CONSUMERS) {
    // ------------------------------------------------------------ consumers
    const int wg = tid / 128, lane = tid % 32;
    float acc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] = 0.0f;
    for (int it = 0; it < n_st; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      fence_proxy_async();
      const uint32_t sa = ring + s * STAGE + wg * HALF, sb = ring + s * STAGE + OPERAND;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
        wgmma_m64n128k16<1>(acc, mn_sw128_desc(sa + kk * 16 * 128, HALF),
                         mn_sw128_desc(sb + kk * 16 * 128, HALF));
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one is read
      if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_operands(acc);

    // Accumulator v of thread tid: row 16 * warp + lane / 4 + 8 * (v / 2 % 2),
    // column 8 * (v / 4) + 2 * (lane % 4) + v % 2 of its warpgroup's 64 x 128.
    float* ob_out = out + (size_t)w.e * k_pad * n_pad + (size_t)(i0 + wg * 64) * n_pad + j0;
    const int row = (tid % 128) / 32 * 16 + lane / 4, col = 2 * (lane % 4);
    auto store = [&](const float(&d)[NV]) {
#pragma unroll
      for (int v = 0; v < NV; v += 2) {
        const int r = row + 8 * (v / 2 % 2), c = col + 8 * (v / 4);
        *reinterpret_cast<float2*>(ob_out + (size_t)r * n_pad + c) = make_float2(d[v], d[v + 1]);
      }
    };
    finish<NV, CONSUMERS>(acc, w, chunk, ob, n_ob, tid, scratch, (size_t)k_pad * n_pad,
                          counters, &last_s, [] { named_sync(1, CONSUMERS); }, store);
  } else {
    // ------------------------------------------------------------- producer
    // Thread p loads the 16-byte column chunk cc of rows rr + 8 i (i < 8) of
    // each stage; row r's chunk c sits at byte 128 r + 16 (c ^ r % 8) of its
    // 64-column half (the 128-byte swizzle), and r % 8 = rr for all its rows.
    const int p = tid - CONSUMERS;
    const int rr = p / 16, cc = p % 16;
    const int so = cc / 8 * HALF + rr * 128 + (((cc % 8) ^ rr) << 4);
    unsigned char* const ring_p = smem_raw + (ring - smem_u32(smem_raw));
    const bf16* ga = a + i0 + cc * 8;
    const bf16* gb = b + j0 + cc * 8;
    constexpr int ROWS = BR / 8;  // rows a thread loads of each operand a stage
    struct Fetch {
      int src[ROWS];
      uint4 v[ROWS];    // GATE: the gathered B rows
      float g[ROWS];    // and their gates
    };
    auto fetch = [&](int it, Fetch& f) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = r0 + it * BR + rr + 8 * i;
        f.src[i] = OPERANDS == kAligned ? row : row_src[row];
        if (GATE && valid_row(f.src[i], n_rows)) {
          f.v[i] = __ldg(reinterpret_cast<const uint4*>(gb + (size_t)f.src[i] * n_pad));
          f.g[i] = gate[row];
        }
      }
    };
    Fetch next;
    if (n_st > 0) fetch(0, next);
    for (int it = 0; it < n_st; ++it) {
      const Fetch cur = next;
      if (it + 1 < n_st) fetch(it + 1, next);  // in flight while this stage is stored
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
      unsigned char* const sa = ring_p + s * STAGE + so;
      unsigned char* const sb = sa + OPERAND;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = r0 + it * BR + rr + 8 * i;
        const Rows rw = operand_rows<OPERANDS>(cur.src[i], n_rows, row);
        if (rw.ok) {
          cp_async16(sa + i * 1024, ga + rw.a * k_pad);
          if (GATE) {  // dy row * gate in float32, rounded back to bf16
            uint4 v = cur.v[i];
            __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 f = __bfloat1622float2(h[q]);
              h[q] = __floats2bfloat162_rn(f.x * cur.g[i], f.y * cur.g[i]);
            }
            *reinterpret_cast<uint4*>(sb + i * 1024) = v;
          } else {
            cp_async16(sb + i * 1024, gb + rw.b * n_pad);
          }
        } else {
          *reinterpret_cast<uint4*>(sa + i * 1024) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(sb + i * 1024) = make_uint4(0, 0, 0, 0);
        }
      }
      cp_async_arrive(&full[s]);  // when the copies have landed
      mbar_arrive(&full[s]);      // the stores (release)
    }
  }
}

// ------------------------------------------------------------- float32 path
namespace fp {
constexpr int BI = 64, BJ = 64, BR = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
static_assert(TM % BR == 0, "slices never straddle two plan tiles");
}  // namespace fp

template <int OPERANDS, bool GATE>
__global__ void __launch_bounds__(fp::THREADS)
dw_f32(const float* __restrict__ a, const float* __restrict__ b,
       const int* __restrict__ row_src, int n_rows, const int* __restrict__ tile_expert,
       int n_tiles, const float* __restrict__ gate, float* __restrict__ out,
       float* __restrict__ scratch, int* __restrict__ counters, int k_pad, int n_pad,
       int n_experts, int chunk) {
  using namespace fp;
  __shared__ __align__(16) float a_s[BR][BI + 4];
  __shared__ __align__(16) float b_s[BR][BJ + 4];
  __shared__ int red[32], last_s;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n_bj = n_pad / BJ, n_ob = (k_pad / BI) * n_bj;
  const int ob = blockIdx.x % n_ob;
  const int i0 = ob / n_bj * BI, j0 = ob % n_bj * BJ;
  const Item w = find_item(tile_expert, n_tiles, n_experts, chunk, blockIdx.x / n_ob, red);
  if (w.e < 0) return;

  float acc[16] = {};  // rows ty * 4 + v / 4, columns tx * 4 + v % 4
  const int lr = tid / 16, lc = (tid % 16) * 4;  // 16 rows x 64 cols, one float4 each
  for (int r0 = w.t0 * TM; r0 < w.t1 * TM; r0 += BR) {
    const int row = r0 + lr;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    const Rows rw = operand_rows<OPERANDS>(OPERANDS == kAligned ? row : row_src[row], n_rows, row);
    if (rw.ok) {
      av = *reinterpret_cast<const float4*>(a + rw.a * k_pad + i0 + lc);
      bv = *reinterpret_cast<const float4*>(b + rw.b * n_pad + j0 + lc);
      if (GATE) {
        const float g = gate[row];
        bv = make_float4(bv.x * g, bv.y * g, bv.z * g, bv.w * g);
      }
    }
    *reinterpret_cast<float4*>(&a_s[lr][lc]) = av;
    *reinterpret_cast<float4*>(&b_s[lr][lc]) = bv;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = a_s[r][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = b_s[r][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(x[i], y[j], acc[i * 4 + j]);
    }
    __syncthreads();
  }
  float* ob_out = out + (size_t)w.e * k_pad * n_pad;
  auto store = [&](const float(&d)[16]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(ob_out + (size_t)(i0 + ty * 4 + i) * n_pad + j0 + tx * 4) =
          make_float4(d[i * 4], d[i * 4 + 1], d[i * 4 + 2], d[i * 4 + 3]);
  };
  finish<16, THREADS>(acc, w, chunk, ob, n_ob, tid, scratch, (size_t)k_pad * n_pad, counters,
                      &last_s, [] { __syncthreads(); }, store);
}

// Work items of one output block and partial slots of the split; the
// wrapper sizes the grid and the scratch from these.
inline int n_items(int n_tiles, int n_experts, int chunk) {
  return n_chunks(n_tiles, chunk) + n_experts;
}
inline int n_slots(int n_tiles, int chunk) { return 2 * n_chunks(n_tiles, chunk); }

// dtype: 0 float32, 1 bfloat16 (of a and b). The caller has checked the
// shapes (m_pad a multiple of TM, k_pad and n_pad multiples of 128) and
// the workspace: scratch n_slots * k_pad * n_pad floats, counters
// n_slots * (k_pad / 64) * (n_pad / 64) ints, zero.
template <int OPERANDS, bool GATE>
cudaError_t launch(const void* a, const void* b, const int* rs, int n_rows, const int* te,
                   int n_tiles, const float* gate, float* out, float* scratch, int* counters,
                   int k_pad, int n_pad, int n_experts, int chunk, int dtype, cudaStream_t s) {
  const long long items = n_items(n_tiles, n_experts, chunk);
  if (dtype == 1) {
    const long long blocks = items * (k_pad / tc::BI) * (n_pad / tc::BJ);
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    auto kern = dw_bf16<OPERANDS, GATE>;
    static bool smem_set[64] = {};  // per device, once: the call costs host time
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !smem_set[dev]) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM);
      if (err != cudaSuccess) return err;
      if (dev < 64) smem_set[dev] = true;
    }
    kern<<<static_cast<unsigned>(blocks), tc::THREADS, tc::SMEM, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), rs, n_rows, te, n_tiles,
        gate, out, scratch, counters, k_pad, n_pad, n_experts, chunk);
  } else {
    const long long blocks = items * (k_pad / fp::BI) * (n_pad / fp::BJ);
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    dw_f32<OPERANDS, GATE><<<static_cast<unsigned>(blocks), fp::THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), rs, n_rows, te, n_tiles,
        gate, out, scratch, counters, k_pad, n_pad, n_experts, chunk);
  }
  return cudaGetLastError();
}

}  // namespace dwgemm
