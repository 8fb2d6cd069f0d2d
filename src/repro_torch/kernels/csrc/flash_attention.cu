// K7 · forward-only grouped-query attention with an online softmax:
//
//     out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / grp]) v[b, j, h / grp]
//
// over the keys j < min(Sk, kv_len[b]) and, when causal, j <= q_offset + i
// (grp = H / KV, the reference's _gqa_expand grouping). A row with no
// visible key is zero, as in the chunked flash_attention it replaces.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_kernel), with two masks added: q_offset, the
// absolute position of q[0] (a prefill chunk's start), and kv_len, the
// valid keys of each batch row, read on the device so the host never syncs.
//
// Layout: q (B, Sq, H, D), k and v (B, Sk, KV, D), out (B, Sq, H, D), all
// row-major and contiguous; H % KV == 0; kv_len (B,) int64 or null (= Sk);
// D in {16, 64, 128}.
//
// What bounds it on an H100: at the Engine's long-prompt prefill
// (granite-moe, a 256-row chunk at q_offset 1280 over 1536 valid keys, 24
// query heads on 8 KV heads of 64, bf16) the function needs 2.2 GFLOP and
// 4.7 MB: 0.0022 ms at 989 TFLOP/s against 0.0014 ms at 3.35 TB/s, so it is
// bound by operations, and a kernel must keep the score tile out of device
// memory to get near that.
//
// Design. The TPU kernel keeps a KV head's whole padded K and V resident;
// 1,536 keys of K and V at D 64 in bf16 are 393 KB, above the 227 KB of
// shared memory a block may use. So one block owns (batch, query head,
// 64-row query tile); its 4 warps own 16 rows each and stream 64-key tiles
// of K and V through a two-stage cp.async ring. bf16: Q K^T and P V run on
// tensor cores (mma.sync m16n8k16, float32 accumulation); the scores, the
// running max m, the sum l and the output stay in float32 registers, P goes
// from the score accumulators to bf16 operand registers without touching
// shared memory, and V's operand comes from ldmatrix.trans. The key loop
// stops at the last tile that a row of the block can see (kv_len and the
// causal diagonal, with the offset), the reference's diagonal skip. float32
// runs plain FMAs (no TF32) on 32-row tiles, so it keeps full float32
// accuracy. Not done yet: wgmma, TMA, warp specialisation, and splitting
// the keys over blocks (the prefill chunk above gives 96 blocks for 132 SMs).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

// Visible key count of block rows [q0, q_end): keys below min(Sk, kv_len[b])
// and, when causal, at or below position q_offset + q_end - 1.
__device__ __forceinline__ int valid_keys(int sk, const long long* kv_len, int b) {
  long long n = sk;
  if (kv_len) n = kv_len[b] < n ? kv_len[b] : n;
  return n < 0 ? 0 : static_cast<int>(n);
}
__device__ __forceinline__ int needed_keys(int kvl, int causal, int q_offset, int q_end) {
  if (!causal) return kvl;
  const long long lim = static_cast<long long>(q_offset) + q_end;
  return lim < 0 ? 0 : (lim < kvl ? static_cast<int>(lim) : kvl);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;  // 0: zero-fill the 16 bytes and read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A B for one 16x8x16 tile: A (16x16, row-major fragment), B (16x8,
// column fragment), D (16x8) in float32.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l names row
// l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// ---------------------------------------------------------------- bf16 path
namespace tc {
constexpr int BQ = 64;  // query rows per block: 4 warps x 16
constexpr int BK = 64;  // keys per streamed tile
// Shared rows are padded to D + 8 elements: conflict-free fragment loads.
template <int D>
constexpr int smem_bytes() { return (BQ + 4 * BK) * (D + 8) * 2; }  // Q + 2 x (K, V)
}  // namespace tc

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const long long* __restrict__ kv_len,
               bf16* __restrict__ out, int sq, int sk, int h, int kvh, float scale_log2,
               int causal, int q_offset) {
  using namespace tc;
  constexpr int LD = D + 8;
  constexpr int KT = D / 16;   // k-steps of Q K^T
  constexpr int NT = BK / 8;   // 8-key column tiles of S
  constexpr int DT = D / 8;    // 8-wide column tiles of O
  constexpr int CH = D / 8;    // 16-byte chunks in one row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + BQ * LD;
  bf16* v_s = k_s + 2 * BK * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const size_t q_stride = static_cast<size_t>(h) * D;    // between positions
  const size_t kv_stride = static_cast<size_t>(kvh) * D;
  const bf16* qb = q + static_cast<size_t>(b) * sq * q_stride + static_cast<size_t>(hh) * D;
  const size_t kv_off = static_cast<size_t>(b) * sk * kv_stride +
                        static_cast<size_t>(hh / (h / kvh)) * D;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  const int kvl = valid_keys(sk, kv_len, b);
  const int q_end = min(q0 + BQ, sq);
  const int n_tiles = (needed_keys(kvl, causal, q_offset, q_end) + BK - 1) / BK;

  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = q0 + r < sq;
    cp_async16(q_s + r * LD + c, qb + (ok ? q0 + r : 0) * q_stride + c, ok);
  }
  // Keys at or past kv_len are masked; their rows are zero-filled, not read.
  auto load_kv = [&](int tile, int stage) {
    bf16* ks = k_s + stage * BK * LD;
    bf16* vs = v_s + stage * BK * LD;
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const int key = tile * BK + r;
      const bool ok = key < kvl;
      const size_t off = (ok ? key : 0) * kv_stride + c;
      cp_async16(ks + r * LD + c, kb + off, ok);
      cp_async16(vs + r * LD + c, vb + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[KT][4];
  {
    const bf16* qw = q_s + warp * 16 * LD;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      qf[kt][0] = ld32(qw + g * LD + kt * 16 + 2 * t);
      qf[kt][1] = ld32(qw + (g + 8) * LD + kt * 16 + 2 * t);
      qf[kt][2] = ld32(qw + g * LD + kt * 16 + 8 + 2 * t);
      qf[kt][3] = ld32(qw + (g + 8) * LD + kt * 16 + 8 + 2 * t);
    }
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.0f, 0.0f};
  const int pos0 = q_offset + q0 + warp * 16 + g;  // this thread's rows: pos0, pos0 + 8

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = k_s + stage * BK * LD;
    const bf16* vs = v_s + stage * BK * LD;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kr = ks + (nt * 8 + g) * LD + kt * 16 + 2 * t;
        mma16816(s[nt], qf[kt], ld32(kr), ld32(kr + 8));
      }
    }

    // Scale into the exp2 domain and mask; the new running max per row
    // (rows g and g + 8 of the warp), reduced over the 4 lanes of a row.
    const int key0 = j * BK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t + (e & 1);
        const int pos = pos0 + (e >= 2 ? 8 : 0);
        const bool vis = key < kvl && (!causal || key <= pos);
        s[nt][e] = vis ? s[nt][e] * scale_log2 : neg_inf();
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == neg_inf() ? 0.0f : mx[r];  // a row with nothing visible yet
      const float corr = exp2f(m[r] - base[r]);
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * r] *= corr;
        o[dt][2 * r + 1] *= corr;
      }
    }

    // P = exp2(S - max): per-lane partial row sums in float32, and P as the
    // bf16 A operand of P V (the accumulator layout of two 8-key tiles is
    // the operand layout of one 16-key step).
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = exp2f(s[nt][0] - base[0]), p1 = exp2f(s[nt][1] - base[0]);
      const float p2 = exp2f(s[nt][2] - base[1]), p3 = exp2f(s[nt][3] - base[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD +
                                  dp * 16 + 8 * (lane / 16));
        mma16816(o[2 * dp], pf[kk], vf[0], vf[1]);
        mma16816(o[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / fmaxf(l[r], 1e-20f);
  }
  bf16* ob = out + static_cast<size_t>(b) * sq * q_stride + static_cast<size_t>(hh) * D;
  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * q_stride + col) =
          __floats2bfloat162_rn(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    if (r0 + 8 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (r0 + 8) * q_stride + col) =
          __floats2bfloat162_rn(o[dt][2] * inv[1], o[dt][3] * inv[1]);
  }
}

// ------------------------------------------------------------- float32 path
namespace fp {
constexpr int BQ = 32;  // query rows per block
constexpr int BK = 16;  // keys per tile
}  // namespace fp

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const long long* __restrict__ kv_len,
              float* __restrict__ out, int sq, int sk, int h, int kvh, float scale, int causal,
              int q_offset) {
  using namespace fp;
  constexpr int DJ = D / 4;  // output columns per thread
  __shared__ float q_s[BQ][D + 1];
  __shared__ float k_s[BK][D + 1];
  __shared__ float v_s[BK][D];
  __shared__ float p_s[BQ][BK + 1];
  __shared__ float m_s[BQ], l_s[BQ], c_s[BQ];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(kvh) * D;
  const float* qb = q + static_cast<size_t>(b) * sq * q_stride + static_cast<size_t>(hh) * D;
  const size_t kv_off = static_cast<size_t>(b) * sk * kv_stride +
                        static_cast<size_t>(hh / (h / kvh)) * D;
  const int kvl = valid_keys(sk, kv_len, b);
  const int q_end = min(q0 + BQ, sq);
  const int n_tiles = (needed_keys(kvl, causal, q_offset, q_end) + BK - 1) / BK;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    q_s[r][c] = q0 + r < sq ? qb[(q0 + r) * q_stride + c] : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = neg_inf();
    l_s[tid] = 0.0f;
  }
  float acc[DJ];
#pragma unroll
  for (int jj = 0; jj < DJ; ++jj) acc[jj] = 0.0f;
  const int row = tid / 4;  // this thread's row; its columns are tid % 4 + 4 jj

  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * BK;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = key0 + r < kvl;
      const size_t off = kv_off + (ok ? key0 + r : 0) * kv_stride + c;
      k_s[r][c] = ok ? k[off] : 0.0f;
      v_s[r][c] = ok ? v[off] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int col = tid % 4 + 4 * i;
      float s = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(q_s[row][d], k_s[col][d], s);
      const int key = key0 + col;
      const bool vis = key < kvl && (!causal || key <= q_offset + q0 + row);
      p_s[row][col] = vis ? s * scale : neg_inf();
    }
    __syncthreads();
    if (tid < BQ) {
      float mx = m_s[tid];
      for (int c = 0; c < BK; ++c) mx = fmaxf(mx, p_s[tid][c]);
      const float base = mx == neg_inf() ? 0.0f : mx;
      float sum = 0.0f;
      for (int c = 0; c < BK; ++c) {
        const float p = expf(p_s[tid][c] - base);
        p_s[tid][c] = p;
        sum += p;
      }
      const float corr = expf(m_s[tid] - base);
      c_s[tid] = corr;
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = mx;
    }
    __syncthreads();
    const float corr = c_s[row];
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int col = tid % 4 + 4 * jj;
      float a = acc[jj] * corr;
#pragma unroll
      for (int c = 0; c < BK; ++c) a = fmaf(p_s[row][c], v_s[c][col], a);
      acc[jj] = a;
    }
  }
  __syncthreads();
  if (q0 + row < sq) {
    const float inv = 1.0f / fmaxf(l_s[row], 1e-20f);
    float* orow = out + static_cast<size_t>(b) * sq * q_stride + (q0 + row) * q_stride +
                  static_cast<size_t>(hh) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) orow[tid % 4 + 4 * jj] = acc[jj] * inv;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const long long* kv_len, void* out,
           int b, int sq, int sk, int h, int kvh, float scale, int causal, int q_offset,
           int dtype, cudaStream_t s) {
  if (dtype == 1) {
    constexpr int bytes = tc::smem_bytes<D>();
    // Above 48 KB (D 128) only once opted in, on the current device.
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((sq + tc::BQ - 1) / tc::BQ, h, b);
    flash_fwd_bf16<D><<<grid, THREADS, bytes, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        kv_len, static_cast<bf16*>(out), sq, sk, h, kvh, scale * LOG2E, causal, q_offset);
  } else if (dtype == 0) {
    dim3 grid((sq + fp::BQ - 1) / fp::BQ, h, b);
    flash_fwd_f32<D><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), kv_len, static_cast<float*>(out), sq, sk, h, kvh, scale,
        causal, q_offset);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_len: (B,) int64 on the device, or
// null for Sk. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or head size the kernels do not take).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     const void* kv_len, void* out, int b, int sq, int sk,
                                     int h, int kvh, int d, float scale, int causal,
                                     int q_offset, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h <= 0 || h % kvh || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* kl = static_cast<const long long*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, kl, out, b, sq, sk, h, kvh, scale, causal, q_offset, dtype, s);
    case 64:
      return launch<64>(q, k, v, kl, out, b, sq, sk, h, kvh, scale, causal, q_offset, dtype, s);
    case 128:
      return launch<128>(q, k, v, kl, out, b, sq, sk, h, kvh, scale, causal, q_offset, dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
