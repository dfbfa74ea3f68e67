// Flash attention, forward, for Hopper (sm_90a): streaming softmax over
// key/value tiles with the running max, denominator and accumulator in
// IEEE float32; q, k, v and the output in float32 or bfloat16.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py: grid (BH, Sq/bq,
// Sk/bkv) with the KV axis innermost, (m, l, acc) carried in VMEM
// scratch across it, scale 1/sqrt(D), positional causal mask with
// NEG_INF = -1e30, output acc / max(l, 1e-30) cast to the input type.
// Here one block owns one (batch*head, 64-row query tile) and walks the
// KV tiles itself in a loop (blocks run in parallel on the SMs, so no
// state carries between them); (m, l, acc) live in registers.
//
// Inputs: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), contiguous, with
// Hq % Hkv == 0.  Grouped-query attention reads KV head
// h / (Hq / Hkv) directly: nothing is repeated in memory.  A query row
// i sits at position q_offset + i and, when causal, sees keys
// j <= q_offset + i.  Ragged tails of Sq and Sk are masked here (rows
// past Sq are not stored, keys past Sk get probability 0), and KV
// tiles wholly above the causal diagonal are skipped: they would add
// exact zeros.  Query tiles are walked last-first, so the blocks with
// the most KV tiles start first.
//
// Per block: 256 threads as a 16 x 16 grid.  Thread (ty, tx) owns
// score rows 4ty..4ty+3 and columns 4tx..4tx+3 of each 64 x 64 score
// tile, and output rows 4ty..4ty+3 at columns tx + 16c.  Q is staged
// once and K per tile transposed in shared memory (a thread reads its 4
// rows / 4 columns as one 16-byte load); V per tile row-major; the
// probabilities go through shared memory transposed for P @ V.  Row
// max and row sum reduce over the 16 threads of a row with warp
// shuffles.  Shared memory: (2 D (64 + 4) + 64 D + 64 (64 + 4)) floats,
// 119,808 bytes at D = 128 (so one block per SM), set with
// cudaFuncSetAttribute above the default 48 KB.
//
// What bounds it on an H100 SXM at the prefill shape of Qwen3-0.6B (4
// prompts x 4096 tokens, 16 query heads over 8 KV heads, D = 128, bf16,
// causal): the unmasked half of the work is 2.75e11 FLOP, about 0.28 ms
// at the data sheet's 989 TFLOP/s of bf16 tensor cores, while q, k, v
// and o are 201 MB, about 0.06 ms at 3.35 TB/s — so it is bound by
// operations.  IEEE float32 FMA cannot use the tensor cores (they round
// products to bf16/TF32 inputs), so this kernel's ceiling is the
// 67 TFLOP/s float32 rate, about 4.1 ms: it trades speed for the
// reference's numerics (f32 within 2e-5).  What the design does about
// the operations: it skips the masked KV tiles (half the work), keeps
// 8 FMA per 16-byte shared-memory load in the score loop, and reads
// each K/V tile once per 64 query rows.  No wgmma and no TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int PAD = 4;        // keeps transposed rows 16-byte aligned
constexpr int QLD = BQ + PAD;
constexpr int KLD = BKV + PAD;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Reduce over the 16 lanes of one score row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(D * QLD + D * KLD + BKV * D + BKV * QLD);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int hq,
                     int hkv, int sq, int sk, int causal, int q_offset,
                     float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int CPT = D / 16;  // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [D][QLD]   q transposed
  float* ks = qs + D * QLD;    // [D][KLD]   k transposed
  float* vs = ks + D * KLD;    // [BKV][D]
  float* ps = vs + BKV * D;    // [BKV][QLD] probabilities transposed

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const T* qb = q + (size_t)bh * sq * D;
  const T* kb = k + (size_t)kvh * sk * D;
  const T* vb = v + (size_t)kvh * sk * D;
  T* ob = o + (size_t)bh * sq * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int gr = q0 + r;
    qs[c * QLD + r] = gr < sq ? to_f32(qb[(size_t)gr * D + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  // Keys below kv_end are visible to some row of this tile.
  int kv_end = sk;
  if (causal) kv_end = min(sk, q_offset + min(q0 + BQ, sq));
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int gr = k0 + r;
      const bool in = gr < sk;
      ks[c * KLD + r] = in ? to_f32(kb[(size_t)gr * D + c]) : 0.0f;
      vs[r * D + c] = in ? to_f32(vb[(size_t)gr * D + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[d * QLD + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ks[d * KLD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      bool vis[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        vis[j] = kpos < sk && (!causal || kpos <= qpos);
        s[i][j] = vis[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.0f;
        rs += p;
        ps[(tx * 4 + j) * QLD + ty * 4 + i] = p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&ps[kk * QLD + ty * 4]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = vs[kk * D + c * 16 + tx];
        acc[0][c] = fmaf(p.x, vv, acc[0][c]);
        acc[1][c] = fmaf(p.y, vv, acc[1][c]);
        acc[2][c] = fmaf(p.z, vv, acc[2][c]);
        acc[3][c] = fmaf(p.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store_out(&ob[(size_t)row * D + c * 16 + tx], acc[i][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, int causal, int q_offset,
           float scale, void* stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D>
      <<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk,
          causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int sq, int sk, int d, int causal,
             int q_offset, float scale, void* stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, sk, causal, q_offset,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, sk, causal, q_offset,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, sk, causal,
                            q_offset, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream are void*, the
// return value is the first CUDA error of the launch (0 on success).
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, int b,
                                         int hq, int hkv, int sq, int sk,
                                         int d, int causal, int q_offset,
                                         float scale, void* stream) {
  return dispatch<float>(q, k, v, o, b, hq, hkv, sq, sk, d, causal, q_offset,
                         scale, stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, int b,
                                          int hq, int hkv, int sq, int sk,
                                          int d, int causal, int q_offset,
                                          float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d, causal,
                                 q_offset, scale, stream);
}

extern "C" const char* repro_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
