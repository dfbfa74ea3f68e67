// Flash attention, backward, for Hopper (sm_90a): dQ, dK and dV of
// causal or full softmax(Q K^T * scale) V from Q, K, V, the forward's
// output O, the output gradient dO and the forward's per-row
// log-sum-exp LSE (flash_attention.cu writes it).  Nothing of the
// (Sq, Sk) probability matrix is stored: each block recomputes its tiles
// of S = Q K^T and P = exp(S * scale - LSE).
//
// There is no TPU kernel to translate: the reference trains through the
// pure-jnp flash loop `flash_attention` (src/repro/models/layers.py:74)
// and lets autodiff differentiate it.  These kernels compute the same
// gradients by FlashAttention-2's backward, in three launches:
//
//   1. `bwd_delta`: Delta_i = sum_d dO[i, d] * O[i, d], one warp a row.
//   2. `bwd_dkdv`: one block owns BKV keys of one (batch, KV head) and
//      walks every query head of its group and every query tile the
//      causal mask lets through: dV += P^T dO, dK += dS^T Q * scale with
//      dS = P * (dP - Delta), dP = dO V^T.  Grouped-query heads are
//      summed inside the block, so dK and dV are written once.
//   3. `bwd_dq`: one block owns BQ query rows of one head and walks the
//      visible key tiles: dQ += dS K * scale.
// No block writes what another writes, so there are no atomics and the
// result is the same from run to run.  The dQ pass recomputes S and dP
// (seven tile products in all against the five of a fused kernel with
// atomic dQ): the price of determinism in this simple kernel.
//
// Inputs: q, o, do (B, Hq, Sq, D); k, v (B, Hkv, Sk, D), contiguous,
// Hq % Hkv == 0; lse (B, Hq, Sq) float32.  Query row i sits at position
// q_offset + i and, when causal, sees keys j <= q_offset + i; ragged
// Sq and Sk are masked here (P is exactly 0 there).  Keys no query sees
// get dK = dV = 0.
//
// Arithmetic: SIMT, IEEE float32 FMA for float32 and bfloat16 inputs
// alike (bfloat16 is widened on load, the gradients rounded on store).
// Tiles of 64 x 64 with 256 threads as a 16 x 16 grid, as the forward's
// simt kernel: thread (ty, tx) owns S and dP rows 4ty..4ty+3 and columns
// 4tx..4tx+3 of a tile, and accumulator rows 4ty..4ty+3 at columns
// tx + 16c.  Tiles sit transposed in shared memory so each thread reads
// its 4 rows or columns as one 16-byte load in the product loops.
// Shared memory at D = 128: 174,592 bytes (dK/dV), 157,184 (dQ): one
// block an SM.
//
// What bounds it on an H100 SXM at PERF.md's flash shape (q (4, 16,
// 4096, 128), k, v (4, 8, 4096, 128), bf16, causal): the unmasked work is
// 2.5 x the forward's 2.75e11 FLOP, 6.87e11 FLOP, 0.695 ms at the data
// sheet's 989 TFLOP/s of bf16 tensor cores, while the bytes (q, k, v, o,
// do, dq, dk, dv, lse) are 0.12 ms at 3.35 TB/s: it is bound by
// operations.  On the CUDA cores the same work takes at least 10.3 ms
// (the data sheet's 67 TFLOP/s of float32), 15 times that bound; tensor
// cores (wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int PAD = 4;        // keeps transposed rows 16-byte aligned
constexpr int QLD = BQ + PAD;   // a transposed query tile's row
constexpr int KLD = BKV + PAD;  // a transposed key tile's row
constexpr int PLD = BKV + PAD;  // P and dS by query row (keys contiguous)
constexpr int TLD = BQ + PAD;   // dS by key row (queries contiguous)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Rows [r0, r0 + ROWS) of an (n, D) matrix into dst[c * LD + r], widened
// to float32; rows past n are zero.
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                int r0, int n) {
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int g = r0 + r;
    dst[c * LD + r] = g < n ? to_f32(src[(size_t)g * D + c]) : 0.0f;
  }
}

// s[i][j] = sum_d at[d][4ty + i] * bt[d][4tx + j]: a 64 x 64 tile
// product of two transposed tiles.
template <int D>
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const float* at,
                                          int lda, const float* bt, int ldb,
                                          int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&at[d * lda + ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&bt[d * ldb + tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ delta, int rows, int d) {
  const int row = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const T* orow = o + (size_t)row * d;
  const T* drow = dout + (size_t)row * d;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * D * KLD + 2 * D * QLD + 2 * BQ * PLD + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv,
             int sq, int sk, int causal, int q_offset, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int CPT = D / 16;  // accumulator columns per thread

  extern __shared__ __align__(16) float smem[];
  float* kt = smem;              // [D][KLD]  K tile transposed
  float* vt = kt + D * KLD;      // [D][KLD]  V tile transposed
  float* qt = vt + D * KLD;      // [D][QLD]  Q tile transposed
  float* dot = qt + D * QLD;     // [D][QLD]  dO tile transposed
  float* ps = dot + D * QLD;     // [BQ][PLD] P
  float* dss = ps + BQ * PLD;    // [BQ][PLD] dS
  float* row_lse = dss + BQ * PLD;
  float* row_delta = row_lse + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bkv = blockIdx.x;  // batch * hkv + KV head
  const int b = bkv / hkv;
  const int hk = bkv % hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.y * BKV;

  load_transposed<T, D, BKV, KLD>(kt, k + (size_t)bkv * sk * D, k0, sk);
  load_transposed<T, D, BKV, KLD>(vt, v + (size_t)bkv * sk * D, k0, sk);

  float dka[4][CPT], dva[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dka[i][c] = dva[i][c] = 0.0f;

  // The first query row that sees key k0 has q_offset + i >= k0.
  const int i_first = causal ? max(0, k0 - q_offset) : 0;
  const int n_qt = (sq + BQ - 1) / BQ;

  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)b * hq + hk * group + g;
    const T* qb = q + bh * sq * D;
    const T* dob = dout + bh * sq * D;
    const float* lb = lse + bh * sq;
    const float* db = delta + bh * sq;
    for (int t = i_first / BQ; t < n_qt; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_transposed<T, D, BQ, QLD>(qt, qb, q0, sq);
      load_transposed<T, D, BQ, QLD>(dot, dob, q0, sq);
      for (int i = tid; i < BQ; i += THREADS) {
        const bool in = q0 + i < sq;
        row_lse[i] = in ? lb[q0 + i] : 0.0f;
        row_delta[i] = in ? db[q0 + i] : 0.0f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dots<D>(s, qt, QLD, kt, KLD, ty, tx);    // S[q][k]
      tile_dots<D>(dp, dot, QLD, vt, KLD, ty, tx);  // dP[q][k]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = ty * 4 + i;
        const int qi = q0 + qr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k0 + tx * 4 + j;
          const bool vis =
              qi < sq && kj < sk && (!causal || kj <= q_offset + qi);
          const float p =
              vis ? expf(s[i][j] * scale - row_lse[qr]) : 0.0f;
          ps[qr * PLD + tx * 4 + j] = p;
          dss[qr * PLD + tx * 4 + j] = p * (dp[i][j] - row_delta[qr]);
        }
      }
      __syncthreads();

      // dV[k][c] += sum_q P[q][k] dO[q][c]; dK[k][c] += sum_q dS[q][k] Q[q][c]
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        const float4 pv =
            *reinterpret_cast<const float4*>(&ps[qq * PLD + ty * 4]);
        const float4 sv =
            *reinterpret_cast<const float4*>(&dss[qq * PLD + ty * 4]);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float dov = dot[(c * 16 + tx) * QLD + qq];
          const float qv = qt[(c * 16 + tx) * QLD + qq];
          dva[0][c] = fmaf(pv.x, dov, dva[0][c]);
          dva[1][c] = fmaf(pv.y, dov, dva[1][c]);
          dva[2][c] = fmaf(pv.z, dov, dva[2][c]);
          dva[3][c] = fmaf(pv.w, dov, dva[3][c]);
          dka[0][c] = fmaf(sv.x, qv, dka[0][c]);
          dka[1][c] = fmaf(sv.y, qv, dka[1][c]);
          dka[2][c] = fmaf(sv.z, qv, dka[2][c]);
          dka[3][c] = fmaf(sv.w, qv, dka[3][c]);
        }
      }
    }
  }

  T* dkb = dk + (size_t)bkv * sk * D;
  T* dvb = dv + (size_t)bkv * sk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= sk) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store(&dkb[(size_t)row * D + c * 16 + tx], dka[i][c] * scale);
      store(&dvb[(size_t)row * D + c * 16 + tx], dva[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * D * QLD + 2 * D * KLD + BKV * TLD + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, int hq, int hkv, int sq, int sk, int causal,
           int q_offset, float scale) {
  constexpr int CPT = D / 16;

  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [D][QLD]
  float* dot = qt + D * QLD;     // [D][QLD]
  float* kt = dot + D * QLD;     // [D][KLD]
  float* vt = kt + D * KLD;      // [D][KLD]
  float* dst = vt + D * KLD;     // [BKV][TLD] dS by key row
  float* row_lse = dst + BKV * TLD;
  float* row_delta = row_lse + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const T* kb = k + (size_t)kvh * sk * D;
  const T* vb = v + (size_t)kvh * sk * D;

  load_transposed<T, D, BQ, QLD>(qt, q + (size_t)bh * sq * D, q0, sq);
  load_transposed<T, D, BQ, QLD>(dot, dout + (size_t)bh * sq * D, q0, sq);
  for (int i = tid; i < BQ; i += THREADS) {
    const bool in = q0 + i < sq;
    row_lse[i] = in ? lse[(size_t)bh * sq + q0 + i] : 0.0f;
    row_delta[i] = in ? delta[(size_t)bh * sq + q0 + i] : 0.0f;
  }

  float dqa[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqa[i][c] = 0.0f;

  // Keys below kv_end are visible to some row of this tile.
  int kv_end = sk;
  if (causal) kv_end = min(sk, q_offset + min(q0 + BQ, sq));
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile's readers are done
    load_transposed<T, D, BKV, KLD>(kt, kb, k0, sk);
    load_transposed<T, D, BKV, KLD>(vt, vb, k0, sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots<D>(s, qt, QLD, kt, KLD, ty, tx);
    tile_dots<D>(dp, dot, QLD, vt, KLD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty * 4 + i;
      const int qi = q0 + qr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        const bool vis =
            qi < sq && kj < sk && (!causal || kj <= q_offset + qi);
        const float p = vis ? expf(s[i][j] * scale - row_lse[qr]) : 0.0f;
        dst[(tx * 4 + j) * TLD + qr] = p * (dp[i][j] - row_delta[qr]);
      }
    }
    __syncthreads();

    // dQ[q][c] += sum_k dS[q][k] K[k][c]
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 sv =
          *reinterpret_cast<const float4*>(&dst[kk * TLD + ty * 4]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = kt[(c * 16 + tx) * KLD + kk];
        dqa[0][c] = fmaf(sv.x, kv, dqa[0][c]);
        dqa[1][c] = fmaf(sv.y, kv, dqa[1][c]);
        dqa[2][c] = fmaf(sv.z, kv, dqa[2][c]);
        dqa[3][c] = fmaf(sv.w, kv, dqa[3][c]);
      }
    }
  }

  T* dqb = dq + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store(&dqb[(size_t)row * D + c * 16 + tx], dqa[i][c] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
           int causal, int q_offset, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);

  const int rows = b * hq * sq;
  bwd_delta<T><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                 st>>>(static_cast<const T*>(o), dop, dp, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t kv_bytes = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(bwd_dkdv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv<T, D><<<dim3(b * hkv, (sk + BKV - 1) / BKV), THREADS, kv_bytes,
                   st>>>(qp, kp, vp, dop, lp, dp, static_cast<T*>(dk),
                         static_cast<T*>(dv), hq, hkv, sq, sk, causal,
                         q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t q_bytes = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(bwd_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq<T, D><<<dim3(b * hq, (sq + BQ - 1) / BQ), THREADS, q_bytes, st>>>(
      qp, kp, vp, dop, lp, dp, static_cast<T*>(dq), hq, hkv, sq, sk, causal,
      q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
             int d, int causal, int q_offset, float scale, void* stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq,
                           hkv, sq, sk, causal, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq,
                           hkv, sq, sk, causal, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq,
                            hkv, sq, sk, causal, q_offset, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes: pointers and the stream are void*, the
// return value is the first CUDA error of the three launches (0 on
// success).  `delta` is float32 (B, Hq, Sq) scratch; dq is shaped like
// q, dk and dv like k.
extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int hq, int hkv, int sq, int sk, int d, int causal,
    int q_offset, float scale, void* stream) {
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq,
                         hkv, sq, sk, d, causal, q_offset, scale, stream);
}

extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int hq, int hkv, int sq, int sk, int d, int causal,
    int q_offset, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 b, hq, hkv, sq, sk, d, causal, q_offset,
                                 scale, stream);
}

extern "C" const char* repro_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
