// Flash attention, backward, for Hopper (sm_90a): dQ, dK and dV of
// causal or full softmax(Q K^T * scale) V from Q, K, V, the forward's
// output O, the output gradient dO and the forward's per-row
// log-sum-exp LSE in natural units (flash_attention.cu writes it).
// Nothing of the (Sq, Sk) probability matrix is stored: each block
// recomputes its tiles of S = Q K^T and P = exp(S * scale - LSE).
//
// There is no TPU kernel to translate: the reference trains through the
// pure-jnp flash loop `flash_attention` (src/repro/models/layers.py:74)
// and lets autodiff differentiate it.  These kernels compute the same
// gradients by FlashAttention-2's backward, in three launches:
//
//   1. `bwd_delta`: Delta_i = sum_d dO[i, d] * O[i, d], one warp a row.
//   2. dK/dV: one block owns a tile of keys of one (batch, KV head) and
//      walks every query head of its group and every query tile the
//      causal mask lets through: dV += P^T dO, dK += dS^T Q * scale with
//      dS = P * (dP - Delta), dP = dO V^T.  Grouped-query heads are
//      summed inside the block, so dK and dV are written once.
//   3. dQ: one block owns a tile of query rows of one head and walks
//      the visible key tiles: dQ += dS K * scale.
// No block writes what another writes, so there are no atomics and the
// result is bit-identical from run to run.  The dQ pass recomputes S
// and dP (seven tile products in all against the five of a fused
// kernel with atomic dQ): the price of determinism.
//
// Inputs: q, o, do (B, Hq, Sq, D); k, v (B, Hkv, Sk, D), contiguous,
// Hq % Hkv == 0; lse (B, Hq, Sq) float32.  Query row i sits at position
// q_offset + i and, when causal, sees keys j <= q_offset + i; ragged
// Sq and Sk are masked here (P is exactly 0 there).  Keys no query sees
// get dK = dV = 0.
//
// Two variants behind the C interface; the wrapper
// (kernels/flash_attention/flash_attention.py) sends every float32 call
// to the first and every bfloat16 call to the second:
//
// - `simt` (float32): IEEE float32 FMA on the CUDA cores, 64 x 64 tiles
//   with 256 threads as a 16 x 16 grid, as the forward's simt kernel;
//   tiles sit transposed in shared memory so each thread reads its 4
//   rows or columns as one 16-byte load.  Shared memory at D = 128:
//   174,592 bytes (dK/dV), 157,184 (dQ).  Above D = 128 the streamed
//   tiles (query rows for dK/dV, keys for dQ) hold 32 rows, 2 a thread,
//   so that both kernels fit a block: 230,656 and 222,208 bytes at D =
//   256.  It keeps the reference's float32 numerics.
//
// - `wgmma` (bfloat16), after FlashAttention-3's backward, split into
//   separate dK/dV and dQ kernels as the Pallas TPU backward is.  Each
//   block has a producer warpgroup (one warp issues TMA) and two
//   consumer warpgroups of 64 rows; registers move from the producer to
//   the consumers (setmaxnreg 24 / 240).  Tiles land in shared memory
//   through TMA as the forward's do: rows of D cut into boxes of 64
//   elements with a 128-byte swizzle (at D = 32 one 32-element box with
//   a 64-byte swizzle); D = 80 and 112 are held as 128 columns, TMA
//   zero-filling past D.  Above D = 128 a block owns 64 keys or query
//   rows, and its two consumer warpgroups split the gradients' columns
//   between them, each computing the scores itself (`Tile` says why).
//   The shapes below are those up to D = 128.
//   * `bwd_dkdv_wgmma`: 128 keys a block (64 per warpgroup).  K and V
//     are loaded once; Q and dO tiles of 64 queries stream through a
//     2-stage ring, over every query head of the group and every query
//     tile the causal mask lets through (those wholly above the
//     diagonal are skipped).  Per query tile a warpgroup computes
//     S^T = K Q^T and dP^T = V dO^T (SS wgmma m64n64k16, both operands
//     K-major), then P^T = exp2(S^T * scale * log2 e - LSE * log2 e)
//     and dS^T = P^T (dP^T - Delta) in registers (LSE and Delta by
//     column, since the columns are queries: the producer warp stages
//     them in shared memory beside each tile), then dV += P^T dO and
//     dK += dS^T Q (RS wgmma: A is P^T or dS^T packed from the
//     accumulator into bf16 A fragments as the forward packs P, B is
//     the dO or Q tile, MN-major).  The keys are the M dimension, so
//     P^T and dS^T never touch shared memory and no transposed-A
//     product is needed.  dV's product is issued before dS^T is formed,
//     so the tensor cores run it while the warpgroup computes dS^T; the
//     tile's dV and dK products are waited on before the next tile.
//     (Waiting on them a tile later, as the dQ kernel does, keeps P^T's
//     and dS^T's fragments live across the loop: at D = 128 ptxas then
//     serializes the wgmma for lack of registers, warning C7512, and the
//     kernel ran slower on the card.)
//     Shared memory at D = 128: K + V 64 KB + 2 x (Q + dO) 64 KB + LSE
//     and Delta 1 KB.  Per consumer thread: dK + dV 128 float32
//     registers, S^T + dP^T 64, the packed A fragments 32.
//   * `bwd_dq_wgmma`: 128 query rows a block (64 per warpgroup), Q and
//     dO resident; K and V tiles of 64 keys stream through a 2-stage
//     ring up to the causal diagonal.  S = Q K^T and dP = dO V^T are SS
//     wgmma, P and dS are formed row-wise, dQ += dS K is RS wgmma with
//     K MN-major, waited on after the next tile's S and dP are issued.
//     Query tiles are walked last-first, so the blocks with the most
//     key tiles start first.  Shared memory at D = 128: Q + dO 64 KB +
//     2 x (K + V) 64 KB.
//   An m64n64k16 SS product reads 4 KB of shared memory in the 32
//   tensor-core clocks it takes, about all of an SM's 128 bytes a
//   clock: by that count S (S^T) and dP (dP^T) are bound by shared
//   memory, not by the tensor cores (a register-resident A operand
//   would halve the bytes).
//   P and dS are rounded to bf16 before the products that take them
//   (the one departure from the float32 plain version, the same the
//   forward makes for P); everything accumulates in float32 and the
//   gradients are rounded to bf16 on store, through TMA over the
//   warpgroup's own rows of K / V (dK/dV) or Q (dQ) in shared memory.
//   Masked keys (past Sk or above the diagonal) and rows past Sq get P
//   exactly 0, whatever TMA's zero-filled tail boxes hold.
//
// What bounds it on an H100 SXM at PERF.md's flash shape (q (4, 16,
// 4096, 128), k, v (4, 8, 4096, 128), bf16, causal): the unmasked work
// is 2.5 x the forward's 2.75e11 FLOP, 6.87e11 FLOP, 0.695 ms at the
// data sheet's 989 TFLOP/s of bf16 tensor cores, while the bytes (q, k,
// v, o, do, dq, dk, dv, lse, delta) are 0.121 ms at 3.35 TB/s: it is
// bound by operations; the seven products these kernels run take at
// least 0.973 ms there.  At the training shape of Qwen3-0.6B (q (8, 16,
// 512, 128), k, v (8, 8, 512, 128)) the bytes bound it: 101 MB, 0.030
// ms, against 0.022 ms of operations.  At HuBERT-XLarge's head dim (q,
// k, v (4, 16, 4096, 80), full) the work is 8.6e11 FLOP, 0.87 ms; at
// Gemma-7B's (q, k, v (4, 16, 4096, 256), causal) 1.375e12 FLOP, 1.39
// ms; the split tiles there run 11 tile products where that count has
// 5 (the dQ pass and each warpgroup recompute S and dP): 3.06 ms at
// least.  On the CUDA cores (the simt variant) the five-product work at
// the flash shape takes at least 10.3 ms (67 TFLOP/s of float32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "hopper.cuh"

// The head dims both variants take: the forward's (flash_attention.cu),
// every one the repo's model configs use.  The wrapper's HEAD_DIMS
// lists the same.
#define REPRO_FLASH_HEAD_DIMS(X) X(32) X(64) X(80) X(112) X(128) X(192) X(256)

namespace {

constexpr int BQ = 64;        // query rows of a dQ block
constexpr int BKV = 64;       // keys of a dK/dV block
constexpr int THREADS = 256;  // 16 x 16
constexpr int PAD = 4;        // keeps transposed rows 16-byte aligned
constexpr int QLD = BQ + PAD;   // a dQ block's transposed query tile's row
constexpr int KLD = BKV + PAD;  // a dK/dV block's transposed key tile's row
constexpr int PLD = BKV + PAD;  // P and dS by query row (keys contiguous)
constexpr int TLD = BQ + PAD;   // dS by key row (queries contiguous)

// Rows of a streamed tile (query rows in the dK/dV kernel, keys in the
// dQ kernel): 64, and 32 above D = 128, where the transposed resident
// tiles alone take 139 KB at D = 256 and 64-row streamed ones would
// not fit a block's 227 KB.
template <int D>
__host__ __device__ constexpr int stream_rows() {
  return D > 128 ? 32 : 64;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Rows [r0, r0 + ROWS) of an (n, D) matrix into dst[c * LD + r]; rows
// past n are zero.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_transposed(float* dst, const float* src,
                                                int r0, int n) {
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int g = r0 + r;
    dst[c * LD + r] = g < n ? src[(size_t)g * D + c] : 0.0f;
  }
}

// R consecutive floats of shared memory (4: one 16-byte load, 2: one
// 8-byte load).
template <int R>
__device__ __forceinline__ void load_run(float (&dst)[R], const float* p) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else {
    static_assert(R == 2, "2 or 4 rows a thread");
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x, dst[1] = v.y;
  }
}

// s[i][j] = sum_d at[d][RA ty + i] * bt[d][RB tx + j]: a (16 RA) x
// (16 RB) tile product of two transposed tiles.
template <int D, int RA, int RB>
__device__ __forceinline__ void tile_dots(float (&s)[RA][RB], const float* at,
                                          int lda, const float* bt, int ldb,
                                          int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) s[i][j] = 0.0f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    float av[RA], bv[RB];
    load_run<RA>(av, &at[d * lda + ty * RA]);
    load_run<RB>(bv, &bt[d * ldb + tx * RB]);
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
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

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int rows,
                 int d, cudaStream_t st) {
  bwd_delta<T><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                 st>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                       delta, rows, d);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  constexpr int SQ = stream_rows<D>();
  return sizeof(float) * (size_t)(2 * D * KLD + 2 * D * (SQ + PAD) +
                                  2 * SQ * PLD + 2 * SQ);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv,
             int sq, int sk, int causal, int q_offset, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int CPT = D / 16;  // accumulator columns per thread
  constexpr int SQ = stream_rows<D>();  // query rows per streamed tile
  constexpr int SLD = SQ + PAD;         // a transposed query tile's row
  constexpr int RQ = SQ / 16;           // score rows per thread

  extern __shared__ __align__(16) float smem[];
  float* kt = smem;              // [D][KLD]  K tile transposed
  float* vt = kt + D * KLD;      // [D][KLD]  V tile transposed
  float* qt = vt + D * KLD;      // [D][SLD]  Q tile transposed
  float* dot = qt + D * SLD;     // [D][SLD]  dO tile transposed
  float* ps = dot + D * SLD;     // [SQ][PLD] P
  float* dss = ps + SQ * PLD;    // [SQ][PLD] dS
  float* row_lse = dss + SQ * PLD;
  float* row_delta = row_lse + SQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bkv = blockIdx.x;  // batch * hkv + KV head
  const int b = bkv / hkv;
  const int hk = bkv % hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.y * BKV;

  load_transposed<D, BKV, KLD>(kt, k + (size_t)bkv * sk * D, k0, sk);
  load_transposed<D, BKV, KLD>(vt, v + (size_t)bkv * sk * D, k0, sk);

  float dka[4][CPT], dva[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dka[i][c] = dva[i][c] = 0.0f;

  // The first query row that sees key k0 has q_offset + i >= k0.
  const int i_first = causal ? max(0, k0 - q_offset) : 0;
  const int n_qt = (sq + SQ - 1) / SQ;

  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)b * hq + hk * group + g;
    const float* qb = q + bh * sq * D;
    const float* dob = dout + bh * sq * D;
    const float* lb = lse + bh * sq;
    const float* db = delta + bh * sq;
    for (int t = i_first / SQ; t < n_qt; ++t) {
      const int q0 = t * SQ;
      __syncthreads();  // the previous tile's readers are done
      load_transposed<D, SQ, SLD>(qt, qb, q0, sq);
      load_transposed<D, SQ, SLD>(dot, dob, q0, sq);
      for (int i = tid; i < SQ; i += THREADS) {
        const bool in = q0 + i < sq;
        row_lse[i] = in ? lb[q0 + i] : 0.0f;
        row_delta[i] = in ? db[q0 + i] : 0.0f;
      }
      __syncthreads();

      float s[RQ][4], dp[RQ][4];
      tile_dots<D, RQ, 4>(s, qt, SLD, kt, KLD, ty, tx);    // S[q][k]
      tile_dots<D, RQ, 4>(dp, dot, SLD, vt, KLD, ty, tx);  // dP[q][k]
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int qr = ty * RQ + i;
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
      for (int qq = 0; qq < SQ; ++qq) {
        const float4 pv =
            *reinterpret_cast<const float4*>(&ps[qq * PLD + ty * 4]);
        const float4 sv =
            *reinterpret_cast<const float4*>(&dss[qq * PLD + ty * 4]);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float dov = dot[(c * 16 + tx) * SLD + qq];
          const float qv = qt[(c * 16 + tx) * SLD + qq];
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

  float* dkb = dk + (size_t)bkv * sk * D;
  float* dvb = dv + (size_t)bkv * sk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= sk) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkb[(size_t)row * D + c * 16 + tx] = dka[i][c] * scale;
      dvb[(size_t)row * D + c * 16 + tx] = dva[i][c];
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int SK = stream_rows<D>();
  return sizeof(float) * (size_t)(2 * D * QLD + 2 * D * (SK + PAD) +
                                  SK * TLD + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int hq, int hkv, int sq, int sk,
           int causal, int q_offset, float scale) {
  constexpr int CPT = D / 16;
  constexpr int SK = stream_rows<D>();  // keys per streamed tile
  constexpr int SLD = SK + PAD;         // a transposed key tile's row
  constexpr int RK = SK / 16;           // score columns per thread

  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [D][QLD]
  float* dot = qt + D * QLD;     // [D][QLD]
  float* kt = dot + D * QLD;     // [D][SLD]
  float* vt = kt + D * SLD;      // [D][SLD]
  float* dst = vt + D * SLD;     // [SK][TLD] dS by key row
  float* row_lse = dst + SK * TLD;
  float* row_delta = row_lse + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const float* kb = k + (size_t)kvh * sk * D;
  const float* vb = v + (size_t)kvh * sk * D;

  load_transposed<D, BQ, QLD>(qt, q + (size_t)bh * sq * D, q0, sq);
  load_transposed<D, BQ, QLD>(dot, dout + (size_t)bh * sq * D, q0, sq);
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
  const int n_tiles = (kv_end + SK - 1) / SK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * SK;
    __syncthreads();  // the previous tile's readers are done
    load_transposed<D, SK, SLD>(kt, kb, k0, sk);
    load_transposed<D, SK, SLD>(vt, vb, k0, sk);
    __syncthreads();

    float s[4][RK], dp[4][RK];
    tile_dots<D, 4, RK>(s, qt, QLD, kt, SLD, ty, tx);
    tile_dots<D, 4, RK>(dp, dot, QLD, vt, SLD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty * 4 + i;
      const int qi = q0 + qr;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kj = k0 + tx * RK + j;
        const bool vis =
            qi < sq && kj < sk && (!causal || kj <= q_offset + qi);
        const float p = vis ? expf(s[i][j] * scale - row_lse[qr]) : 0.0f;
        dst[(tx * RK + j) * TLD + qr] = p * (dp[i][j] - row_delta[qr]);
      }
    }
    __syncthreads();

    // dQ[q][c] += sum_k dS[q][k] K[k][c]
#pragma unroll 4
    for (int kk = 0; kk < SK; ++kk) {
      const float4 sv =
          *reinterpret_cast<const float4*>(&dst[kk * TLD + ty * 4]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = kt[(c * 16 + tx) * SLD + kk];
        dqa[0][c] = fmaf(sv.x, kv, dqa[0][c]);
        dqa[1][c] = fmaf(sv.y, kv, dqa[1][c]);
        dqa[2][c] = fmaf(sv.z, kv, dqa[2][c]);
        dqa[3][c] = fmaf(sv.w, kv, dqa[3][c]);
      }
    }
  }

  float* dqb = dq + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      dqb[(size_t)row * D + c * 16 + tx] = dqa[i][c] * scale;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
           int causal, int q_offset, float scale, void* stream) {
  static_assert(dkdv_smem_bytes<D>() <= 232448 &&
                    dq_smem_bytes<D>() <= 232448,
                "over a block's 227 KB of shared memory");
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);

  cudaError_t err = static_cast<cudaError_t>(
      launch_delta<float>(o, dout, dp, b * hq * sq, D, st));
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t kv_bytes = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(bwd_dkdv<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv<D><<<dim3(b * hkv, (sk + BKV - 1) / BKV), THREADS, kv_bytes,
                st>>>(qp, kp, vp, dop, lp, dp, static_cast<float*>(dk),
                      static_cast<float*>(dv), hq, hkv, sq, sk, causal,
                      q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t q_bytes = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(bwd_dq<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq<D><<<dim3(b * hq, (sq + BQ - 1) / BQ), THREADS, q_bytes, st>>>(
      qp, kp, vp, dop, lp, dp, static_cast<float*>(dq), hq, hkv, sq, sk,
      causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
             int d, int causal, int q_offset, float scale, void* stream) {
  switch (d) {
#define REPRO_FLASH_BWD_CASE(DIM)                                          \
  case DIM:                                                                \
    return launch<DIM>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq,    \
                       hkv, sq, sk, causal, q_offset, scale, stream);
    REPRO_FLASH_HEAD_DIMS(REPRO_FLASH_BWD_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- bf16 tensor-core kernels -------------------------------------------

namespace tc {

constexpr int STREAM = 64;    // queries (dK/dV) or keys (dQ) a streamed tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;

// Tiles by head dim.  A row of D is cut into boxes of BOXW elements.  Up
// to D = 128 a block owns ROWS = 128 keys (dK/dV) or query rows (dQ),
// 64 per consumer warpgroup, each warpgroup holding its rows' gradients
// at every column: DP columns, the boxes rounded up, so D = 80 and 112
// are held as 128 with the second box zero-filled past D by TMA (zero
// columns of Q and K add nothing to a score, whose k-steps stop at D
// anyway; zero columns of Q and dO give gradient columns past D, which
// the TMA store clips).  Above D = 128 (SPLIT) the gradients of 128 rows
// would take 192 (D 192) or 256 (D 256) registers a thread for dK and
// dV before the scores, and the tiles 262 KB of shared memory at D =
// 256: a block owns 64 rows, which both consumer warpgroups work on,
// each holding the gradients at half of DP = 256 columns (D = 192 is
// held as 256, its fourth box never loaded or stored: those
// accumulator columns see only unwritten shared memory, and a product's
// output column reads only its own B column).  Each warpgroup computes
// the full scores S and dP itself, so the block runs S and dP twice:
// 6 tile products for dK/dV where a 128-row block runs 4, and 5 for dQ
// where it runs 3.
template <int D>
struct Tile {
  static constexpr int SWB = D >= 64 ? 128 : 64;  // swizzle bytes = box row
  static constexpr int BOXW = SWB / 2;            // elements per box row
  static constexpr bool SPLIT = D > 128;
  static constexpr int LIVE = (D + BOXW - 1) / BOXW;  // boxes holding data
  static constexpr int CHUNKS = SPLIT ? 4 : LIVE;     // boxes held a row
  static constexpr int DP = CHUNKS * BOXW;            // columns held a row
  static constexpr int ROWS = SPLIT ? 64 : 128;  // a block's keys or rows
  static constexpr int W = SPLIT ? DP / 2 : DP;  // a warpgroup's columns
  static constexpr int LAYOUT =
      SWB == 128 ? hopper::kSwizzle128B : hopper::kSwizzle64B;
  static constexpr int ATOM = 8 * SWB;            // 8 swizzled rows: SBO
  static constexpr int BIG_BOX = ROWS * SWB;      // one box of a resident tile
  static constexpr int BOX = STREAM * SWB;        // one box of a streamed tile
  static constexpr int BIG_BYTES = ROWS * DP * 2;
  static constexpr int BYTES = STREAM * DP * 2;
  // Two resident tiles, STAGES x two streamed tiles, per stage the
  // streamed queries' LSE and Delta (dK/dV only), the barriers.
  static constexpr size_t SMEM = 1024 + 2 * BIG_BYTES + STAGES * 2 * BYTES +
                                 STAGES * 2 * STREAM * sizeof(float) +
                                 (1 + 2 * STAGES) * sizeof(uint64_t);
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(W == 32 || W == 64 || W == 128, "an RS wgmma width");
  static_assert(SMEM <= 232448, "over a block's 227 KB of shared memory");
};

// The descriptor of k-step kk (16 elements of D) of a K-major operand:
// `rows` rows of a tile whose boxes are `box` bytes apart, from row `row`.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int box,
                                                int row, int kk) {
  using T = Tile<D>;
  const int c = kk * 16 / T::BOXW;
  const int within = (kk * 16 % T::BOXW) * 2;
  return hopper::smem_desc(tile + c * box + row * T::SWB + within, 16,
                           T::ATOM, T::LAYOUT);
}

// The descriptor of k-step kk (16 rows) of an MN-major operand: a
// streamed tile (STREAM rows, the product's K) read along D (its N)
// from box c0.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile, int c0,
                                                 int kk) {
  using T = Tile<D>;
  return hopper::smem_desc(tile + c0 * T::BOX + kk * 16 * T::SWB, T::BOX,
                           T::ATOM, T::LAYOUT);
}

// A 64 x 64 tile product of K-major operands: acc = A[row_a..+64] .
// B^T over D, A resident (BIG_BOX boxes), B streamed (BOX boxes).
template <int D>
__device__ __forceinline__ void issue_tile_dots(float (&acc)[32],
                                                const uint8_t* a, int row_a,
                                                const uint8_t* b) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss<0>(acc, kmajor_desc<D>(a, T::BIG_BOX, row_a, kk),
                        kmajor_desc<D>(b, T::BOX, 0, kk), kk > 0);
  hopper::wgmma_commit();
}

// acc (64 x W) += A (64 x STREAM, bf16 fragments) . the streamed tile b
// (STREAM x W from box c0, MN-major).
template <int D>
__device__ __forceinline__ void issue_acc(float (&acc)[Tile<D>::W / 2],
                                          const uint32_t (&a)[STREAM / 16][4],
                                          const uint8_t* b, int c0) {
#pragma unroll
  for (int kk = 0; kk < STREAM / 16; ++kk)
    hopper::wgmma_rs<1>(acc, a[kk], mnmajor_desc<D>(b, c0, kk), 1);
  hopper::wgmma_commit();
}

// A 64 x 64 float32 accumulator as the bf16 A fragments of 4 k-steps:
// elements 8kk .. 8kk+7, in order, in pairs.
__device__ __forceinline__ void pack_a(uint32_t (&a)[STREAM / 16][4],
                                       const float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < STREAM / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] =
          hopper::pack_bf16(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
}

// acc * mul in bf16 over this warpgroup's 64 rows and W columns (from
// box c0) of a resident tile's boxes (the swizzled layout TMA stores
// from).  Accumulator element i of a thread sits at row r + 8 ((i / 2)
// % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
template <int D>
__device__ __forceinline__ void stage_rows(uint8_t* tile, int row_wg, int c0,
                                           int r, int lane,
                                           const float (&acc)[Tile<D>::W / 2],
                                           float mul) {
  using T = Tile<D>;
#pragma unroll
  for (int j = 0; j < T::W / 8; ++j) {
    const int c = c0 + j * 8 / T::BOXW;
    const int within = (j * 8 % T::BOXW) * 2 + (lane % 4) * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off =
          c * T::BIG_BOX + (row_wg + r + 8 * h) * T::SWB + within;
      *reinterpret_cast<uint32_t*>(tile + hopper::swizzled(off, T::SWB)) =
          hopper::pack_bf16(acc[4 * j + 2 * h] * mul,
                            acc[4 * j + 2 * h + 1] * mul);
    }
  }
}

// The boxes [c0, c0 + W / BOXW) that hold data, of this warpgroup's 64
// rows of a resident tile, stored through TMA at (box column, row0,
// plane) by one thread.
template <int D>
__device__ __forceinline__ void store_rows(const CUtensorMap* map,
                                           const uint8_t* tile, int row_wg,
                                           int c0, int row0, int plane) {
  using T = Tile<D>;
#pragma unroll
  for (int c = c0; c < c0 + T::W / T::BOXW; ++c)
    if (c < T::LIVE)
      hopper::tma_store_3d(map, tile + c * T::BIG_BOX + row_wg * T::SWB,
                           c * T::BOXW, row0, plane);
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// Named barrier over both consumer warpgroups (ids 1 and 2 are theirs
// alone).
constexpr int CONSUMERS_BAR = 3;

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap domap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap dkmap,
                   const __grid_constant__ CUtensorMap dvmap,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, int hq, int hkv, int sq,
                   int sk, int causal, int q_offset, float scale) {
  using namespace hopper;
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ks = smem;                   // [CHUNKS][ROWS][BOXW]
  uint8_t* vs = ks + T::BIG_BYTES;
  uint8_t* qs = vs + T::BIG_BYTES;      // [STAGES][CHUNKS][STREAM][BOXW]
  uint8_t* dos = qs + STAGES * T::BYTES;
  float* lse_s = reinterpret_cast<float*>(dos + STAGES * T::BYTES);
  float* delta_s = lse_s + STAGES * STREAM;  // [STAGES][STREAM] each
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(delta_s + STAGES * STREAM);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // every producer lane, after its LSE rows
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int bkv = blockIdx.x;  // batch * hkv + KV head
  const int b = bkv / hkv;
  const int hk = bkv % hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.y * T::ROWS;
  // Query tiles wholly above the diagonal of the block's first key are
  // skipped: the first query that sees key k0 has q_offset + i >= k0.
  const int n_qt = (sq + STREAM - 1) / STREAM;
  const int t_first =
      causal ? min(n_qt, max(0, k0 - q_offset) / STREAM) : 0;
  const int per_head = n_qt - t_first;
  const int n_iters = group * per_head;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  if (wg == 0) {
    // Producer warp: K and V once, then each (head, query tile)'s Q and
    // dO through the ring, with the tile's LSE (log2 units) and Delta.
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32 && n_iters > 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kvbar, 2 * T::LIVE * T::BIG_BOX);
#pragma unroll
        for (int c = 0; c < T::LIVE; ++c) {
          tma_load_3d(ks + c * T::BIG_BOX, &kmap, kvbar, c * T::BOXW, k0, bkv);
          tma_load_3d(vs + c * T::BIG_BOX, &vmap, kvbar, c * T::BOXW, k0, bkv);
        }
      }
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % STAGES;
        const int round = it / STAGES;
        const int bh = b * hq + hk * group + it / per_head;
        const int q0 = (t_first + it % per_head) * STREAM;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
#pragma unroll
        for (int h = 0; h < STREAM / 32; ++h) {
          const int i = lane + 32 * h;
          const bool in = q0 + i < sq;
          const size_t g = (size_t)bh * sq + q0 + i;
          lse_s[s * STREAM + i] = in ? lse[g] * LOG2E : 0.0f;
          delta_s[s * STREAM + i] = in ? delta[g] : 0.0f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * T::LIVE * T::BOX);
#pragma unroll
          for (int c = 0; c < T::LIVE; ++c) {
            tma_load_3d(qs + s * T::BYTES + c * T::BOX, &qmap, &full[s],
                        c * T::BOXW, q0, bh);
            tma_load_3d(dos + s * T::BYTES + c * T::BOX, &domap, &full[s],
                        c * T::BOXW, q0, bh);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    // This warpgroup's first key, and first box of the gradients' columns.
    const int row_wg = T::SPLIT ? 0 : (wg - 1) * 64;
    const int cw = T::SPLIT ? (wg - 1) * (T::W / T::BOXW) : 0;
    const int warp = (threadIdx.x % 128) / 32;
    const int r = warp * 16 + lane / 4;  // keys r and r + 8 of the 64
    const int key0 = k0 + row_wg + r;
    const int col0 = 2 * (lane % 4);     // + 8 (i / 4) + i % 2
    const float scale_log2 = scale * LOG2E;

    float dk[T::W / 2], dv[T::W / 2];
#pragma unroll
    for (int i = 0; i < T::W / 2; ++i) dk[i] = dv[i] = 0.0f;
    float st[32], dpt[32];               // S^T then P^T; dP^T then dS^T
    uint32_t pa[STREAM / 16][4], da[STREAM / 16][4];

    if (n_iters > 0) mbar_wait(kvbar, 0);
    for (int it = 0; it < n_iters; ++it) {
      const int s = it % STAGES;
      const int q0 = (t_first + it % per_head) * STREAM;
      const uint8_t* qt = qs + s * T::BYTES;
      const uint8_t* dot = dos + s * T::BYTES;
      const float* ls = lse_s + s * STREAM;
      const float* ds = delta_s + s * STREAM;
      mbar_wait(&full[s], (it / STAGES) & 1);
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
      issue_tile_dots<D>(st, ks, row_wg, qt);    // S^T = K Q^T
      issue_tile_dots<D>(dpt, vs, row_wg, dot);  // dP^T = V dO^T
      wgmma_wait<1>();
      fence_regs(st);
      // Masking is needed where the tile reaches past Sq or Sk or
      // crosses the diagonal.
      const bool edge = q0 + STREAM > sq || k0 + row_wg + 64 > sk ||
                        (causal && k0 + row_wg + 63 > q_offset + q0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + col0 + i % 2;
        float p = exp2f(fmaf(st[i], scale_log2, -ls[col]));
        if (edge) {
          const int key = key0 + 8 * ((i / 2) % 2);
          const int qi = q0 + col;
          if (qi >= sq || key >= sk || (causal && key > q_offset + qi))
            p = 0.0f;
        }
        st[i] = p;
      }
      pack_a(pa, st);
      wgmma_fence();
      issue_acc<D>(dv, pa, dot, cw);  // dV += P^T dO, while dS^T is formed
      wgmma_wait<1>();                // dP^T is in
      fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + col0 + i % 2;
        dpt[i] = st[i] * (dpt[i] - ds[col]);
      }
      pack_a(da, dpt);
      wgmma_fence();
      issue_acc<D>(dk, da, qt, cw);   // dK += dS^T Q
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
#pragma unroll
      for (int kk = 0; kk < STREAM / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      release(&empty[s], lane);
    }

    // Epilogue: dK * scale and dV in bf16 over this warpgroup's rows and
    // columns of K and V in shared memory; one thread stores the boxes,
    // and TMA drops rows past Sk and columns past D.  Split, the other
    // warpgroup reads every column of K and V for its scores until its
    // loop ends: both finish before either writes.
    if constexpr (T::SPLIT) named_barrier_sync(CONSUMERS_BAR, 256);
    stage_rows<D>(ks, row_wg, cw, r, lane, dk, scale);
    stage_rows<D>(vs, row_wg, cw, r, lane, dv, 1.0f);
    fence_proxy_async();
    named_barrier_sync(wg, 128);
    if (threadIdx.x % 128 == 0) {
      store_rows<D>(&dkmap, ks, row_wg, cw, k0 + row_wg, bkv);
      store_rows<D>(&dvmap, vs, row_wg, cw, k0 + row_wg, bkv);
      tma_store_wait();
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap domap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap dqmap,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, int hq, int hkv, int sq,
                 int sk, int causal, int q_offset, float scale) {
  using namespace hopper;
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs = smem;                   // [CHUNKS][ROWS][BOXW]
  uint8_t* dos = qs + T::BIG_BYTES;
  uint8_t* ks = dos + T::BIG_BYTES;     // [STAGES][CHUNKS][STREAM][BOXW]
  uint8_t* vs = ks + STAGES * T::BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vs + STAGES * T::BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::ROWS;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  // Keys below kv_end are visible to some row of this block.
  int kv_end = sk;
  if (causal) kv_end = min(sk, q_offset + min(q0 + T::ROWS, sq));
  const int n_tiles = (kv_end + STREAM - 1) / STREAM;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  if (wg == 0) {
    // Producer: Q and dO once, then each key tile's K and V.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qbar, 2 * T::LIVE * T::BIG_BOX);
#pragma unroll
      for (int c = 0; c < T::LIVE; ++c) {
        tma_load_3d(qs + c * T::BIG_BOX, &qmap, qbar, c * T::BOXW, q0, bh);
        tma_load_3d(dos + c * T::BIG_BOX, &domap, qbar, c * T::BOXW, q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int round = t / STAGES;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::LIVE * T::BOX);
#pragma unroll
        for (int c = 0; c < T::LIVE; ++c) {
          tma_load_3d(ks + s * T::BYTES + c * T::BOX, &kmap, &full[s],
                      c * T::BOXW, t * STREAM, kvh);
          tma_load_3d(vs + s * T::BYTES + c * T::BOX, &vmap, &full[s],
                      c * T::BOXW, t * STREAM, kvh);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    // This warpgroup's first row, and first box of dQ's columns.
    const int row_wg = T::SPLIT ? 0 : (wg - 1) * 64;
    const int cw = T::SPLIT ? (wg - 1) * (T::W / T::BOXW) : 0;
    const int warp = (threadIdx.x % 128) / 32;
    const int r = warp * 16 + lane / 4;  // rows r and r + 8 of the 64
    const int row0 = q0 + row_wg + r;
    const int col0 = 2 * (lane % 4);
    const float scale_log2 = scale * LOG2E;
    // LSE (log2 units) and Delta of rows r and r + 8; rows past Sq are
    // masked below.
    float lse2[2], dlt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const bool in = row < sq;
      lse2[h] = in ? lse[(size_t)bh * sq + row] * LOG2E : 0.0f;
      dlt[h] = in ? delta[(size_t)bh * sq + row] : 0.0f;
    }

    float dq[T::W / 2];
#pragma unroll
    for (int i = 0; i < T::W / 2; ++i) dq[i] = 0.0f;
    float sc[32], dp[32];  // S then P; dP then dS
    uint32_t da[STREAM / 16][4];

    mbar_wait(qbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int k0 = t * STREAM;
      const uint8_t* kt = ks + s * T::BYTES;
      const uint8_t* vt = vs + s * T::BYTES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      wgmma_fence();
      issue_tile_dots<D>(sc, qs, row_wg, kt);   // S = Q K^T
      issue_tile_dots<D>(dp, dos, row_wg, vt);  // dP = dO V^T
      // The previous tile's dQ product ran on while these were issued;
      // all but dP are in now.
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < STREAM / 16; ++kk) fence_regs(da[kk]);
      if (t > 0) release(&empty[(t - 1) % STAGES], lane);
      const bool edge = k0 + STREAM > sk || q0 + row_wg + 64 > sq ||
                        (causal && k0 + STREAM - 1 > q_offset + q0 + row_wg);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        float p = exp2f(fmaf(sc[i], scale_log2, -lse2[h]));
        if (edge) {
          const int key = k0 + 8 * (i / 4) + col0 + i % 2;
          const int row = row0 + 8 * h;
          if (row >= sq || key >= sk || (causal && key > q_offset + row))
            p = 0.0f;
        }
        sc[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dlt[(i / 2) % 2]);
      pack_a(da, dp);
      wgmma_fence();
      issue_acc<D>(dq, da, kt, cw);  // dQ += dS K, waited on a tile later
    }
    wgmma_wait<0>();
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < STREAM / 16; ++kk) fence_regs(da[kk]);

    // Epilogue: dQ * scale in bf16 over this warpgroup's Q rows and
    // columns; split, after both warpgroups' last reads of Q and dO.
    if constexpr (T::SPLIT) named_barrier_sync(CONSUMERS_BAR, 256);
    stage_rows<D>(qs, row_wg, cw, r, lane, dq, scale);
    fence_proxy_async();
    named_barrier_sync(wg, 128);
    if (threadIdx.x % 128 == 0) {
      store_rows<D>(&dqmap, qs, row_wg, cw, q0 + row_wg, bh);
      tma_store_wait();
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
           int causal, int q_offset, float scale, void* stream) {
  using T = Tile<D>;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dp = static_cast<float*>(delta);
  int rc = launch_delta<__nv_bfloat16>(o, dout, dp, b * hq * sq, D, st);
  if (rc != 0) return rc;

  // Tensor maps: (D, S, B * H) bf16; boxes of ROWS rows for the resident
  // tiles, STREAM rows for the streamed ones and the stores.
  const uint64_t qdims[3] = {D, (uint64_t)sq, (uint64_t)b * hq};
  const uint64_t qstride[2] = {D * 2, (uint64_t)sq * D * 2};
  const uint64_t kdims[3] = {D, (uint64_t)sk, (uint64_t)b * hkv};
  const uint64_t kstride[2] = {D * 2, (uint64_t)sk * D * 2};
  const uint32_t big[3] = {T::BOXW, T::ROWS, 1};
  const uint32_t small[3] = {T::BOXW, STREAM, 1};
  CUtensorMap q_s, do_s, k_b, v_b, dk_s, dv_s;  // dK/dV kernel
  CUtensorMap q_b, do_b, k_s, v_s, dq_s;        // dQ kernel
  struct Map {
    CUtensorMap* map;
    const void* base;
    bool query;  // shaped like q (else like k)
    const uint32_t* box;
  } maps[] = {{&q_s, q, true, small},   {&do_s, dout, true, small},
              {&k_b, k, false, big},    {&v_b, v, false, big},
              {&dk_s, dk, false, small}, {&dv_s, dv, false, small},
              {&q_b, q, true, big},     {&do_b, dout, true, big},
              {&k_s, k, false, small},  {&v_s, v, false, small},
              {&dq_s, dq, true, small}};
  for (const Map& m : maps) {
    rc = hopper::encode_bf16_map(m.map, m.base, 3, m.query ? qdims : kdims,
                                 m.query ? qstride : kstride, m.box, T::SWB);
    if (rc != 0) return rc;
  }
  const float* lp = static_cast<const float*>(lse);

  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_wgmma<D><<<dim3(b * hkv, (sk + T::ROWS - 1) / T::ROWS), THREADS,
                      T::SMEM, st>>>(q_s, do_s, k_b, v_b, dk_s, dv_s, lp, dp,
                                     hq, hkv, sq, sk, causal, q_offset,
                                     scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(bwd_dq_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_wgmma<D><<<dim3(b * hq, (sq + T::ROWS - 1) / T::ROWS), THREADS,
                    T::SMEM, st>>>(q_b, do_b, k_s, v_s, dq_s, lp, dp, hq,
                                   hkv, sq, sk, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
             int d, int causal, int q_offset, float scale, void* stream) {
  switch (d) {
    REPRO_FLASH_HEAD_DIMS(REPRO_FLASH_BWD_CASE)
#undef REPRO_FLASH_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// Plain C interface for ctypes: pointers and the stream are void*, the
// return value is the first error of the three launches (0 on success;
// hopper::error_string reads it).  `delta` is float32 (B, Hq, Sq)
// scratch; dq is shaped like q, dk and dv like k.
extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int hq, int hkv, int sq, int sk, int d, int causal,
    int q_offset, float scale, void* stream) {
  return dispatch(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq, hkv, sq,
                  sk, d, causal, q_offset, scale, stream);
}

// bfloat16 on the tensor cores; q, k, v, do 16-byte aligned (the wrapper
// checks).
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int hq, int hkv, int sq, int sk, int d, int causal,
    int q_offset, float scale, void* stream) {
  return tc::dispatch(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq, hkv,
                      sq, sk, d, causal, q_offset, scale, stream);
}

extern "C" const char* repro_flash_bwd_error_string(int code) {
  return hopper::error_string(code);
}
