// Flash attention, forward, for Hopper (sm_90a): streaming softmax over
// key/value tiles with the running max, denominator and accumulator in
// float32.  Two kernels behind the C interface:
//
// - `flash_fwd_kernel` (IEEE float32 FMA on the CUDA cores): float32.
// - `flash_fwd_wgmma` (tensor cores, wgmma + TMA): bfloat16.
// The wrapper (kernels/flash_attention/flash_attention.py) sends every
// float32 call to the first and every bfloat16 call to the second.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py: grid (BH, Sq/bq,
// Sk/bkv) with the KV axis innermost, (m, l, acc) carried in VMEM
// scratch across it, scale 1/sqrt(D), positional causal mask with
// NEG_INF = -1e30, output acc / max(l, 1e-30) cast to the input type.
// Here one block owns one (batch*head, query tile) and walks the KV
// tiles itself in a loop (blocks run in parallel on the SMs, so no
// state carries between them); (m, l, acc) live in registers.
//
// Inputs: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), contiguous, with
// Hq % Hkv == 0.  Grouped-query attention reads KV head
// h / (Hq / Hkv) directly: nothing is repeated in memory.  A query row
// i sits at position q_offset + i and, when causal, sees keys
// j <= q_offset + i.  Ragged tails of Sq and Sk are masked here (rows
// past Sq are not stored, keys past Sk get probability exactly 0), and
// KV tiles wholly above the causal diagonal are skipped: they would add
// exact zeros.  Query tiles are walked last-first, so the blocks with
// the most KV tiles start first.
//
// What bounds it on an H100 SXM at the prefill shape of Qwen3-0.6B (4
// prompts x 4096 tokens, 16 query heads over 8 KV heads, D = 128, bf16,
// causal): the unmasked half of the work is 2.75e11 FLOP, about 0.28 ms
// at the data sheet's 989 TFLOP/s of bf16 tensor cores, while q, k, v
// and o are 201 MB, about 0.06 ms at 3.35 TB/s -- so it is bound by
// operations.
//
// SIMT kernel (float32): 256 threads as a 16 x 16 grid per 64-row query
// tile.  Thread (ty, tx) owns score rows 4ty..4ty+3 and columns
// 4tx..4tx+3 of each 64 x 64 score tile, and output rows 4ty..4ty+3 at
// columns tx + 16c.  Q is staged once and K per tile transposed in
// shared memory (a thread reads its 4 rows / 4 columns as one 16-byte
// load); V per tile row-major; the probabilities go through shared
// memory transposed for P @ V.  Row max and row sum reduce over the 16
// threads of a row with warp shuffles.  Shared memory: (2 D (64 + 4) +
// 64 D + 64 (64 + 4)) floats, 119,808 bytes at D = 128, set with
// cudaFuncSetAttribute above the default 48 KB.  IEEE float32 FMA
// cannot use the tensor cores, so its ceiling is the 67 TFLOP/s float32
// rate: it keeps the reference's numerics (f32 within 2e-5).  Against
// the operations it skips the masked KV tiles and keeps 8 FMA per
// 16-byte shared-memory load in the score loop.
//
// Tensor-core kernel (bfloat16), after FlashAttention-3's forward: one
// block owns 128 query rows of one (batch, head): a producer warpgroup
// whose one thread issues TMA, and two consumer warpgroups of 64 rows
// each.  Q is loaded once; K and V tiles of 128 keys go through
// 2-stage rings (at D = 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB
// of dynamic shared memory).  Rows of D are cut into boxes of 64
// elements with a 128-byte swizzle (two boxes at D = 128; at D = 32 one
// 32-element box with a 64-byte swizzle).  Per KV tile a consumer
// warpgroup runs S = Q K^T (wgmma, A = Q and B = the K tile, both
// K-major in shared memory: bf16 products are exact in float32, so
// these are the reference's f32 scores summed in another order), the
// online softmax on the float32 accumulator in registers (row max and
// row sum over the 4 lanes that share a row; exp2 with the scale folded
// in), then O += P V (wgmma with A = P from registers -- the score
// accumulator's layout is the A fragment's, packed to bf16 pairs -- and
// B = the V tile, N-major).  Rounding P to bf16 before P V is the one
// departure from the reference's float32 P; the output is bf16 too.
// Masked keys (past Sk or above the diagonal) get a score of -inf, so
// their probability is exactly 0 even where TMA zero-filled the tile.
// The loop overlaps the tensor cores with the softmax, as
// FlashAttention-3 does within a warpgroup: for tile t it issues
// S = Q K_t^T and then O += P_{t-1} V_{t-1}, waits for the scores only,
// runs tile t's softmax while P V is still on the tensor cores, then
// waits for P V, rescales O and packs P_t.  K and V slots have their
// own barriers, so a K slot goes back to the producer as soon as its
// scores are in and a V slot once the P V reading it has completed.
// Registers move from the producer warpgroup to the consumers
// (setmaxnreg 24 / 240).  The epilogue writes O / l in bf16 over the
// warpgroup's own Q rows in shared memory and stores it with TMA.
//
// Both kernels can also write each query row's log-sum-exp of its
// scaled scores, LSE = m + log(l) in natural units (float32, (B, Hq,
// Sq)), for the backward kernels (flash_attention_bwd.cu), which
// recompute P = exp(S * scale - LSE) from it.  A null `lse` pointer
// skips it: the serving path passes none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int PAD = 4;        // keeps transposed rows 16-byte aligned
constexpr int QLD = BQ + PAD;
constexpr int KLD = BKV + PAD;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

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
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int hq, int hkv, int sq,
                     int sk, int causal, int q_offset, float scale) {
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
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * sq + row] = m[i] + logf(den);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store_out(&ob[(size_t)row * D + c * 16 + tx], acc[i][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int hq, int hkv, int sq, int sk, int causal, int q_offset,
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
          static_cast<const T*>(v), static_cast<T*>(o), lse, hq, hkv, sq,
          sk, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int b, int hq, int hkv, int sq, int sk, int d,
             int causal, int q_offset, float scale, void* stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, b, hq, hkv, sq, sk, causal,
                           q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, b, hq, hkv, sq, sk, causal,
                           q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, b, hq, hkv, sq, sk, causal,
                            q_offset, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- bf16 tensor-core kernel ---------------------------------------------

namespace tc {

constexpr int BQ = 128;       // query rows per block: 2 warpgroups x 64
constexpr int BKV = 128;      // keys per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;

template <int D>
struct Tile {
  static constexpr int SWB = D >= 64 ? 128 : 64;  // swizzle bytes = box row
  static constexpr int BOXW = SWB / 2;            // elements per box row
  static constexpr int CHUNKS = D / BOXW;         // boxes across a row of D
  static constexpr int LAYOUT =
      SWB == 128 ? hopper::kSwizzle128B : hopper::kSwizzle64B;
  static constexpr int ATOM = 8 * SWB;            // 8 swizzled rows: SBO
  static constexpr int Q_BOX = BQ * SWB;          // bytes of one Q box
  static constexpr int KV_BOX = BKV * SWB;        // bytes of one K/V box
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES +
                                 (1 + 4 * STAGES) * sizeof(uint64_t);
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap,
                    float* __restrict__ lse, int hq, int hkv, int sq,
                    int sk, int causal, int q_offset, float scale_log2) {
  using namespace hopper;
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs = smem;                    // [CHUNKS][BQ rows][BOXW]
  uint8_t* ks = smem + T::Q_BYTES;       // [STAGES][CHUNKS][BKV][BOXW]
  uint8_t* vs = ks + STAGES * T::KV_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vs + STAGES * T::KV_BYTES);
  uint64_t* kfull = qbar + 1;  // K and V slots fill and drain apart
  uint64_t* kempty = kfull + STAGES;
  uint64_t* vfull = kempty + STAGES;
  uint64_t* vempty = vfull + STAGES;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], CONSUMER_WARPS);
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  // Keys below kv_end are visible to some row of this block.
  int kv_end = sk;
  if (causal) kv_end = min(sk, q_offset + min(q0 + BQ, sq));
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // Producer: Q once, then each tile's K and V through their rings.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c)
        tma_load_3d(qs + c * T::Q_BOX, &qmap, qbar, c * T::BOXW, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int round = t / STAGES;
        if (round > 0) mbar_wait(&kempty[s], (round - 1) & 1);
        mbar_arrive_expect_tx(&kfull[s], T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::CHUNKS; ++c)
          tma_load_3d(ks + s * T::KV_BYTES + c * T::KV_BOX, &kmap, &kfull[s],
                      c * T::BOXW, t * BKV, kvh);
        if (round > 0) mbar_wait(&vempty[s], (round - 1) & 1);
        mbar_arrive_expect_tx(&vfull[s], T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::CHUNKS; ++c)
          tma_load_3d(vs + s * T::KV_BYTES + c * T::KV_BOX, &vmap, &vfull[s],
                      c * T::BOXW, t * BKV, kvh);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int row_wg = (wg - 1) * 64;  // this warpgroup's first row
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int r = warp * 16 + lane / 4;  // rows r and r + 8 of the 64
    const int qpos0 = q_offset + q0 + row_wg + r;
    const int qpos1 = qpos0 + 8;
    const int first_qpos = q_offset + q0 + row_wg;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float sc[BKV / 2];         // scores, then probabilities, of a tile
    uint32_t pa[BKV / 16][4];  // the previous tile's P as A fragments
    float m0 = NEG_INF, m1 = NEG_INF;  // running max, in log2 units
    float l0 = 0.0f, l1 = 0.0f;        // this lane's share of the row sum
    float alpha0 = 1.0f, alpha1 = 1.0f;

    // S = Q K^T of tile t into sc: 64 x BKV per warpgroup, D/16 k-steps.
    auto issue_scores = [&](int t) {
      const uint8_t* kt = ks + (t % STAGES) * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / T::BOXW;
        const int within = (kk * 16 % T::BOXW) * 2;
        const uint64_t da = smem_desc(
            qs + c * T::Q_BOX + row_wg * T::SWB + within, 16, T::ATOM,
            T::LAYOUT);
        const uint64_t db =
            smem_desc(kt + c * T::KV_BOX + within, 16, T::ATOM, T::LAYOUT);
        wgmma_ss<0>(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of tile t: V is N-major (D contiguous); LBO = one box.
    auto issue_pv = [&](int t) {
      const uint8_t* vt = vs + (t % STAGES) * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t db = smem_desc(vt + kk * 16 * T::SWB, T::KV_BOX,
                                      T::ATOM, T::LAYOUT);
        wgmma_rs<1>(acc, pa[kk], db, 1);
      }
      wgmma_commit();
    };
    // Mask, then the online softmax of tile t in place in sc; sets the
    // factors (alpha) that rescale acc.
    auto softmax = [&](int t) {
      const int k0 = t * BKV;
      if (k0 + BKV > sk || (causal && k0 + BKV - 1 > first_qpos)) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int key = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          if (key >= sk || (causal && key > qpos)) sc[i] = -INFINITY;
        }
      }
      // Rows r (i % 4 < 2) and r + 8 (i % 4 >= 2).
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        if (i & 2) t1 = fmaxf(t1, sc[i]);
        else t0 = fmaxf(t0, sc[i]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
      }
      const float mn0 = fmaxf(m0, t0 * scale_log2);
      const float mn1 = fmaxf(m1, t1 * scale_log2);
      alpha0 = exp2f(m0 - mn0);
      alpha1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const float p = exp2f(fmaf(sc[i], scale_log2, (i & 2) ? -mn1 : -mn0));
        sc[i] = p;
        if (i & 2) rs1 += p;
        else rs0 += p;
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
    };
    // P of the current tile as the A fragments of BKV / 16 k-steps: the
    // score accumulator's elements 8kk .. 8kk+7, in order, in pairs.
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(qbar, 0);
    mbar_wait(&kfull[0], 0);
    wgmma_fence();
    issue_scores(0);
    wgmma_wait<0>();
    fence_regs(sc);
    release(&kempty[0]);
    softmax(0);
    pack_p();
    // Tile t's scores and tile t - 1's P V run on the tensor cores
    // while this warpgroup computes tile t's softmax.
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int sp = (t - 1) % STAGES;
      mbar_wait(&kfull[s], (t / STAGES) & 1);
      fence_regs(acc);
      wgmma_fence();
      issue_scores(t);
      mbar_wait(&vfull[sp], ((t - 1) / STAGES) & 1);
      issue_pv(t - 1);
      wgmma_wait<1>();  // the scores are in
      fence_regs(sc);
      release(&kempty[s]);
      softmax(t);
      wgmma_wait<0>();  // P V of tile t - 1 is in
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pa[kk]);
      release(&vempty[sp]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;
      pack_p();
    }
    const int last = n_tiles - 1;
    mbar_wait(&vfull[last % STAGES], (last / STAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
    issue_pv(last);
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pa[kk]);

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
    if (lse != nullptr && lane % 4 == 0) {
      // m is in log2 units with the scale folded in: LSE = ln 2 (m +
      // log2 l).
      const int row0 = q0 + row_wg + r;
      if (row0 < sq)
        lse[(size_t)bh * sq + row0] =
            (m0 + log2f(fmaxf(l0, 1e-30f))) * 0.6931471805599453f;
      if (row0 + 8 < sq)
        lse[(size_t)bh * sq + row0 + 8] =
            (m1 + log2f(fmaxf(l1, 1e-30f))) * 0.6931471805599453f;
    }
    // Epilogue: O / l in bf16 over this warpgroup's own Q rows in shared
    // memory (no other warpgroup reads them), in the swizzled layout of
    // the Q boxes; one thread stores the boxes, and TMA drops rows past
    // Sq.
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 / T::BOXW;
      const int within = (j * 8 % T::BOXW) * 2 + (lane % 4) * 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off =
            c * T::Q_BOX + (row_wg + r + 8 * h) * T::SWB + within;
        const float inv = h ? inv1 : inv0;
        *reinterpret_cast<uint32_t*>(qs + swizzled(off, T::SWB)) = pack_bf16(
            acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      }
    }
    fence_proxy_async();
    named_barrier_sync(wg, 128);
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c)
        tma_store_3d(&omap, qs + c * T::Q_BOX + row_wg * T::SWB,
                     c * T::BOXW, q0 + row_wg, bh);
      tma_store_wait();
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int hq, int hkv, int sq, int sk, int causal, int q_offset,
           float scale, void* stream) {
  using T = Tile<D>;
  CUtensorMap qmap, kmap, vmap, omap;
  const uint64_t qdims[3] = {D, (uint64_t)sq, (uint64_t)b * hq};
  const uint64_t qstride[2] = {D * 2, (uint64_t)sq * D * 2};
  const uint64_t kdims[3] = {D, (uint64_t)sk, (uint64_t)b * hkv};
  const uint64_t kstride[2] = {D * 2, (uint64_t)sk * D * 2};
  const uint32_t qbox[3] = {T::BOXW, BQ, 1};
  const uint32_t kbox[3] = {T::BOXW, BKV, 1};
  const uint32_t obox[3] = {T::BOXW, 64, 1};  // one warpgroup's rows
  int rc = hopper::encode_bf16_map(&qmap, q, 3, qdims, qstride, qbox, T::SWB);
  if (rc == 0)
    rc = hopper::encode_bf16_map(&kmap, k, 3, kdims, kstride, kbox, T::SWB);
  if (rc == 0)
    rc = hopper::encode_bf16_map(&vmap, v, 3, kdims, kstride, kbox, T::SWB);
  if (rc == 0)
    rc = hopper::encode_bf16_map(&omap, o, 3, qdims, qstride, obox, T::SWB);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (sq + BQ - 1) / BQ);
  flash_fwd_wgmma<D><<<grid, THREADS, T::SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, omap, lse, hq, hkv, sq, sk, causal, q_offset,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int b, int hq, int hkv, int sq, int sk, int d,
             int causal, int q_offset, float scale, void* stream) {
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, lse, b, hq, hkv, sq, sk, causal,
                        q_offset, scale, stream);
    case 64:
      return launch<64>(q, k, v, o, lse, b, hq, hkv, sq, sk, causal,
                        q_offset, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, lse, b, hq, hkv, sq, sk, causal,
                         q_offset, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// Plain C interface for ctypes: pointers and the stream are void*, the
// return value is the first CUDA error of the launch (0 on success).
// `lse` is a float32 (B, Hq, Sq) output, or null.
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int b, int hq, int hkv, int sq,
                                         int sk, int d, int causal,
                                         int q_offset, float scale,
                                         void* stream) {
  return dispatch<float>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv,
                         sq, sk, d, causal, q_offset, scale, stream);
}

// bfloat16 on the tensor cores; q, k, v 16-byte aligned (the wrapper
// checks).
extern "C" int repro_flash_attention_bf16_wgmma(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int hq, int hkv, int sq, int sk, int d, int causal, int q_offset,
    float scale, void* stream) {
  return tc::dispatch(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, sq,
                      sk, d, causal, q_offset, scale, stream);
}

extern "C" const char* repro_flash_error_string(int code) {
  return hopper::error_string(code);
}
