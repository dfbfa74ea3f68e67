// Tiled matmul for Hopper (sm_90a): out = x @ y with a float32
// accumulator, out written in x's type (float32 or bfloat16).  Two
// kernels behind one C interface each:
//
// - `matmul_kernel` (IEEE float32 FMA on the CUDA cores, any shape): the
//   float32 entry, and bfloat16 shapes the tensor-core kernel cannot
//   take (K or N not a multiple of 8: TMA needs 16-byte row strides).
// - `matmul_bf16_wgmma` (tensor cores): bfloat16 with K % 8 == 0 and
//   N % 8 == 0.  The wrapper (kernels/matmul/matmul.py `variant`)
//   chooses by shape and type alone.
//
// Replaces the Pallas TPU kernel `_matmul_kernel` / `matmul` in
// src/repro/kernels/matmul/matmul.py: grid (M/bm, N/bn, K/bk) with K
// innermost and an f32 VMEM accumulator zeroed at k=0 and cast to
// x.dtype on the last k.  Here each block owns one output tile and
// walks K itself in a loop (blocks run in parallel on the SMs, so no
// sum carries between blocks); the accumulator lives in registers.
// The wrapper keeps the reference's block checks; the TPU-tuned
// (bm, bk, bn) do not steer either tiling.
//
// What bounds it on an H100 SXM at the main shape, (4096 x 1024) @
// (1024 x 3072) in bfloat16: 2*M*N*K = 25.8 GFLOP, about 26 us at the
// data sheet's 989 TFLOP/s of bf16 tensor cores; 39.8 MB of inputs and
// output, about 12 us at 3.35 TB/s -- so the work is bound by operations.
//
// SIMT kernel: BM x BN = 64 x 64 outputs per block, 256 threads, each
// thread a 4 x 4 register tile; K advances in slices of BK = 16 staged
// through shared memory (bfloat16 widened to float32 on load; x stored
// transposed so a thread reads its 4 rows as one 16-byte load).  The
// ragged edge is masked (zero-filled loads, guarded stores).  An IEEE
// float32 FMA kernel cannot use the tensor cores, so its ceiling is the
// 67 TFLOP/s float32 rate: it keeps the reference's f32 numerics (within
// 1e-4 at K up to 1024).
//
// Tensor-core kernel: a bf16 x bf16 product is exact in float32, so
// wgmma with a float32 accumulator computes the reference's f32 dot
// products summed in another order.  One block owns a 128 x 256 output
// tile: a producer warpgroup (one thread issuing TMA) and two consumer
// warpgroups of 64 rows each, one m64n256k16 wgmma per 16-deep k-step.
// K moves in slices of 64 (128 bytes, the TMA swizzle width) through a
// ring of 4 stages of 48 KB in dynamic shared memory: x's 128 x 64 slice
// as one box (K-major A), y's 64 x 256 slice as four 64 x 64 boxes
// (N-major B, the transposed operand).  TMA zero-fills the ragged M, N
// and K tails.  The epilogue rounds to bf16 into shared memory (the
// drained ring) and writes the tile with TMA stores, which skip what
// lies past M or N; strided 4-byte stores straight from the
// accumulators were a large share of the kernel's time at K = 1024.
// Registers move from the producer warpgroup to the consumers
// (setmaxnreg 40 / 232) for the 128 float accumulators per thread.  A
// consumer keeps one k-tile's wgmma group in flight while it issues the
// next, and returns a slot to the producer once the group reading it
// has completed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // keeps rows 16-byte aligned, spreads banks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  T* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) float xs[BK][BM + PAD];  // xs[kk][row]
  __shared__ __align__(16) float ys[BK][BN + PAD];  // ys[kk][col]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int ty = tid / (BN / TN);  // 0..15: which 4 rows
  const int tx = tid % (BN / TN);  // 0..15: which 4 columns

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // x tile: BM rows x BK columns, consecutive threads along K.
#pragma unroll
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r, gc = k0 + c;
      xs[c][r] = (gr < m && gc < k) ? to_f32(x[(size_t)gr * k + gc]) : 0.0f;
    }
    // y tile: BK rows x BN columns, consecutive threads along N.
#pragma unroll
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = col0 + c;
      ys[r][c] = (gr < k && gc < n) ? to_f32(y[(size_t)gr * n + gc]) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&ys[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < n) store_out(&out[(size_t)gr * n + gc], acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, int m, int n, int k,
           void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 tensor-core kernel ---------------------------------------------

namespace tc {

constexpr int BM = 128;  // two consumer warpgroups of 64 rows
constexpr int BN = 256;  // one m64n256k16 per warpgroup and k-step
constexpr int BK = 64;   // 128 bytes of bf16: one swizzled row
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int A_BYTES = BM * BK * 2;       // 16 KB
constexpr int B_BOX_BYTES = BK * 64 * 2;   // 8 KB: 64 k-rows x 64 columns
constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2;  // 48 KB
constexpr int C_BOX_BYTES = 64 * 64 * 2;   // 8 KB: 64 rows x 64 columns
constexpr int C_BYTES = 64 * BN * 2;       // a warpgroup's output tile
constexpr size_t SMEM_BYTES =
    1024 + STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);

__global__ void __launch_bounds__(THREADS, 1)
    matmul_bf16_wgmma(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap ymap,
                      const __grid_constant__ CUtensorMap omap, int k) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (k + BK - 1) / BK;

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        const int round = kt / STAGES;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        uint8_t* a = smem + s * STAGE_BYTES;
        uint8_t* b = a + A_BYTES;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(a, &xmap, &full[s], kt * BK, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(b + c * B_BOX_BYTES, &ymap, &full[s], n0 + 64 * c,
                      kt * BK);
      }
    }
  } else {
    // Consumers: warpgroup wg - 1 owns rows 64 (wg - 1) .. + 63.
    setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    const int row_wg = (wg - 1) * 64;
    const int lane = threadIdx.x % 32;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint8_t* a = smem + s * STAGE_BYTES + row_wg * 128;
      const uint8_t* b = smem + s * STAGE_BYTES + A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: K-major, k-step = 32 bytes along the row.  B: N-major,
        // k-step = 16 rows of 128 bytes; LBO = one 64-column box.
        const uint64_t da = smem_desc(a + kk * 32, 16, 1024, kSwizzle128B);
        const uint64_t db =
            smem_desc(b + kk * 16 * 128, B_BOX_BYTES, 1024, kSwizzle128B);
        wgmma_ss<1>(acc, da, db, 1);
      }
      wgmma_commit();
      // Keep this k-tile's wgmma group in flight; once the previous
      // one has completed, its slot goes back to the producer.
      wgmma_wait<1>();
      fence_regs(acc);
      __syncwarp();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // Epilogue: once both consumer warpgroups are done with the ring,
    // each rounds its 64 x 256 tile to bf16 into shared memory in TMA's
    // 128-byte-swizzled layout (four 64-column boxes), and one thread
    // stores the boxes; TMA drops what lies past M or N.
    named_barrier_sync(1, 256);
    uint8_t* ctile = smem + (wg - 1) * C_BYTES;
    const int warp = (threadIdx.x % 128) / 32;
    const int r = warp * 16 + lane / 4;  // rows r and r + 8
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = (j / 8) * C_BOX_BYTES + (r + 8 * h) * 128 +
                             (j % 8) * 16 + (lane % 4) * 4;
        *reinterpret_cast<uint32_t*>(ctile + swizzled(off, 128)) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        tma_store_2d(&omap, ctile + c * C_BOX_BYTES, n0 + 64 * c,
                     m0 + row_wg);
      tma_store_wait();
    }
  }
}

int launch(const void* x, const void* y, void* out, int m, int n, int k,
           void* stream) {
  CUtensorMap xmap, ymap, omap;
  const uint64_t xdims[2] = {(uint64_t)k, (uint64_t)m};
  const uint64_t xstride[1] = {(uint64_t)k * 2};
  const uint32_t xbox[2] = {BK, BM};
  const uint64_t ydims[2] = {(uint64_t)n, (uint64_t)k};
  const uint64_t ystride[1] = {(uint64_t)n * 2};
  const uint32_t ybox[2] = {64, BK};
  const uint64_t odims[2] = {(uint64_t)n, (uint64_t)m};
  const uint32_t obox[2] = {64, 64};
  int rc = hopper::encode_bf16_map(&xmap, x, 2, xdims, xstride, xbox, 128);
  if (rc == 0)
    rc = hopper::encode_bf16_map(&ymap, y, 2, ydims, ystride, ybox, 128);
  if (rc == 0)
    rc = hopper::encode_bf16_map(&omap, out, 2, odims, ystride, obox, 128);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_bf16_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_bf16_wgmma<<<grid, THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      xmap, ymap, omap, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Plain C interface for ctypes: pointers and the stream are void*, the
// return value is cudaGetLastError() right after the launch.
extern "C" int repro_matmul_f32(const void* x, const void* y, void* out,
                                int m, int n, int k, void* stream) {
  return launch<float>(x, y, out, m, n, k, stream);
}

extern "C" int repro_matmul_bf16(const void* x, const void* y, void* out,
                                 int m, int n, int k, void* stream) {
  return launch<__nv_bfloat16>(x, y, out, m, n, k, stream);
}

// bfloat16 on the tensor cores: K % 8 == 0, N % 8 == 0, x and y 16-byte
// aligned (the wrapper checks).
extern "C" int repro_matmul_bf16_wgmma(const void* x, const void* y,
                                       void* out, int m, int n, int k,
                                       void* stream) {
  return tc::launch(x, y, out, m, n, k, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return hopper::error_string(code);
}
