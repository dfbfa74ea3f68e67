// Tiled matmul for Hopper (sm_90a): out = x @ y with an IEEE float32
// accumulator, out written in x's type (float32 or bfloat16).
//
// Replaces the Pallas TPU kernel `_matmul_kernel` / `matmul` in
// src/repro/kernels/matmul/matmul.py: grid (M/bm, N/bn, K/bk) with K
// innermost and an f32 VMEM accumulator zeroed at k=0 and cast to
// x.dtype on the last k.  Here each block owns one output tile and
// walks K itself in a loop (blocks run in parallel on the SMs, so no
// sum carries between blocks); the accumulator lives in registers.
//
// Tile: BM x BN = 64 x 64 outputs per block, 256 threads, each thread
// a 4 x 4 register tile; K advances in slices of BK = 16 staged through
// shared memory (bfloat16 widened to float32 on load; x stored
// transposed so a thread reads its 4 rows as one 16-byte load).  The
// ragged edge is masked (zero-filled loads, guarded stores), so the
// kernel takes any M, N, K.  The wrapper keeps the reference's block
// checks; the TPU-tuned (bm, bk, bn) do not steer this tiling.
//
// What bounds it on an H100 SXM at the main shape, (4096 x 1024) @
// (1024 x 3072) in bfloat16: 2*M*N*K = 25.8 GFLOP, about 26 us at the
// data sheet's 989 TFLOP/s of bf16 tensor cores; 39.8 MB of inputs and
// output, about 12 us at 3.35 TB/s — so the work is compute-bound.  An
// IEEE float32 FMA kernel cannot use the tensor cores (they round
// products to bf16/TF32 inputs), so this kernel's ceiling is the
// 67 TFLOP/s float32 rate: it trades speed for the reference's
// numerics (f32 within 1e-4 at K up to 1024).  No wgmma and no TMA
// yet; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
