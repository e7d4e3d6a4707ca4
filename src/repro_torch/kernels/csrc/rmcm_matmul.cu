// RMCM dequant-fused matrix product for Hopper (sm_90a):
//   y[m, n] = (sum_k x[m, k] * mag[k, n] * (1 - 2 s[k, n])) * scale[n]
// with x (M, K) f32 or bf16, mag (K, N) uint8, the signs bit-packed along K
// as (ceil(K / 8), N) uint8 (bit j of byte i is row 8i + j), scale (N,)
// f32, y (M, N) in x's type. The sum is f32 and the scale is applied once,
// after the whole K sum; a bf16 output is rounded to nearest even.
//
// Which TPU kernel it replaces (reference package, Pallas):
//   rmcm_matmul_kernel  <- kernels/rmcm_matmul.py :: rmcm_matmul
//                          (body _kernel, sign decode _unpack_signs)
//
// What bounds it on this card depends on M. A weight costs 1.125 bytes;
// with few rows (decode, M = 16 at K = 1536, N = 8960) the product does
// 2 * M operations per weight byte and the bound is the weight bytes over
// the memory rate. With many rows (the NeRF trunk at one engine tile,
// M = 131072, K = N = 256) it is the fp32 multiply-adds of the CUDA cores.
//
// What the design does about it (a first, simple version):
// * One block computes one 64 x 64 tile of y with 256 threads, each
//   holding a 4 x 4 block of sums in registers. K is walked in chunks of
//   32 rows: the block stages the x chunk (converted to f32), the
//   magnitude bytes and the sign bytes in shared memory, so the weight
//   crosses device memory in its packed 1.125-byte form, once per block.
// * The sign bit is decoded in the inner loop, beside the multiply-add:
//   the dequantized weight never exists in device memory.
// * The ragged edges of M, N and K are masked in the kernel; nothing is
//   padded. Rows of the last K chunk beyond K enter as zeros.
// * Consecutive blocks along grid x walk M over the same N tile, so the
//   weight tile they share is read from L2.
// * fp32 FMA throughout: no TF32, no tensor cores.
//
// Interface: a plain C entry point for ctypes; it launches one kernel on
// the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows of y per block
constexpr int BN = 64;        // columns of y per block
constexpr int BK = 32;        // K rows per staged chunk (a multiple of 8)
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int NT = (BM / TM) * (BN / TN);   // 256 threads
constexpr int XS = BK + 1;    // x row stride in shared memory (no conflicts)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
rmcm_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mag,
                   const uint8_t* __restrict__ sgn,
                   const float* __restrict__ scale, T* __restrict__ y,
                   int M, int K, int N) {
  __shared__ float xs[BM * XS];                  // x chunk, (BM, BK) + pad
  __shared__ __align__(16) uint8_t ms[BK * BN];  // magnitudes, (BK, BN)
  __shared__ __align__(16) uint8_t ss[(BK / 8) * BN];  // sign bytes

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);     // column group
  const int ty = tid / (BN / TN);     // row group
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x chunk: consecutive threads read consecutive k of one row
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r * XS + c] =
          (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.0f;
    }
    // magnitude chunk: consecutive threads read consecutive n of one k row
    for (int e = tid; e < BK * BN; e += NT) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      ms[e] = (gk < K && gn < N) ? mag[(size_t)gk * N + gn] : 0;
    }
    // sign chunk: BK / 8 packed rows; k0 is a multiple of 8
    for (int e = tid; e < (BK / 8) * BN; e += NT) {
      const int r = e / BN, c = e % BN;
      const int gb = k0 / 8 + r, gn = n0 + c;
      ss[e] = (gb * 8 < K && gn < N) ? sgn[(size_t)gb * N + gn] : 0;
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[(ty * TM + i) * XS + k];
      const uchar4 mq = *reinterpret_cast<const uchar4*>(&ms[k * BN + tx * TN]);
      const uchar4 sq =
          *reinterpret_cast<const uchar4*>(&ss[(k / 8) * BN + tx * TN]);
      const int bit = k % 8;
      // signed magnitude, exact in f32: mag * (1 - 2 s)
      const float w[TN] = {
          ((sq.x >> bit) & 1) ? -(float)mq.x : (float)mq.x,
          ((sq.y >> bit) & 1) ? -(float)mq.y : (float)mq.y,
          ((sq.z >> bit) & 1) ? -(float)mq.z : (float)mq.z,
          ((sq.w >> bit) & 1) ? -(float)mq.w : (float)mq.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: the per-column scale once, after the whole K sum
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx * TN + j;
    if (gn >= N) continue;
    const float s = scale[gn];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty * TM + i;
      if (gm < M) store(&y[(size_t)gm * N + gn], acc[i][j] * s);
    }
  }
}

template <typename T>
int launch(const void* x, const void* mag, const void* sgn, const void* scale,
           void* y, int M, int K, int N, cudaStream_t st) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  rmcm_matmul_kernel<T><<<grid, NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mag),
      static_cast<const uint8_t*>(sgn), static_cast<const float*>(scale),
      static_cast<T*>(y), M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) and y (M, N) both f32 (x_bf16 = 0) or both bf16 (x_bf16 = 1);
// mag (K, N) and sgn (ceil(K / 8), N) uint8; scale (N,) f32.
int rmcm_matmul(const void* x, const void* mag, const void* sgn,
                const void* scale, void* y, int M, int K, int N, int x_bf16,
                void* stream) {
  if (M < 1 || K < 1 || N < 1 || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, mag, sgn, scale, y, M, K, N, st)
                : launch<float>(x, mag, sgn, scale, y, M, K, N, st);
}

}  // extern "C"
