// RMCM dequant-fused matrix product for Hopper (sm_90a), on the tensor
// cores:
//   y[m, n] = (sum_k x[m, k] * mag[k, n] * (1 - 2 s[k, n])) * scale[n]
// with x (M, K) f32 or bf16, mag (K, N) uint8, the signs bit-packed along K
// as (ceil(K / 8), N) uint8 (bit j of byte i is row 8i + j), scale (N,)
// f32, y (M, N) in x's type. The sum is f32 and the scale is applied once,
// after the whole K sum; a bf16 output is rounded to nearest even.
//
// Which TPU kernel it replaces (reference package, Pallas):
//   rmcm_wgmma_kernel  <- kernels/rmcm_matmul.py :: rmcm_matmul
//                         (body _kernel, sign decode _unpack_signs)
//
// What bounds it on this card: bytes, at both shapes it serves. A weight
// costs 1.125 bytes. At the NeRF trunk layer of one engine tile (M =
// 131072, K = N = 256, f32) x and y are 134 MB each, about 80 us at
// 3.35 TB/s, while the three bf16 passes take about 48 us at the bf16
// peak. At a decode shape (M = 16, K = 1536, N = 8960) the 15.5 MB of
// packed weight take about 4.8 us.
//
// What the design does about it:
// * wgmma with exact split products (mma_split.cuh): the signed magnitude
//   is exact in bf16; an f32 x is split into three bf16 pieces as its A
//   fragment is loaded into registers, a bf16 x is taken as it is (one
//   MMA per k step is then exact). One wgmma spans a warpgroup's whole
//   tile width. f32 accumulators, scale in the epilogue. For f32 x the
//   products of the two small pieces go to an accumulator of their own,
//   added to the large one once in the epilogue: the large one is rounded
//   once per k step instead of three times (the tensor cores' f32
//   additions are not rounded to nearest, so their errors do not cancel
//   over a long K).
// * The weight crosses device memory in its packed 1.125-byte form: the
//   magnitude and sign tiles of a 32-row K chunk are staged by the TMA
//   (two tiled bulk copies, their bytes counted on the stage's mbarrier;
//   out-of-range rows and columns land as zeros), the chunk's x rows by
//   16-byte cp.async, into a ring of stages. All threads decode a landed
//   chunk into a bf16 signed magnitude tile in the K-major layout wgmma
//   reads (double-buffered, so the decode of one chunk overlaps the MMAs
//   of the one before).
// * Persistent blocks walk their output tiles (and K chunks) as one
//   stream, so the loads of the next tile are in flight during the
//   epilogue of this one.
// * 128-row tiles, one warpgroup per 64 rows; 128 columns for bf16 x, 64
//   for f32 x (whose second accumulator doubles the registers); 32-row K
//   chunks, a ring of 3 stages: under 80 KB of shared memory and 128
//   registers a thread, so two blocks share an SM and one block's
//   barriers, decode and output stores overlap the other's loads and MMAs
//   (at one block per SM the staging, barriers and stores set the time:
//   PERF.md; kernels/probe.py, k3_f32_wide_one_block). Two routes
//   chosen by M (small M: M <= 64) share the kernel; where the output
//   tiles cannot fill the card's resident blocks (always at decode
//   shapes), K is split across blocks, the partial sums go to a scratch
//   buffer and a second launch adds them in a fixed order and applies the
//   scale. No float atomics: two calls on the same inputs give the same
//   bits.
// * The ragged edges of M, N and K are masked in the kernel; nothing is
//   padded. Where rows or the pointers are not 16-byte aligned the same
//   kernel stages with plain loads instead.
//
// Interface: plain C entry points for ctypes. rmcm_matmul_plan says which
// route a shape takes and how many K splits (the caller allocates the
// scratch); rmcm_matmul launches and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_split.cuh"

namespace {

using namespace mma_split;

constexpr int NT = 256;       // threads per block, two warpgroups
constexpr int BK = 32;        // K rows per staged chunk
constexpr int XS = BK + 8;    // x row stride in shared memory, elements
constexpr int BM = 128;       // output rows per tile, 64 per warpgroup
constexpr int STAGES = 3;     // the ring of staged K chunks
constexpr int SMALL_M = 64;   // M at or below this takes the small route

// the tile and shared-memory carve-up for x of type T
template <typename T>
struct Tile {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int BN = F32 ? 64 : 128;      // columns per tile
  static constexpr int BSTEP = BN * B_STEP_BYTES_PER_COL;   // a k16 step
  static constexpr int BBUF = (BK / 16) * BSTEP;           // a chunk of B
  static constexpr int X = BM * XS * (int)sizeof(T);
  static constexpr int MAG = BK * BN;
  static constexpr int SGN = (BK / 8) * BN;
  static constexpr int STAGE = X + MAG + SGN;   // a multiple of 128 bytes
  static constexpr int BYTES = 2 * BBUF + STAGES * STAGE + 8 * STAGES;
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// which output tile, K split and K chunks a work item is
struct Cursor {
  int item, kc, kend;
};

struct Shape {
  int M, K, N, nsplit, cps;   // cps: K chunks per split
  int ntn, nk, nwork;
};

__device__ __forceinline__ void seek(Cursor& c, int item, const Shape& s) {
  c.item = item;
  if (item < s.nwork) {
    c.kc = (item % s.nsplit) * s.cps;
    c.kend = min(s.nk, c.kc + s.cps);
  }
}

__device__ __forceinline__ void advance(Cursor& c, const Shape& s) {
  if (++c.kc == c.kend) seek(c, c.item + gridDim.x, s);
}

__device__ __forceinline__ int tile_m0(const Cursor& c, const Shape& s) {
  return c.item / (s.nsplit * s.ntn) * BM;
}
template <typename T>
__device__ __forceinline__ int tile_n0(const Cursor& c, const Shape& s) {
  return c.item / s.nsplit % s.ntn * Tile<T>::BN;
}

// stage one K chunk asynchronously: x rows by every thread's 16-byte
// cp.async (zeros outside), the magnitude and sign tiles by thread 0's two
// TMA copies, whose bytes the stage's mbarrier counts
template <typename T>
__device__ void issue_stage(uint8_t* st, uint64_t* bar, const T* x,
                            const CUtensorMap* tm_mag,
                            const CUtensorMap* tm_sgn, const Cursor& c,
                            const Shape& s) {
  using TL = Tile<T>;
  const int m0 = tile_m0(c, s), n0 = tile_n0<T>(c, s), k0 = c.kc * BK;
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, TL::MAG + TL::SGN);
    tma_load_2d(st + TL::X, tm_mag, n0, k0, bar);
    tma_load_2d(st + TL::X + TL::MAG, tm_sgn, n0, k0 / 8, bar);
  }
  constexpr int XE = 16 / sizeof(T);          // elements per 16 bytes
  constexpr int XC = BK / XE;                 // 16-byte pieces per row
  T* xs = reinterpret_cast<T*>(st);
  for (int e = threadIdx.x; e < BM * XC; e += NT) {
    const int r = e / XC, q = e % XC;
    const int gm = m0 + r, gk = k0 + q * XE;
    const bool ok = gm < s.M && gk < s.K;
    cp_async16(xs + r * XS + q * XE, ok ? x + (size_t)gm * s.K + gk : x,
               ok ? 16 : 0);
  }
}

// the same stage with plain loads by every thread, zeros outside
template <typename T>
__device__ void load_stage(uint8_t* st, const T* x, const uint8_t* mag,
                           const uint8_t* sgn, const Cursor& c,
                           const Shape& s) {
  using TL = Tile<T>;
  constexpr int BN = TL::BN;
  using U = typename std::conditional<sizeof(T) == 4, uint32_t,
                                      uint16_t>::type;
  U* xs = reinterpret_cast<U*>(st);
  uint8_t* ms = st + TL::X;
  uint8_t* ss = ms + TL::MAG;
  const int m0 = tile_m0(c, s), n0 = tile_n0<T>(c, s), k0 = c.kc * BK;
  const int M = s.M, K = s.K, N = s.N;
  const U* xu = reinterpret_cast<const U*>(x);
  for (int e = threadIdx.x; e < BM * BK; e += NT) {
    const int r = e / BK, q = e % BK;
    const int gm = m0 + r, gk = k0 + q;
    xs[r * XS + q] = (gm < M && gk < K) ? xu[(size_t)gm * K + gk] : U(0);
  }
  for (int e = threadIdx.x; e < BK * BN; e += NT) {
    const int r = e / BN, q = e % BN;
    const int gk = k0 + r, gn = n0 + q;
    ms[e] = (gk < K && gn < N) ? mag[(size_t)gk * N + gn] : 0;
  }
  for (int e = threadIdx.x; e < (BK / 8) * BN; e += NT) {
    const int r = e / BN, q = e % BN;
    const int gb = k0 / 8 + r, gn = n0 + q;
    ss[e] = (gb * 8 < K && gn < N) ? sgn[(size_t)gb * N + gn] : 0;
  }
}

// magnitude and sign bytes of a stage -> bf16 signed magnitudes in the
// K-major wgmma layout (mma_split.cuh); rows at or past vk become zero.
// One thread writes one column's 8 consecutive k (16 bytes).
template <typename T>
__device__ void decode(const uint8_t* ms, const uint8_t* ss, uint8_t* bb,
                       int vk) {
  constexpr int BN = Tile<T>::BN;
  for (int e = threadIdx.x; e < (BK / 8) * BN; e += NT) {
    const int n = e % BN, q = e / BN;
    const uint32_t sb = ss[q * BN + n];
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 8 * q + 2 * i;
      float a = k < vk ? (float)ms[k * BN + n] : 0.f;
      float b = k + 1 < vk ? (float)ms[(k + 1) * BN + n] : 0.f;
      if ((sb >> (2 * i)) & 1) a = -a;
      if ((sb >> (2 * i + 1)) & 1) b = -b;
      w[i] = bits(__floats2bfloat162_rn(a, b));
    }
    *reinterpret_cast<uint4*>(bb + (q / 2) * Tile<T>::BSTEP +
                              (n / 8) * B_SBO + (q % 2) * B_LBO +
                              (n % 8) * 16) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// two neighbouring x values of a row, zero at or past column vk
__device__ __forceinline__ float2 ldx2(const float* p, int col, int vk) {
  float2 v = *reinterpret_cast<const float2*>(p);
  if (col >= vk) v.x = 0.f;
  if (col + 1 >= vk) v.y = 0.f;
  return v;
}
__device__ __forceinline__ uint32_t ldx2(const __nv_bfloat16* p, int col,
                                         int vk) {
  uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  if (col >= vk) v = 0u;
  else if (col + 1 >= vk) v &= 0xFFFFu;
  return v;
}

// a thread's share of a warpgroup's 64 x BN tile
template <typename T>
using Acc = float[Tile<T>::BN / 2];
// the small pieces' accumulator: f32 x only
template <typename T>
using Lo = float[Tile<T>::F32 ? Tile<T>::BN / 2 : 1];

// acc (and, for f32 x, lo: the small pieces' products) += x chunk (the
// warpgroup's 64 rows) . decoded chunk at shared address bb. The A
// fragments of every k step are loaded and split before the first wgmma:
// wgmma reads A from the registers while it runs, so none may be written
// until the chunk's group is waited for.
template <typename T>
__device__ __forceinline__ void mma_chunk(Acc<T>& acc, Lo<T>& lo,
                                          const T* xs, uint32_t bb, int vk) {
  constexpr int KS = BK / 16;                  // k steps per chunk
  constexpr int PER = Tile<T>::F32 ? 12 : 4;
  constexpr int BN = Tile<T>::BN;
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const T* xr = xs + (64 * (threadIdx.x >> 7) + 16 * w4 + g) * XS + 2 * t;
  uint32_t q[KS * PER];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c0 = 16 * s + 2 * t;
    const T* p = xr + 16 * s;
    if constexpr (Tile<T>::F32) {
      const float2 v0 = ldx2(p, c0, vk), v1 = ldx2(p + 8 * XS, c0, vk);
      const float2 v2 = ldx2(p + 8, c0 + 8, vk);
      const float2 v3 = ldx2(p + 8 * XS + 8, c0 + 8, vk);
      const Bf16x3 a[4] = {split_bf16x3(v0.x, v0.y), split_bf16x3(v1.x, v1.y),
                           split_bf16x3(v2.x, v2.y), split_bf16x3(v3.x, v3.y)};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        q[s * PER + r] = a[r].l;
        q[s * PER + 4 + r] = a[r].m;
        q[s * PER + 8 + r] = a[r].h;
      }
    } else {
      q[s * PER + 0] = ldx2(p, c0, vk);
      q[s * PER + 1] = ldx2(p + 8 * XS, c0, vk);
      q[s * PER + 2] = ldx2(p + 8, c0 + 8, vk);
      q[s * PER + 3] = ldx2(p + 8 * XS + 8, c0 + 8, vk);
    }
  }
  fence_a(q);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (16 * s >= vk) break;                 // the same in every thread
    const uint64_t d = b_desc(bb + s * Tile<T>::BSTEP);
    const uint32_t* a = q + s * PER;
    if constexpr (Tile<T>::F32) {
      wgmma_bf16<BN>(lo, a[0], a[1], a[2], a[3], d);
      wgmma_bf16<BN>(lo, a[4], a[5], a[6], a[7], d);
      wgmma_bf16<BN>(acc, a[8], a[9], a[10], a[11], d);
    } else {
      wgmma_bf16<BN>(acc, a[0], a[1], a[2], a[3], d);
    }
  }
}

// the finished sums of one work item: y = acc * scale, or (split K) the
// raw partial sums into part[split]
template <typename T>
__device__ __forceinline__ void epilogue(const Acc<T>& acc, const Lo<T>& lo,
                                         int m0, int n0, int split,
                                         const Shape& s, const float* scale,
                                         T* y, float* part) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int M = s.M, N = s.N;
  const int row0 = m0 + 64 * (threadIdx.x >> 7) + 16 * w4 + g;
  const bool pairs = (N & 1) == 0;
  float* pdst = part ? part + (size_t)split * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < Tile<T>::BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * t;
    if (col >= N) continue;
    const bool two = col + 1 < N;
    const float s0 = pdst ? 1.f : scale[col];
    const float s1 = (pdst || !two) ? 1.f : scale[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const int e = 4 * i + 2 * h;
      float v0 = acc[e], v1 = acc[e + 1];
      if constexpr (Tile<T>::F32) {
        v0 = __fadd_rn(v0, lo[e]);
        v1 = __fadd_rn(v1, lo[e + 1]);
      }
      const size_t o = (size_t)row * N + col;
      if (pdst) {
        if (two && pairs) {
          store2(pdst + o, v0, v1);
        } else {
          pdst[o] = v0;
          if (two) pdst[o + 1] = v1;
        }
      } else {
        const float y0 = __fmul_rn(v0, s0), y1 = __fmul_rn(v1, s1);
        if (two && pairs) {
          store2(y + o, y0, y1);
        } else {
          store1(y + o, y0);
          if (two) store1(y + o + 1, y1);
        }
      }
    }
  }
}

template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(NT, 2)
rmcm_wgmma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mag,
                  const uint8_t* __restrict__ sgn,
                  const float* __restrict__ scale, T* __restrict__ y,
                  float* __restrict__ part, Shape s,
                  const __grid_constant__ CUtensorMap tm_mag,
                  const __grid_constant__ CUtensorMap tm_sgn) {
  using TL = Tile<T>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* const stages = smem + 2 * TL::BBUF;
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(stages + STAGES * TL::STAGE);
  auto stage = [=](int i) { return stages + i * TL::STAGE; };

  Cursor pc, cc;
  seek(pc, blockIdx.x, s);
  seek(cc, blockIdx.x, s);
  if constexpr (ALIGNED) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < STAGES; ++i) mbar_init(full + i, 1);
      mbar_init_fence();
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < STAGES - 1; ++i) {
      if (pc.item < s.nwork) {
        issue_stage<T>(stage(i), full + i, x, &tm_mag, &tm_sgn, pc, s);
        advance(pc, s);
      }
      cp_async_commit();
    }
  }

  Acc<T> acc;
  Lo<T> lo;
  zero_acc(acc);
  zero_acc(lo);
  fence_acc(acc);
  fence_acc(lo);

#pragma unroll 1
  for (int i = 0; cc.item < s.nwork; ++i) {
    const int slot = i % STAGES;
    if constexpr (ALIGNED) {
      cp_async_wait<STAGES - 2>();
      mbar_wait(full + slot, (i / STAGES) & 1);
      __syncthreads();   // chunk i landed; every thread is done with i - 1
      const int ps = (i + STAGES - 1) % STAGES;   // the slot i - 1 used
      if (pc.item < s.nwork) {
        issue_stage<T>(stage(ps), full + ps, x, &tm_mag, &tm_sgn, pc, s);
        advance(pc, s);
      }
      cp_async_commit();
    } else {
      __syncthreads();
      load_stage<T>(stage(slot), x, mag, sgn, cc, s);
      __syncthreads();
    }
    const int vk = min(BK, s.K - cc.kc * BK);
    uint8_t* bb = smem + (i & 1) * TL::BBUF;
    decode<T>(stage(slot) + TL::X, stage(slot) + TL::X + TL::MAG, bb, vk);
    fence_proxy_async();
    __syncthreads();   // the decoded chunk is visible to every warpgroup
    // chunk i - 1's MMAs (which ran during this decode) are done: its A
    // registers are free, and every warpgroup is past this wait before
    // the next decode overwrites its tile
    wgmma_wait<0>();
    mma_chunk<T>(acc, lo, reinterpret_cast<const T*>(stage(slot)),
                 smem_addr(bb), vk);
    wgmma_commit();
    if (cc.kc + 1 == cc.kend) {
      wgmma_wait<0>();
      fence_acc(acc);
      fence_acc(lo);
      epilogue<T>(acc, lo, tile_m0(cc, s), tile_n0<T>(cc, s),
                  cc.item % s.nsplit, s, scale, y,
                  s.nsplit > 1 ? part : nullptr);
      zero_acc(acc);
      zero_acc(lo);
      fence_acc(acc);
      fence_acc(lo);
    }
    advance(cc, s);
  }
  wgmma_wait<0>();
  if constexpr (ALIGNED) cp_async_wait<0>();
}

// y = (part[0] + part[1] + ... ) * scale, the splits added in order
template <typename T>
__global__ void rmcm_reduce_kernel(const float* __restrict__ part,
                                   const float* __restrict__ scale,
                                   T* __restrict__ y, int M, int N,
                                   int nsplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t MN = (size_t)M * N;
  if (i >= MN) return;
  float acc = part[i];
  for (int p = 1; p < nsplit; ++p) acc = __fadd_rn(acc, part[p * MN + i]);
  store1(y + i, __fmul_rn(acc, scale[i % N]));
}

// ---------------------------------------------------------- host side -----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, found through the runtime (no link
// against the driver library)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, cols) uint8 matrix with row stride cols, read in (box_rows,
// box_cols) tiles
bool byte_map(CUtensorMap* m, const void* base, int rows, int cols,
              int box_rows, int box_cols) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool A>
cudaError_t occupancy(int* blocks) {
  auto k = rmcm_wgmma_kernel<T, A>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<T>::BYTES);
  if (e) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, NT,
                                                       Tile<T>::BYTES);
}

// route 0 (large M) or 1 (small M), K splits, chunks per split, grid
template <typename T>
cudaError_t plan(int M, int K, int N, bool small, int* out) {
  int dev, sms, per_sm, per_sm_plain;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev))) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)))
    return e;
  if ((e = occupancy<T, true>(&per_sm))) return e;
  if ((e = occupancy<T, false>(&per_sm_plain))) return e;
  const int resident = min(per_sm, per_sm_plain) * sms;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int nk = (K + BK - 1) / BK;
  constexpr int BN = Tile<T>::BN;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  // K splits that make the busiest block's chunks fewest, a split costing
  // a quarter chunk (its partial sums and their reduction)
  int nsplit = 1;
  long best = -1;
  for (int sp = 1; sp <= nk; ++sp) {
    const int cps = (nk + sp - 1) / sp;
    if (sp > 1 && (nk + cps - 1) / cps != sp) continue;
    const long items = (long)tiles * sp;
    const long cost = 4L * ((items + resident - 1) / resident) * cps + sp - 1;
    if (best < 0 || cost < best) { best = cost; nsplit = sp; }
  }
  const int cps = (nk + nsplit - 1) / nsplit;
  out[0] = small ? 1 : 0;
  out[1] = nsplit;
  out[2] = cps;
  out[3] = (int)min((long)tiles * nsplit, (long)resident);
  return cudaSuccess;
}

template <typename T>
int launch(const void* x, const void* mag, const void* sgn, const void* scale,
           void* y, void* part, int M, int K, int N, const int* p,
           cudaStream_t st) {
  Shape s;
  s.M = M; s.K = K; s.N = N; s.nsplit = p[1]; s.cps = p[2];
  s.ntn = (N + Tile<T>::BN - 1) / Tile<T>::BN;
  s.nk = (K + BK - 1) / BK;
  s.nwork = ((M + BM - 1) / BM) * s.ntn * s.nsplit;
  if (s.nsplit > 1 && !part) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_mag = {}, tm_sgn = {};
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
      ((size_t)K * sizeof(T)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(mag) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(sgn) % 16 == 0) && N % 16 == 0;
  if (aligned && !(byte_map(&tm_mag, mag, K, N, BK, Tile<T>::BN) &&
                   byte_map(&tm_sgn, sgn, (K + 7) / 8, N, BK / 8,
                            Tile<T>::BN)))
    return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const uint8_t* mg = static_cast<const uint8_t*>(mag);
  const uint8_t* sg = static_cast<const uint8_t*>(sgn);
  const float* sc = static_cast<const float*>(scale);
  T* yt = static_cast<T*>(y);
  float* pt = static_cast<float*>(part);
  const int smem = Tile<T>::BYTES;
  cudaError_t e = aligned
      ? cudaFuncSetAttribute(rmcm_wgmma_kernel<T, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
      : cudaFuncSetAttribute(rmcm_wgmma_kernel<T, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return (int)e;
  if (aligned)
    rmcm_wgmma_kernel<T, true><<<p[3], NT, smem, st>>>(
        xt, mg, sg, sc, yt, pt, s, tm_mag, tm_sgn);
  else
    rmcm_wgmma_kernel<T, false><<<p[3], NT, smem, st>>>(
        xt, mg, sg, sc, yt, pt, s, tm_mag, tm_sgn);
  e = cudaGetLastError();
  if (e || s.nsplit == 1) return (int)e;
  const size_t mn = (size_t)M * N;
  rmcm_reduce_kernel<T><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      pt, sc, yt, M, N, s.nsplit);
  return (int)cudaGetLastError();
}

bool shape_ok(int M, int K, int N) { return M >= 1 && K >= 1 && N >= 1; }

}  // namespace

extern "C" {

// plan[4]: route (0 large M, 1 small M), K splits (> 1: the caller passes a
// (splits, M, N) f32 scratch), K chunks per split, blocks. Also sets the
// kernels' shared-memory limit.
int rmcm_matmul_plan(int M, int K, int N, int x_bf16, int* plan_out) {
  if (!shape_ok(M, K, N)) return (int)cudaErrorInvalidValue;
  const bool small = M <= SMALL_M;
  cudaError_t e;
  if (x_bf16)
    e = plan<__nv_bfloat16>(M, K, N, small, plan_out);
  else
    e = plan<float>(M, K, N, small, plan_out);
  return (int)e;
}

// x (M, K) and y (M, N) both f32 (x_bf16 = 0) or both bf16 (x_bf16 = 1);
// mag (K, N) and sgn (ceil(K / 8), N) uint8; scale (N,) f32; part the
// scratch of rmcm_matmul_plan's splits (or null); plan_in its plan.
int rmcm_matmul(const void* x, const void* mag, const void* sgn,
                const void* scale, void* y, void* part, int M, int K, int N,
                int x_bf16, const int* plan_in, void* stream) {
  if (!shape_ok(M, K, N) || plan_in[0] != (M <= SMALL_M ? 1 : 0) ||
      plan_in[1] < 1 || plan_in[2] < 1 || plan_in[3] < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16>(x, mag, sgn, scale, y, part, M, K, N,
                                 plan_in, st);
  return launch<float>(x, mag, sgn, scale, y, part, M, K, N, plan_in, st);
}

}  // extern "C"
