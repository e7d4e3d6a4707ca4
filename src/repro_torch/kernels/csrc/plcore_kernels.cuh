// Fused PLCore kernels for Hopper (sm_90a): the whole NeRF pass, PEU ->
// MLP engine -> VRU, inside one thread block per ray tile. This header
// holds the kernels as templates over the layer widths (W, C) and the
// weight formats; each plcore_w*.cu instantiates them for one width pair
// (one translation unit per pair and format family, so nvcc builds them in
// parallel), and fused_plcore.cu holds the C entry points that pick the
// instance.
//
// Which TPU kernel each __global__ replaces (reference package, Pallas):
//   plcore_fused_kernel     <- kernels/fused_plcore.py :: fused_plcore_call
//                              (body _make_kernel -> _pass_body)
//   plcore_two_pass_kernel  <- kernels/fused_plcore.py :: two_pass_plcore_call
//                              (body _make_two_pass_kernel -> _two_pass_tile)
//
// What bounds them on this card: operations. One network costs 589,952
// multiply-adds per sample at full width (8x256 trunk, 256-wide
// sigma|feat head, 128-wide color branch); a rendered pixel runs 64 coarse
// + 192 fine samples, about 151 M multiply-adds (302 MFLOP). Bytes are
// negligible: 24 B of rays in, 44 B of pixels out, weights re-read from L2.
// So the bound is the tensor cores' rate for the split products below.
//
// What the design does about it:
// * The MLP layers (trunk, feature head, the feature part of the color
//   layer) run on wgmma with exact split products (mma_split.cuh). RMCM
//   (Q): bf16x3 activations x exact bf16 signed magnitudes, the column
//   scale, bias and ReLU in the epilogue. f32: 3xTF32 over weights split
//   into hi/lo at pack time.
// * A block of two warpgroups owns whole rays and walks its tile one ray
//   at a time, 128 samples per chunk: each warpgroup takes 64 samples and
//   every column of a layer (W / 2 f32 accumulators a thread), one wgmma
//   per split piece and k step spanning them all. The widths are template
//   parameters, so the wgmma N of every layer is an immediate and the
//   pipeline has no branch; in a chunk shorter than 128 samples (the
//   coarse pass; every pass at the small widths) the rows past the ray's
//   samples are computed and never stored. The activations of a chunk live
//   in shared memory as (sample x feature) f32 rows; the A fragments are
//   loaded from there and split as they are loaded, so the pieces never
//   take shared memory. A layer's output overwrites its input after a
//   barrier, so one buffer holds the chunk.
// * The weights of a network are one stream in device memory (built at
//   pack time, kernels/ops.py mma_stream), in the order the layers read
//   them and in the K-major layout wgmma reads, so each k step (16 rows
//   bf16, 8 rows TF32 hi + lo) is one contiguous bulk copy, kept in flight
//   in a ring of slots across layer and chunk borders (an mbarrier per
//   slot counts the bytes that landed; the warpgroup that releases a slot
//   last refills it, so neither waits for the other), so the weight reads
//   from L2 overlap the MMAs. One weight pass serves 128 samples. K2 with
//   two weight formats gives each network a ring of its own (barriers and
//   bookkeeping) over the same slot memory, sized for the larger.
// * The rest keeps its fp32 code and its explicitly rounded order: the
//   exact sigma and rgb heads, the per-ray direction part of the color
//   layer, the VRU prefix, the coarse CDF, the inverse-CDF binary search
//   and the sorted merge. The prefix sums run sequentially per ray, in the
//   order cumsum adds, with explicitly rounded operations (no FMA
//   contraction), because the resampler turns last-ulp differences into
//   moved samples. Coarse weights, sample positions and resample scratch
//   never leave shared memory.
// * With early ray termination or an alive mask, a dead ray skips its
//   fine pass and keeps its coarse rgb/acc/depth (per ray, no compaction).
//
// Shared memory of one block at full width (W = 256, pe = 63 padded to
// 64, 64 + 192 samples): the weight ring (5 x 8 KB bf16 or 3 x 16 KB
// TF32), its mbarriers, activations 128 x 264 (bf16x3) or 128 x 260
// (TF32) f32, position encoding 128 x 72 or 128 x 68 f32, per-sample and
// resample scratch (11,952 B): 225,024 B (RMCM) or 229,088 B (f32), one
// block per SM. K2 with two formats takes the TF32 strides (the bf16x3
// A loads then meet 2-way bank conflicts) and the 48 KB ring: 229,168 B.
// At the small widths (W <= 64) the ring has 8 slots, two blocks fit on
// an SM (128 registers a thread), and each k step's products are summed
// apart and added to the layer's sums with rounded adds (mma_segment). The
// host reads the resident blocks per SM from plcore_blocks_per_sm.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_split.cuh"

namespace {

using namespace mma_split;

constexpr int NT = 256;       // threads per block, two warpgroups
constexpr int S = 128;        // samples per chunk, 64 per warpgroup

template <bool Q>
__host__ __device__ constexpr int kstep() { return Q ? 16 : 8; }
// bytes of one k step of one column: bf16, or TF32 hi and lo
template <bool Q>
__host__ __device__ constexpr int col_bytes() { return Q ? 32 : 64; }
template <int W, bool Q>
__host__ __device__ constexpr int ring_slots() { return W >= 256 ? (Q ? 5 : 3) : 8; }
template <int W, bool Q>
__host__ __device__ constexpr int slot_bytes() { return W * col_bytes<Q>(); }
// resident blocks per SM the register budget is set for
template <int W>
__host__ __device__ constexpr int min_blocks() { return W >= 256 ? 1 : 2; }

struct Mat {
  const float* w;       // f32 (rows, ncol), or null under RMCM
  const uint8_t* mag;   // RMCM magnitudes (rows, ncol)
  const uint8_t* sgn;   // RMCM sign bits (rows / 8, ncol)
  const float* scl;     // RMCM per-column scale (ncol)
  int ncol;
};

struct Net {
  const float* tb;      // (L, W)
  const float* sw;      // (W, 1)
  const float* sb;      // (1)
  const float* fb;      // (W)
  Mat color;            // (P2, C): its direction rows, per ray
  const float* cb;      // (C)
  const float* rw;      // (C, 3)
  const float* rb;      // (3)
  const float* tscl;    // RMCM column scales of the trunk (L, W), or null
  const float* fscl;    // ... of the feature head (W), or null
  const uint8_t* stream;   // the MLP weights in reading order (ops.mma_stream)
};

struct Dims {
  int R, rt, W, L, skip_mask, C, pos_freqs, dir_freqs, pe, de, P, P2, kpe;
};

// rows of the activation / encoding buffers: the stride is the width
// rounded up to 32 floats, plus 8 (bf16x3: conflict-free float2 loads of
// the A fragments) or 4 (3xTF32: conflict-free scalar loads)
__host__ __device__ inline int stride(int n, bool q) {
  return ((n + 31) & ~31) + (q ? 8 : 4);
}

// the shared-memory carve-up of one block
struct Smem {
  uint8_t* ring;    // weight ring: the slots of each network's ring
  uint64_t* full;   // per slot: its bytes landed (a ring per format)
  int* rel;         // per slot: warpgroups done with its step
  int as, ps;   // row strides of act and pe
  float* act;   // S x as: hidden activations of a chunk
  float* pe;    // S x ps: position encoding of a chunk
  float* ped;   // de: direction encoding of the ray
  float* cold;  // C: direction part of the color layer
  float* ray;   // 8: o, d
  float* res;   // 8: rgb, acc, depth of the last pass
  float* sig;   // N: raw density per sample
  float* rgb;   // 3N: color per sample
  float* wbuf;  // N: VRU weights per sample
  float* ts;    // N: sample positions
  float* dl;    // N: sample spacing
  // two-pass scratch
  float* tc; float* dlc; float* cdf; float* u; float* tf;
};

__host__ __device__ inline int rup4(int v) { return (v + 3) & ~3; }

// rings of a block whose coarse network has format QC and fine QF: one
// when they agree, else one each; the slot memory is the larger ring's
template <int W, bool QC, bool QF>
__host__ __device__ constexpr int ring_barriers() {
  return ring_slots<W, QC>() + (QC == QF ? 0 : ring_slots<W, QF>());
}
template <int W, bool QC, bool QF>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)ring_slots<W, QC>() * slot_bytes<W, QC>() >
                 (size_t)ring_slots<W, QF>() * slot_bytes<W, QF>()
             ? (size_t)ring_slots<W, QC>() * slot_bytes<W, QC>()
             : (size_t)ring_slots<W, QF>() * slot_bytes<W, QF>();
}

template <int W, bool QC, bool QF>
__host__ __device__ inline size_t carve(Smem* sm, uint8_t* base,
                                        const Dims& D, int N, int Nc,
                                        int Nf) {
  constexpr int NB = ring_barriers<W, QC, QF>();
  constexpr size_t RB = ring_bytes<W, QC, QF>();
  // the bf16x3 strides only when every pass is bf16x3
  constexpr bool QS = QC && QF;
  uint8_t* ring = base;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + RB);
  int* rel = reinterpret_cast<int*>(bars + NB);
  float* p = reinterpret_cast<float*>(bars + 2 * NB);
  float* const fbase = p;
  auto take = [&](int n) { float* q = p; p += rup4(n); return q; };
  const int rows = D.W > D.C ? D.W : D.C;
  Smem s;
  s.ring = ring;
  s.full = bars;
  s.rel = rel;
  s.as = stride(rows, QS);
  s.ps = stride(D.kpe, QS);
  s.act = take(S * s.as);
  s.pe = take(S * s.ps);
  s.ped = take(D.de);
  s.cold = take(D.C);
  s.ray = take(8);
  s.res = take(8);
  s.sig = take(N);
  s.rgb = take(3 * N);
  s.wbuf = take(N);
  s.ts = take(N);
  s.dl = take(N);
  s.tc = take(Nc);
  s.dlc = take(Nc);
  s.cdf = take(Nc);
  s.u = take(Nf);
  s.tf = take(Nf);
  if (sm) *sm = s;
  return RB + 16 * NB + (size_t)(p - fbase) * sizeof(float);
}

template <bool Q>
__device__ __forceinline__ float wget(const Mat& m, int k, int j, float scl) {
  if constexpr (Q) {
    float mv = (float)m.mag[k * m.ncol + j];
    float sg = (float)((m.sgn[(k >> 3) * m.ncol + j] >> (k & 7)) & 1);
    return mv * (1.0f - 2.0f * sg) * scl;
  } else {
    return __ldg(m.w + k * m.ncol + j);
  }
}

// --------------------------------------------------------- weight ring ----
// One pass's weight stream: `total` k steps, the network's stream read
// chunk after chunk (`per_chunk` steps each), through ring_slots() slots.
// A slot's full barrier counts the bytes of its bulk copy; both
// warpgroups release a slot through its counter, and the warpgroup that
// releases it last refills it, so neither ever waits for the other.
template <int W, bool Q>
struct Ring {
  static constexpr int NS = ring_slots<W, Q>();
  static constexpr int SB = slot_bytes<W, Q>();
  uint8_t* ring;        // the slots
  uint64_t* full;       // per slot: its bytes landed
  int* rel;             // per slot: warpgroups done with its step
  const uint8_t* src;   // the network's stream
  int C;
  int per_chunk, color_from;   // steps per chunk; first step of color0
  int total;            // steps of this pass
  int gs;               // steps consumed, over the kernel's life
  int start;            // gs at the start of this pass
  int released;         // steps of this pass this warpgroup released

  // the k step q (within a chunk) of the stream: its offset and bytes
  __device__ __forceinline__ void locate(int q, size_t* off,
                                         uint32_t* bytes) const {
    const uint32_t sw = (uint32_t)W * col_bytes<Q>();
    if (q < color_from) {
      *off = (size_t)q * sw;
      *bytes = sw;
    } else {
      *bytes = (uint32_t)C * col_bytes<Q>();
      *off = (size_t)color_from * sw + (size_t)(q - color_from) * *bytes;
    }
  }

  // step p of the pass -> its slot (one thread; the slot is free)
  __device__ __forceinline__ void issue(int p) {
    const int slot = (start + p) % NS;
    size_t off;
    uint32_t bytes;
    locate(p % per_chunk, &off, &bytes);
    mbar_expect_tx(full + slot, bytes);
    bulk_copy(ring + slot * SB, src + off, bytes, full + slot);
  }

  // every thread, at the start of a pass (both warpgroups are done with
  // every slot): thread 0 fills the ring
  __device__ void begin(const uint8_t* stream, int steps) {
    src = stream;
    total = steps;
    start = gs;
    released = 0;
    if (threadIdx.x == 0)
      for (int p = 0; p < min(NS, total); ++p) issue(p);
    __syncwarp();
  }

  // wait for the next step; its slot's shared address
  __device__ __forceinline__ uint32_t acquire() {
    mbar_wait(full + gs % NS, (gs / NS) & 1);
    __syncwarp();
    return smem_addr(ring + (gs % NS) * SB);
  }

  // this warpgroup's MMAs of its last step are done; the second
  // warpgroup to get here refills the slot with the step NS later
  __device__ __forceinline__ void release() {
    if ((threadIdx.x & 127) == 0) {
      int* r = rel + (start + released) % NS;
      __threadfence_block();
      if (atomicAdd(r, 1) == 1) {
        *r = 0;
        if (released + NS < total) issue(released + NS);
      }
    }
    ++released;
    __syncwarp();
  }
};

// a thread's share of a warpgroup's 64 x W tile
template <int W>
using Acc = float[W / 2];

// acc += in[the warpgroup's 64 rows][nk k steps] . the next nk steps of
// the ring, a layer N columns wide (W or C); `in` is (sample x feature)
// with row stride ld. Per k step the A fragment is loaded and split, then
// three wgmmas of the full width (bf16x3: l, m, h; 3xTF32: a_lo.b_hi,
// a_hi.b_lo, a_hi.b_hi) make one commit group, waited for before the next
// step writes its A registers: wgmma reads A from the registers while it
// runs. The other warpgroup's MMAs fill the tensor cores meanwhile.
template <int W, bool Q, int N>
__device__ __forceinline__ void mma_segment(Acc<W>& acc, Ring<W, Q>& rg,
                                            const float* in, int ld, int nk) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x >> 7;
  const int g = lane >> 2, t = lane & 3;
  const float* a = in + (64 * wg + 16 * w4 + g) * ld + (Q ? 2 * t : t);
  constexpr uint32_t LO = (N * B_STEP_BYTES_PER_COL) >> 4;   // TF32 lo block
  // The tensor cores' f32 additions truncate. At the full width every
  // register holds the layer's accumulators, so the k steps accumulate on
  // the tensor cores; below it (split_sum), each k step's products go to
  // zeroed registers of their own and are added to the layer's sums with
  // rounded f32 adds, so the truncation stays inside one k step's sum.
  constexpr bool split_sum = W <= 64;
  Acc<W> part;
  float* d_out;
  if constexpr (split_sum) d_out = part; else d_out = acc;
#pragma unroll 1
  for (int j = 0; j < nk; ++j, a += kstep<Q>()) {
    const uint64_t d = b_desc(rg.acquire());
    if constexpr (split_sum) {
      zero_acc(part);
      fence_acc(part);
    }
    if constexpr (Q) {
      const float2 v0 = *reinterpret_cast<const float2*>(a);
      const float2 v1 = *reinterpret_cast<const float2*>(a + 8 * ld);
      const float2 v2 = *reinterpret_cast<const float2*>(a + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(a + 8 * ld + 8);
      const Bf16x3 q0 = split_bf16x3(v0.x, v0.y), q1 = split_bf16x3(v1.x, v1.y);
      const Bf16x3 q2 = split_bf16x3(v2.x, v2.y), q3 = split_bf16x3(v3.x, v3.y);
      uint32_t p[12] = {q0.l, q1.l, q2.l, q3.l, q0.m, q1.m, q2.m, q3.m,
                        q0.h, q1.h, q2.h, q3.h};
      fence_a(p);
      wgmma_fence();
      wgmma_bf16<N>(d_out, p[0], p[1], p[2], p[3], d);
      wgmma_bf16<N>(d_out, p[4], p[5], p[6], p[7], d);
      wgmma_bf16<N>(d_out, p[8], p[9], p[10], p[11], d);
    } else {
      const Tf32x2 q0 = split_tf32(a[0]), q1 = split_tf32(a[8 * ld]);
      const Tf32x2 q2 = split_tf32(a[4]), q3 = split_tf32(a[8 * ld + 4]);
      uint32_t p[8] = {q0.lo, q1.lo, q2.lo, q3.lo, q0.hi, q1.hi, q2.hi, q3.hi};
      fence_a(p);
      wgmma_fence();
      wgmma_tf32<N>(d_out, p[0], p[1], p[2], p[3], d);
      wgmma_tf32<N>(d_out, p[4], p[5], p[6], p[7], d + LO);
      wgmma_tf32<N>(d_out, p[4], p[5], p[6], p[7], d);
    }
    wgmma_commit();
    ++rg.gs;
    wgmma_wait<0>();
    rg.release();
    if constexpr (split_sum) {
      fence_acc(part);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
  }
}

// start a layer: zero accumulators, fenced before the first wgmma
template <int W>
__device__ __forceinline__ void mma_start(Acc<W>& acc) {
  zero_acc(acc);
  fence_acc(acc);
}

// after a layer's last step: acc is final
template <int W>
__device__ __forceinline__ void mma_finish(Acc<W>& acc) { fence_acc(acc); }

// out[s][j] = act(((acc * scl[j]) + b1[j]) + b2[j]) for the warpgroup's
// 64 rows and the layer's N columns; scl only under RMCM, b2 may be null
template <int W, bool Q, int N>
__device__ __forceinline__ void store(float* out, int ld, const Acc<W>& acc,
                                      const float* scl, const float* b1,
                                      const float* b2, bool relu) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * (threadIdx.x >> 7) + 16 * w4 + g;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int j = 8 * i + 2 * t;
    const float s0 = Q ? scl[j] : 1.f, s1 = Q ? scl[j + 1] : 1.f;
    const float c0 = b1[j], c1 = b1[j + 1];
    const float d0 = b2 ? b2[j] : 0.f, d1 = b2 ? b2[j + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y0 = acc[4 * i + 2 * h], y1 = acc[4 * i + 2 * h + 1];
      if (Q) { y0 = __fmul_rn(y0, s0); y1 = __fmul_rn(y1, s1); }
      y0 = __fadd_rn(y0, c0);
      y1 = __fadd_rn(y1, c1);
      if (b2) { y0 = __fadd_rn(y0, d0); y1 = __fadd_rn(y1, d1); }
      if (relu) { y0 = fmaxf(y0, 0.f); y1 = fmaxf(y1, 0.f); }
      *reinterpret_cast<float2*>(out + (r0 + 8 * h) * ld + j) =
          make_float2(y0, y1);
    }
  }
}

// [x, sin(x), cos(x), sin(2x), cos(2x), ...] by the double-angle recurrence,
// written to rows of `out` (row stride `stride`, column `col`)
__device__ __forceinline__ void encode(float x, int a, int n_freqs, float* out,
                                       int stride, int col) {
  out[a * stride + col] = x;
  float s = sinf(x), c = cosf(x);
  for (int f = 0; f < n_freqs; ++f) {
    out[(3 + 6 * f + a) * stride + col] = s;
    out[(3 + 6 * f + 3 + a) * stride + col] = c;
    const float s2 = __fmul_rn(2.0f, s);
    const float ns = __fmul_rn(s2, c);
    c = __fsub_rn(1.0f, __fmul_rn(s2, s));
    s = ns;
  }
}

// normalized direction -> ped (every thread of the block calls it)
__device__ void encode_dir(const Dims& D, Smem& sm) {
  if (threadIdx.x < 3) {
    const float* d = sm.ray + 3;
    const float ss = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]),
                                         __fmul_rn(d[1], d[1])),
                               __fmul_rn(d[2], d[2]));
    const float dn = __fmul_rn(d[threadIdx.x], rsqrtf(ss));
    encode(dn, threadIdx.x, D.dir_freqs, sm.ped, 1, 0);
  }
  __syncthreads();
}

// k steps of one network's stream per chunk, and the first of color0's
template <bool Q>
__device__ __forceinline__ void stream_steps(const Dims& D, int* per_chunk,
                                             int* color_from) {
  const int nkh = D.W / kstep<Q>(), nkp = D.kpe / kstep<Q>();
  const int nskip = __popc(D.skip_mask & ~1 & ((1 << D.L) - 1));
  *color_from = nkp + (D.L - 1) * nkh + nskip * nkp + nkh;
  *per_chunk = *color_from + nkh;
}

// One PEU -> MLP -> VRU pass of one ray over N samples at ts / dl. Leaves
// rgb, acc, depth in sm.res and the per-sample weights in sm.wbuf. Every
// thread of the block calls it.
template <int W, int C, bool Q>
__device__ void ray_pass(const Net& net, const Dims& D, Smem& sm,
                         Ring<W, Q>& rg, const float* ts, const float* dl,
                         int N) {
  const int tid = threadIdx.x;
  const int as = sm.as, ps = sm.ps;
  const int nkh = W / kstep<Q>(), nkp = D.kpe / kstep<Q>();
  const float* o = sm.ray;
  const float* d = sm.ray + 3;

  // direction part of the color layer, once per ray and network
  for (int j = tid; j < C; j += NT) {
    const float scl = Q ? net.color.scl[j] : 0.f;
    float s = 0.f;
    for (int k = 0; k < D.de; ++k)
      s = fmaf(sm.ped[k], wget<Q>(net.color, W + k, j, scl), s);
    sm.cold[j] = s;
  }

  rg.begin(net.stream, rg.per_chunk * ((N + S - 1) / S));
  Acc<W> acc;
  for (int c0 = 0; c0 < N; c0 += S) {
    const int rows = min(S, N - c0);
    // ---- PEU: positions of this chunk, double-angle encoded; the K
    // padding is zero. The rows past N (up to the chunk's 128) repeat
    // sample N - 1, so every row the MMAs read is finite; they are never
    // stored.
    for (int idx = tid; idx < 3 * S; idx += NT) {
      const int s = idx / 3, a = idx % 3;
      const int n = min(c0 + s, N - 1);
      const float x = __fadd_rn(o[a], __fmul_rn(ts[n], d[a]));
      encode(x, a, D.pos_freqs, sm.pe + s * ps, 1, 0);
    }
    const int npad = D.kpe - D.pe;
    for (int idx = tid; idx < S * npad; idx += NT)
      sm.pe[(idx / npad) * ps + D.pe + idx % npad] = 0.f;
    __syncthreads();

    // ---- trunk ---------------------------------------------------------
    for (int i = 0; i < D.L; ++i) {
      mma_start<W>(acc);
      if (i == 0) {
        mma_segment<W, Q, W>(acc, rg, sm.pe, ps, nkp);
      } else {
        mma_segment<W, Q, W>(acc, rg, sm.act, as, nkh);
        if ((D.skip_mask >> i) & 1)
          mma_segment<W, Q, W>(acc, rg, sm.pe, ps, nkp);
      }
      mma_finish<W>(acc);
      __syncthreads();
      store<W, Q, W>(sm.act, as, acc, Q ? net.tscl + i * W : nullptr,
                     net.tb + i * W, nullptr, true);
      __syncthreads();
    }

    // ---- heads: sigma (exact) and feature ------------------------------
    mma_start<W>(acc);
    mma_segment<W, Q, W>(acc, rg, sm.act, as, nkh);
    mma_finish<W>(acc);
    if (tid < rows) {
      float s = 0.f;
      for (int k = 0; k < W; ++k) s = fmaf(sm.act[tid * as + k], net.sw[k], s);
      sm.sig[c0 + tid] = __fadd_rn(s, net.sb[0]);
    }
    __syncthreads();
    store<W, Q, W>(sm.act, as, acc, net.fscl, net.fb, nullptr, false);
    __syncthreads();

    // ---- color branch: feature rows per sample + direction part per ray
    mma_start<W>(acc);
    mma_segment<W, Q, C>(acc, rg, sm.act, as, nkh);
    mma_finish<W>(acc);
    __syncthreads();
    store<W, Q, C>(sm.act, as, acc, net.color.scl, sm.cold, net.cb, true);
    __syncthreads();

    // ---- rgb head (exact) + sigmoid ------------------------------------
    for (int idx = tid; idx < 3 * rows; idx += NT) {
      const int c = idx / rows, s = idx % rows;
      float r = 0.f;
      for (int k = 0; k < C; ++k) r = fmaf(sm.act[s * as + k], net.rw[k * 3 + c], r);
      r = __fadd_rn(r, net.rb[c]);
      sm.rgb[(c0 + s) * 3 + c] = 1.0f / (1.0f + expf(-r));
    }
    __syncthreads();
  }

  // ---- VRU: T_{i+1} = exp(cumsum x), w_i = T_i - T_{i+1}, sequential ----
  if (tid == 0) {
    float Ti = 1.f, cum = 0.f, r0 = 0.f, r1 = 0.f, r2 = 0.f, dep = 0.f;
    for (int n = 0; n < N; ++n) {
      const float x = __fmul_rn(-fmaxf(sm.sig[n], 0.f), dl[n]);
      cum = __fadd_rn(cum, x);
      const float Tn = expf(cum);
      const float w = __fsub_rn(Ti, Tn);
      sm.wbuf[n] = w;
      r0 = fmaf(w, sm.rgb[3 * n + 0], r0);
      r1 = fmaf(w, sm.rgb[3 * n + 1], r1);
      r2 = fmaf(w, sm.rgb[3 * n + 2], r2);
      dep = fmaf(w, ts[n], dep);
      Ti = Tn;
    }
    sm.res[0] = r0; sm.res[1] = r1; sm.res[2] = r2;
    sm.res[3] = __fsub_rn(1.f, Ti);
    sm.res[4] = dep;
  }
  __syncthreads();
}

__device__ __forceinline__ void load_ray(Smem& sm, const float* o,
                                         const float* d, int r) {
  if (threadIdx.x < 3) sm.ray[threadIdx.x] = o[3 * r + threadIdx.x];
  else if (threadIdx.x < 6) sm.ray[threadIdx.x] = d[3 * r + threadIdx.x - 3];
  __syncthreads();
}

// a ring's barriers (from barrier `first` of the block's) and bookkeeping
// at the start of a kernel
template <int W, bool Q>
__device__ void ring_init(Ring<W, Q>& rg, Smem& sm, const Dims& D,
                          int first) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < Ring<W, Q>::NS; ++i) {
      mbar_init(sm.full + first + i, 1);
      sm.rel[first + i] = 0;
    }
    mbar_init_fence();
  }
  rg.ring = sm.ring;
  rg.full = sm.full + first;
  rg.rel = sm.rel + first;
  rg.C = D.C;
  stream_steps<Q>(D, &rg.per_chunk, &rg.color_from);
  rg.gs = 0;
  __syncthreads();
}

// --------------------------------------------------------------- K1 -------
template <int W, int C, bool Q>
__global__ void __launch_bounds__(NT, min_blocks<W>())
plcore_fused_kernel(Net net, Dims D, int N, const float* __restrict__ rays_o,
                    const float* __restrict__ rays_d,
                    const float* __restrict__ t,
                    const float* __restrict__ deltas,
                    const float* __restrict__ alive, float* __restrict__ rgb,
                    float* __restrict__ w_out, float* __restrict__ acc_out) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  Smem sm;
  carve<W, Q, Q>(&sm, smem_raw, D, N, 0, 0);
  Ring<W, Q> rg;
  ring_init<W, Q>(rg, sm, D, 0);
  const int r_end = min(D.R, (int)(blockIdx.x + 1) * D.rt);
  for (int r = blockIdx.x * D.rt; r < r_end; ++r) {
    if (alive && !(alive[r] > 0.f)) {   // dead ray: zeros, no work
      for (int n = threadIdx.x; n < N; n += NT) w_out[(size_t)r * N + n] = 0.f;
      if (threadIdx.x < 3) rgb[3 * r + threadIdx.x] = 0.f;
      if (threadIdx.x == 0) acc_out[r] = 0.f;
      continue;
    }
    for (int n = threadIdx.x; n < N; n += NT) {
      sm.ts[n] = t[(size_t)r * N + n];
      sm.dl[n] = deltas[(size_t)r * N + n];
    }
    load_ray(sm, rays_o, rays_d, r);
    encode_dir(D, sm);
    ray_pass<W, C, Q>(net, D, sm, rg, sm.ts, sm.dl, N);
    for (int n = threadIdx.x; n < N; n += NT) w_out[(size_t)r * N + n] = sm.wbuf[n];
    if (threadIdx.x < 3) rgb[3 * r + threadIdx.x] = sm.res[threadIdx.x];
    if (threadIdx.x == 0) acc_out[r] = sm.res[3];
    __syncthreads();
  }
}

// --------------------------------------------------------------- K2 -------
// The rays of one block's tile: coarse pass through rgc, fine pass through
// rgf (the same ring when both networks have one format).
template <int W, int C, bool QC, bool QF>
__device__ void two_pass_rays(Ring<W, QC>& rgc, Ring<W, QF>& rgf,
                              const Net& netc, const Net& netf, const Dims& D,
                              Smem& sm, int Nc, int Nf, int ert, float thr,
                              const float* __restrict__ rays_o,
                              const float* __restrict__ rays_d,
                              const float* __restrict__ alive,
                              float* __restrict__ rgb,
                              float* __restrict__ rgb_c,
                              float* __restrict__ acc,
                              float* __restrict__ acc_c,
                              float* __restrict__ depth) {
  const int Nt = Nc + Nf, M1 = Nc - 1, tid = threadIdx.x;
  const int r_end = min(D.R, (int)(blockIdx.x + 1) * D.rt);
  for (int r = blockIdx.x * D.rt; r < r_end; ++r) {
    load_ray(sm, rays_o, rays_d, r);
    encode_dir(D, sm);

    // ---- pass 1: coarse --------------------------------------------------
    ray_pass<W, C, QC>(netc, D, sm, rgc, sm.tc, sm.dlc, Nc);
    const float cr0 = sm.res[0], cr1 = sm.res[1], cr2 = sm.res[2];
    const float cacc = sm.res[3], cdep = sm.res[4];
    bool live = true;
    if (ert) live = cacc < thr;
    if (alive) live = live && alive[r] > 0.f;

    if (tid == 0) {
      rgb_c[3 * r + 0] = cr0; rgb_c[3 * r + 1] = cr1; rgb_c[3 * r + 2] = cr2;
      acc_c[r] = cacc;
    }
    if (!live) {   // dead ray keeps the coarse estimate
      if (tid == 0) {
        rgb[3 * r + 0] = cr0; rgb[3 * r + 1] = cr1; rgb[3 * r + 2] = cr2;
        acc[r] = cacc;
        depth[r] = cdep;
      }
      __syncthreads();
      continue;
    }

    // ---- inverse-CDF resample over the interior coarse weights -----------
    if (tid == 0) {
      float wsum = 0.f;
      for (int i = 1; i < Nc - 1; ++i)
        wsum = __fadd_rn(wsum, __fadd_rn(sm.wbuf[i], 1e-5f));
      float c = 0.f;
      sm.cdf[0] = 0.f;
      for (int i = 1; i < Nc - 1; ++i) {
        c = __fadd_rn(c, __fdiv_rn(__fadd_rn(sm.wbuf[i], 1e-5f), wsum));
        sm.cdf[i] = c;
      }
    }
    __syncthreads();
    for (int j = tid; j < Nf; j += NT) {
      const float u = sm.u[j];
      int lo = 0, hi = M1;            // count of cdf entries <= u
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sm.cdf[mid] <= u) lo = mid + 1; else hi = mid;
      }
      const int idx = min(max(lo - 1, 0), M1 - 2);
      const float cl = sm.cdf[idx], chh = sm.cdf[idx + 1];
      const float tl = sm.tc[idx], th = sm.tc[idx + 1];
      const float diff = __fsub_rn(chh, cl);
      const float den = diff < 1e-8f ? 1.0f : diff;
      const float frac = __fdiv_rn(__fsub_rn(u, cl), den);
      sm.tf[j] = __fadd_rn(tl, __fmul_rn(frac, __fsub_rn(th, tl)));
    }
    __syncthreads();

    // ---- sorted merge, ties to the coarse sample --------------------------
    for (int i = tid; i < Nt; i += NT) {
      if (i < Nc) {
        const float v = sm.tc[i];
        int lo = 0, hi = Nf;            // count of tf < v
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (sm.tf[mid] < v) lo = mid + 1; else hi = mid;
        }
        sm.ts[i + lo] = v;
      } else {
        const int j = i - Nc;
        const float v = sm.tf[j];
        int lo = 0, hi = Nc;            // count of tc <= v
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (sm.tc[mid] <= v) lo = mid + 1; else hi = mid;
        }
        sm.ts[j + lo] = v;
      }
    }
    __syncthreads();
    for (int n = tid; n < Nt; n += NT)
      sm.dl[n] = n + 1 < Nt ? __fsub_rn(sm.ts[n + 1], sm.ts[n]) : 1e10f;
    __syncthreads();

    // ---- pass 2: fine over the merged samples -----------------------------
    ray_pass<W, C, QF>(netf, D, sm, rgf, sm.ts, sm.dl, Nt);
    if (tid == 0) {
      rgb[3 * r + 0] = sm.res[0]; rgb[3 * r + 1] = sm.res[1];
      rgb[3 * r + 2] = sm.res[2];
      acc[r] = sm.res[3];
      depth[r] = sm.res[4];
    }
    __syncthreads();
  }
}

template <int W, int C, bool QC, bool QF>
__global__ void __launch_bounds__(NT, min_blocks<W>())
plcore_two_pass_kernel(Net netc, Net netf, Dims D, int Nc, int Nf, int ert,
                       float thr, const float* __restrict__ rays_o,
                       const float* __restrict__ rays_d,
                       const float* __restrict__ t_row,
                       const float* __restrict__ u_row,
                       const float* __restrict__ alive,
                       float* __restrict__ rgb, float* __restrict__ rgb_c,
                       float* __restrict__ acc, float* __restrict__ acc_c,
                       float* __restrict__ depth) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const int tid = threadIdx.x;
  Smem sm;
  carve<W, QC, QF>(&sm, smem_raw, D, Nc + Nf, Nc, Nf);
  // the pinned coarse row and u-grid, shared by every ray of the tile
  for (int n = tid; n < Nc; n += NT) {
    sm.tc[n] = t_row[n];
    sm.dlc[n] = n + 1 < Nc ? __fsub_rn(t_row[n + 1], t_row[n]) : 1e10f;
  }
  for (int n = tid; n < Nf; n += NT) sm.u[n] = u_row[n];
  Ring<W, QC> rgc;
  ring_init<W, QC>(rgc, sm, D, 0);
  if constexpr (QC == QF) {
    two_pass_rays<W, C, QC, QF>(rgc, rgc, netc, netf, D, sm, Nc, Nf, ert,
                                thr, rays_o, rays_d, alive, rgb, rgb_c, acc,
                                acc_c, depth);
  } else {
    Ring<W, QF> rgf;
    ring_init<W, QF>(rgf, sm, D, Ring<W, QC>::NS);
    two_pass_rays<W, C, QC, QF>(rgc, rgf, netc, netf, D, sm, Nc, Nf, ert,
                                thr, rays_o, rays_d, alive, rgb, rgb_c, acc,
                                acc_c, depth);
  }
}

// ------------------------------------------------------------ host side ---
constexpr int NET_PTRS = 14;

Net make_net(const void* const* p, int C) {
  // order: tb sw sb fb cw cb rw rb tscl fscl cmag csgn cscl stream
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  auto b = [&](int i) { return static_cast<const uint8_t*>(p[i]); };
  Net n;
  n.tb = f(0); n.sw = f(1); n.sb = f(2); n.fb = f(3);
  n.color = Mat{f(4), b(10), b(11), f(12), C};
  n.cb = f(5); n.rw = f(6); n.rb = f(7);
  n.tscl = f(8); n.fscl = f(9);
  n.stream = b(13);
  return n;
}

Dims make_dims(const int* v) {
  Dims D;
  D.R = v[0]; D.rt = v[1]; D.W = v[2]; D.L = v[3]; D.skip_mask = v[4];
  D.C = v[5]; D.pos_freqs = v[6]; D.dir_freqs = v[7];
  D.pe = 3 + 6 * D.pos_freqs; D.de = 3 + 6 * D.dir_freqs;
  D.P = v[8]; D.P2 = v[9];
  D.kpe = (D.pe + 15) & ~15;
  return D;
}

template <int W, int C>
bool dims_ok(const Dims& D) {
  return D.W == W && D.C == C && D.rt > 0 && D.R > 0 && D.L >= 1 &&
         D.P % 8 == 0 && D.P >= D.W + D.pe && D.P2 >= D.W + D.de;
}

template <typename K>
cudaError_t launch_setup(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename K>
cudaError_t resident(K kernel, size_t smem, int* blocks) {
  cudaError_t e = launch_setup(kernel, smem);
  if (e) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, NT,
                                                       smem);
}

}  // namespace

// The instances' host entry points, one per (W, C) and format(s); the C
// interface in fused_plcore.cu picks one. Argument layouts as there.
namespace plcore {

template <int W, int C, bool Q>
int k1_launch(const void* const* ptrs, const int* dims, void* stream) {
  const Dims D = make_dims(dims);
  const int N = dims[10];
  if (!dims_ok<W, C>(D) || N < 1) return (int)cudaErrorInvalidValue;
  const Net net = make_net(ptrs + 8, D.C);
  const dim3 grid((D.R + D.rt - 1) / D.rt);
  const float* in[5];
  for (int i = 0; i < 5; ++i) in[i] = static_cast<const float*>(ptrs[i]);
  float* out[3];
  for (int i = 0; i < 3; ++i)
    out[i] = static_cast<float*>(const_cast<void*>(ptrs[5 + i]));
  const size_t smem = carve<W, Q, Q>(nullptr, nullptr, D, N, 0, 0);
  cudaError_t e = launch_setup(plcore_fused_kernel<W, C, Q>, smem);
  if (e) return (int)e;
  plcore_fused_kernel<W, C, Q><<<grid, NT, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      net, D, N, in[0], in[1], in[2], in[3], in[4], out[0], out[1], out[2]);
  return (int)cudaGetLastError();
}

template <int W, int C, bool QC, bool QF>
int k2_launch(const void* const* ptrs, const int* dims, float thr,
              void* stream) {
  const Dims D = make_dims(dims);
  const int Nc = dims[10], Nf = dims[11], ert = dims[14];
  if (!dims_ok<W, C>(D) || Nc < 3 || Nf < 1) return (int)cudaErrorInvalidValue;
  const Net nc = make_net(ptrs + 10, D.C);
  const Net nf = make_net(ptrs + 10 + NET_PTRS, D.C);
  const dim3 grid((D.R + D.rt - 1) / D.rt);
  const float* in[5];
  for (int i = 0; i < 5; ++i) in[i] = static_cast<const float*>(ptrs[i]);
  float* out[5];
  for (int i = 0; i < 5; ++i)
    out[i] = static_cast<float*>(const_cast<void*>(ptrs[5 + i]));
  const size_t smem = carve<W, QC, QF>(nullptr, nullptr, D, Nc + Nf, Nc, Nf);
  cudaError_t e = launch_setup(plcore_two_pass_kernel<W, C, QC, QF>, smem);
  if (e) return (int)e;
  plcore_two_pass_kernel<W, C, QC, QF><<<grid, NT, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
      nc, nf, D, Nc, Nf, ert, thr, in[0], in[1], in[2], in[3], in[4],
      out[0], out[1], out[2], out[3], out[4]);
  return (int)cudaGetLastError();
}

template <int W, int C, bool Q>
int k1_resident(const int* dims, int* blocks) {
  const Dims D = make_dims(dims);
  if (!dims_ok<W, C>(D)) return (int)cudaErrorInvalidValue;
  return (int)resident(plcore_fused_kernel<W, C, Q>,
                       carve<W, Q, Q>(nullptr, nullptr, D, dims[10], 0, 0),
                       blocks);
}

template <int W, int C, bool QC, bool QF>
int k2_resident(const int* dims, int* blocks) {
  const Dims D = make_dims(dims);
  if (!dims_ok<W, C>(D)) return (int)cudaErrorInvalidValue;
  const int Nc = dims[10], Nf = dims[11];
  return (int)resident(plcore_two_pass_kernel<W, C, QC, QF>,
                       carve<W, QC, QF>(nullptr, nullptr, D, Nc + Nf, Nc, Nf),
                       blocks);
}

}  // namespace plcore

// Explicit instances of one width pair: the same-format family (K1 and
// K2, f32 and RMCM) or the mixed K2 family (qc != qf).
#define PLCORE_INSTANCES_SAME(W, C)                                          \
  template int plcore::k1_launch<W, C, false>(const void* const*,            \
                                              const int*, void*);            \
  template int plcore::k1_launch<W, C, true>(const void* const*,             \
                                             const int*, void*);             \
  template int plcore::k2_launch<W, C, false, false>(                        \
      const void* const*, const int*, float, void*);                         \
  template int plcore::k2_launch<W, C, true, true>(                          \
      const void* const*, const int*, float, void*);                         \
  template int plcore::k1_resident<W, C, false>(const int*, int*);           \
  template int plcore::k1_resident<W, C, true>(const int*, int*);            \
  template int plcore::k2_resident<W, C, false, false>(const int*, int*);    \
  template int plcore::k2_resident<W, C, true, true>(const int*, int*);

#define PLCORE_INSTANCES_MIXED(W, C)                                         \
  template int plcore::k2_launch<W, C, false, true>(                         \
      const void* const*, const int*, float, void*);                         \
  template int plcore::k2_launch<W, C, true, false>(                         \
      const void* const*, const int*, float, void*);                         \
  template int plcore::k2_resident<W, C, false, true>(const int*, int*);     \
  template int plcore::k2_resident<W, C, true, false>(const int*, int*);
