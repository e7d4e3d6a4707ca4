// Fused PLCore kernels for Hopper (sm_90a): the whole NeRF pass, PEU ->
// MLP engine -> VRU, inside one thread block per ray tile. This header
// holds the kernels as templates over the layer widths (W, C) and the
// weight formats; each plcore_w*.cu instantiates them for one width pair
// (one translation unit per pair and format family, and per family for
// K2's traced instances, so nvcc builds them in parallel), and
// fused_plcore.cu holds the C entry points that pick the instance.
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
// * A block of two warpgroups owns whole rays and walks its tile in chunks
//   of 128 sample rows: each warpgroup takes a slab of 64 rows and every
//   column of a layer (W / 2 f32 accumulators a thread), one wgmma per
//   split piece and k step spanning them all. The widths are template
//   parameters, so the wgmma N of every layer is an immediate and the
//   pipeline has no branch. A pass whose N samples fill whole slabs but
//   leave its last chunk half empty (N = 64 mod 128: the 64 coarse and
//   64 + 128 fine samples) walks two rays at once, the second ray's rows
//   after the first's, so no MMA row is padding: 2 chunks a ray instead of
//   3. Every other pass walks one ray at a time, and in a chunk shorter
//   than 128 samples (every pass at the small widths) the rows past the
//   ray's samples are computed and never stored. A slab's rows belong to
//   one ray and a row's arithmetic does not depend on where it runs, so
//   the outputs do not depend on how rays pair. The activations of a chunk live
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
// * Both warpgroups start every layer together after its epilogue's
//   barriers, so they stay in phase, and a loop that waits for each k
//   step loads and splits the next A fragment while neither has wgmmas
//   queued. Where the ring has 4 slots or more (RMCM at the full width,
//   k_pipelined), the k loop is pipelined: two A register sets, step
//   j + 1 loaded, split and issued while step j's wgmmas run, step j
//   retired with wgmma_wait<1> (mma_segment). A warpgroup then holds two
//   slots, so 5 slots keep three steps of lead. f32's 3 slots of 16 KB (a
//   fourth does not fit beside its activations) would keep one, so f32
//   keeps the loop that waits for each step, as do the small widths.
//   K2 pipelines one pass, the fine one where it can (two_pass_rays):
//   ptxas serialises every wgmma when both are. The wgmmas keep their
//   order either way: the sums are the same bits.
// * The rest keeps its fp32 code and its explicitly rounded order: the
//   exact sigma and rgb heads, the per-ray direction part of the color
//   layer, the VRU prefix, the coarse CDF, the inverse-CDF binary search
//   and the sorted merge. The prefix sums run sequentially per ray, in the
//   order cumsum adds, with explicitly rounded operations (no FMA
//   contraction), because the resampler turns last-ulp differences into
//   moved samples; the VRU runs chunk by chunk, carrying its sums, and a
//   pair's two rays on two threads. Coarse weights, sample positions and
//   resample scratch never leave shared memory.
// * With early ray termination or an alive mask, a dead ray skips its
//   fine pass and keeps its coarse rgb/acc/depth (per ray, no compaction).
// * K2 may composite its rgb outputs onto white itself (the serving tile's
//   render), so a tile's render is one launch and no elementwise kernels.
//
// Shared memory of one block at full width (W = 256, pe = 63 padded to
// 64, 64 + 128 samples): the weight ring (5 x 8 KB bf16 or 3 x 16 KB
// TF32), its mbarriers, activations 128 x 264 (bf16x3) or 128 x 260
// (TF32) f32, position encoding 128 x 72 or 128 x 68 f32, and K2's
// per-ray and resample scratch for a pair (9,568 B: per ray its
// encodings, direction part, sums, samples, coarse weights, CDF and fine
// positions; a chunk's densities and colors): 222,640 B (RMCM) or 226,704
// B (f32), one block per SM. K2 with two formats takes the TF32 strides
// (the bf16x3 A loads then meet 2-way bank conflicts) and the 48 KB ring:
// 226,784 B; beside them K2 keeps 8 B of static memory (group_now), and
// its traced instances 160 B more (the phase slots).
// At the small widths (W <= 64) the ring has 8 slots, two blocks fit on
// an SM (128 registers a thread), and each k step's products are summed
// apart and added to the layer's sums with rounded adds (mma_segment). The
// host reads the resident blocks per SM from plcore_blocks_per_sm.
//
// K2's traced instances (TRACE) count where the block's cycles go (the
// phase clock below); the untraced instances compile none of it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_split.cuh"

// ray_pass and two_pass_rays are always inlined in the translation units
// whose instances pipeline a k loop (PLCORE_INLINE_PASSES defined before
// this header): ptxas serialises every wgmma of a function that is called
// rather than inlined (C7510), and the pipelined loop's size would have
// the compiler call them. Elsewhere the compiler decides.
#ifdef PLCORE_INLINE_PASSES
#define PLCORE_PASS __forceinline__
#else
#define PLCORE_PASS
#endif

namespace {

using namespace mma_split;

constexpr int NT = 256;       // threads per block, two warpgroups
constexpr int S = 128;        // sample rows per chunk
constexpr int SLAB = S / 2;   // a warpgroup's rows of a chunk

// whether a pass of N samples a ray walks two rays at once: when the rays
// fill whole slabs (so a warpgroup's rows belong to one ray) and their rows
// fill fewer chunks than two walks of one ray
__host__ __device__ constexpr bool pairs(int N) {
  return N % SLAB == 0 && (2 * N + S - 1) / S < 2 * ((N + S - 1) / S);
}

// rays whose scratch a K2 block holds at once: two when a pass pairs
__host__ __device__ constexpr int k2_group(int Nc, int Nf) {
  return pairs(Nc) || pairs(Nc + Nf) ? 2 : 1;
}

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

// ------------------------------------------------------- phase clock ----
// The traced K2 splits each warpgroup's cycles into phases: its first
// thread reads clock64() at the phases' borders and adds each interval to
// the warpgroup's slots in shared memory; at exit the block writes both
// warpgroups' sums (PH_OUT int64, in this order) to its row of the
// launch's buffer, which lies in pinned host memory: the traced launch
// adds no operation on the device (no zeroing, no copy back). PH_MLP is the MLP layers' time with the
// ring waits inside them (PH_RING) taken out at exit; time between
// borders that no phase names is counted in PH_TOTAL only. A ring wait
// (one a k step) reads the clock only when the step's bytes have not
// landed (in a pipelined loop it reads it twice every step and selects
// what to add: see Ring::acquire), and adds up in a register of every
// thread, which goes to the slots at the MLP borders: a clock pair and a
// shared-memory update a step cost the warpgroup 2 to 3% of K2's time.
// Four counts follow the cycles: the MMA rows the warpgroup computed (64
// a chunk) and the real sample rows among them (PH_ROWS_MMA,
// PH_ROWS_REAL), the k steps it ran and those it issued while its
// previous step was still in flight (PH_STEPS_MMA, PH_STEPS_OVERLAPPED;
// mma_segment).
enum Phase { PH_MLP, PH_RING, PH_RESAMPLE, PH_SCALAR, PH_TOTAL, PH_ROWS_MMA,
             PH_ROWS_REAL, PH_STEPS_MMA, PH_STEPS_OVERLAPPED, PH_OUT,
             PH_LAST = PH_OUT, PH_SLOTS = 10 };

__device__ __forceinline__ long long* phase_slots(int wg) {
  __shared__ __align__(128) long long slots[2 * PH_SLOTS];
  return slots + wg * PH_SLOTS;
}

__device__ __forceinline__ bool phase_leader() {
  return (threadIdx.x & 127) == 0;
}

// the cycles since the warpgroup's last border go to phase P (P < 0:
// to no phase)
template <bool TRACE, int P>
__device__ __forceinline__ void lap() {
  if constexpr (TRACE) {
    if (phase_leader()) {
      long long* s = phase_slots(threadIdx.x >> 7);
      const long long now = clock64();
      if constexpr (P >= 0) s[P] += now - s[PH_LAST];
      s[PH_LAST] = now;
    }
  }
}

// the MLP layers' border: the cycles since the last border go to PH_MLP,
// the ring waits counted in `waited` since then to PH_RING
template <bool TRACE>
__device__ __forceinline__ void lap_mlp(long long& waited) {
  if constexpr (TRACE) {
    if (phase_leader()) phase_slots(threadIdx.x >> 7)[PH_RING] += waited;
    waited = 0;
    lap<TRACE, PH_MLP>();
  }
}

// a chunk of `rows` real sample rows: the warpgroup's 64 MMA rows and its
// real rows among them
template <bool TRACE>
__device__ __forceinline__ void count_rows(int rows) {
  if constexpr (TRACE) {
    if (phase_leader()) {
      const int wg = threadIdx.x >> 7;
      long long* s = phase_slots(wg);
      s[PH_ROWS_MMA] += SLAB;
      s[PH_ROWS_REAL] += min(max(rows - SLAB * wg, 0), SLAB);
    }
  }
}

template <bool TRACE>
__device__ __forceinline__ void phases_begin() {
  if constexpr (TRACE) {
    if (phase_leader()) {
      long long* s = phase_slots(threadIdx.x >> 7);
      const long long now = clock64();
      for (int p = 0; p < PH_OUT; ++p) s[p] = 0;
      s[PH_TOTAL] = -now;
      s[PH_LAST] = now;
    }
  }
}

// every thread of the block, at its exit: the block's row of `rows`
template <bool TRACE>
__device__ __forceinline__ void phases_end(long long* rows) {
  if constexpr (TRACE) {
    if (phase_leader()) phase_slots(threadIdx.x >> 7)[PH_TOTAL] += clock64();
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long* a = phase_slots(0);
      const long long* b = phase_slots(1);
      long long* row = rows + (size_t)blockIdx.x * PH_OUT;
      for (int p = 0; p < PH_OUT; ++p)
        row[p] = a[p] + b[p] - (p == PH_MLP ? a[PH_RING] + b[PH_RING] : 0);
    }
  }
}

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

// The shared-memory carve-up of one block. The per-ray scratch holds the
// block's rays at once (a pair, in K2 when a pass pairs): ray k's at
// k times the size shown.
struct Smem {
  uint8_t* ring;    // weight ring: the slots of each network's ring
  uint64_t* full;   // per slot: its bytes landed (a ring per format)
  int* rel;         // per slot: warpgroups done with its step
  int as, ps;   // row strides of act and pe
  int ds;       // floats of a ray's ped
  float* act;   // S x as: hidden activations of a chunk
  float* pe;    // S x ps: position encoding of a chunk
  float* ped;   // per ray, de (stride ds): direction encoding
  float* cold;  // per ray, C: direction part of the color layer
  float* ray;   // per ray, 8: o, d
  float* res;   // per ray, 8: rgb, acc, depth of its last pass; VRU carry
  float* sig;   // a chunk's rows: raw density
  float* rgb;   // 3 per chunk row: color
  float* wbuf;  // VRU weights: K1's N; K2's coarse pass, Nc per ray
  float* ts;    // per ray, N: sample positions
  float* dl;    // per ray, N: sample spacing
  // two-pass scratch: the coarse row (tc, dlc) and u-grid, shared by
  // every ray; per ray, its CDF (Nc) and fine positions (tf, Nf)
  float* tc; float* dlc; float* cdf; float* u; float* tf;
};

// the VRU's carry in a ray's res slot, besides rgb (0..2) and depth (4)
enum { RES_ACC = 3, RES_DEPTH = 4, RES_T = 5, RES_CUM = 6 };

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

// K1: N samples, Nc = Nf = 0; K2: N = Nc + Nf
template <int W, bool QC, bool QF>
__host__ __device__ inline size_t carve(Smem* sm, uint8_t* base,
                                        const Dims& D, int N, int Nc,
                                        int Nf) {
  constexpr int NB = ring_barriers<W, QC, QF>();
  constexpr size_t RB = ring_bytes<W, QC, QF>();
  // the bf16x3 strides only when every pass is bf16x3
  constexpr bool QS = QC && QF;
  const int nray = Nf > 0 ? k2_group(Nc, Nf) : 1;
  const int chunk_rows = nray * N < S ? nray * N : S;
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
  s.ds = rup4(D.de);
  s.act = take(S * s.as);
  s.pe = take(S * s.ps);
  s.ped = take(nray * s.ds);
  s.cold = take(nray * D.C);
  s.ray = take(nray * 8);
  s.res = take(nray * 8);
  s.sig = take(chunk_rows);
  s.rgb = take(3 * chunk_rows);
  s.wbuf = take(Nf > 0 ? nray * Nc : N);
  s.ts = take(nray * N);
  s.dl = take(nray * N);
  s.tc = take(Nc);
  s.dlc = take(Nc);
  s.cdf = take(nray * Nc);
  s.u = take(Nf);
  s.tf = take(nray * Nf);
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

// whether mma_segment keeps a k step in flight while it loads and splits
// the next one's A fragment: only with 4 ring slots or more (RMCM at the
// full width), since a warpgroup then holds two slots and the ring still
// has steps of lead; f32's 3 slots would keep one. Never under split_sum
// (W <= 64), whose k steps add their sums one by one.
template <int W, bool Q>
__host__ __device__ constexpr bool k_pipelined() {
  return W > 64 && ring_slots<W, Q>() >= 4;
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
  int fill_q;           // k_pipelined: the chunk's step of the next refill

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

  // the chunk's step q -> slot (one thread; the slot is free)
  __device__ __forceinline__ void fill(int slot, int q) {
    size_t off;
    uint32_t bytes;
    locate(q, &off, &bytes);
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
    if constexpr (k_pipelined<W, Q>()) fill_q = NS % per_chunk;
    if (threadIdx.x == 0)
      for (int p = 0; p < min(NS, total); ++p) issue(p);
    __syncwarp();
  }

  // wait for the next step; its slot's shared address. TRACE: a wait
  // that does not find the bytes landed adds its cycles to *waited (one
  // that does reads no clock)
  template <bool TRACE = false>
  __device__ __forceinline__ uint32_t acquire(long long* waited = nullptr) {
    if constexpr (k_pipelined<W, Q>()) {
      // In a pipelined loop a step is in flight here, and ptxas serialises
      // every wgmma (C7518) when the code between them branches per thread
      // and takes registers there: the wait's retries stay inside one asm
      // (mbar_spin), and the traced count is selected, not branched to.
      uint64_t* bar = full + gs % NS;
      const uint32_t parity = (gs / NS) & 1;
      if constexpr (TRACE) {
        const bool landed = mbar_test(bar, parity);
        const long long t0 = clock64();
        mbar_spin(bar, parity);
        const long long t1 = clock64();
        *waited += landed ? 0 : t1 - t0;
      } else {
        mbar_spin(bar, parity);
      }
    } else if constexpr (TRACE) {
      if (!mbar_test(full + gs % NS, (gs / NS) & 1)) {
        const long long t0 = clock64();
        mbar_wait(full + gs % NS, (gs / NS) & 1);
        *waited += clock64() - t0;
      }
    } else {
      mbar_wait(full + gs % NS, (gs / NS) & 1);
    }
    __syncwarp();
    return smem_addr(ring + (gs % NS) * SB);
  }

  // this warpgroup's MMAs of its last step are done; the second
  // warpgroup to get here refills the slot with the step NS later
  __device__ __forceinline__ void release() {
    if constexpr (k_pipelined<W, Q>()) {
      // (a step may be in flight here, as in acquire) the refill's chunk
      // step is counted along (fill_q), not divided out, so the leader's
      // branch is short
      const int slot = (start + released) % NS;
      if ((threadIdx.x & 127) == 0) {
        __threadfence_block();
        if (atomicAdd(rel + slot, 1) == 1) {
          rel[slot] = 0;
          if (released + NS < total) fill(slot, fill_q);
        }
      }
      fill_q = fill_q + 1 == per_chunk ? 0 : fill_q + 1;
    } else if ((threadIdx.x & 127) == 0) {
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

// a segment's k steps: all of them, and those issued while the
// warpgroup's previous step was still in flight (PH_STEPS_*)
template <bool TRACE>
__device__ __forceinline__ void count_steps(int steps, int overlapped) {
  if constexpr (TRACE) {
    if (phase_leader()) {
      long long* s = phase_slots(threadIdx.x >> 7);
      s[PH_STEPS_MMA] += steps;
      s[PH_STEPS_OVERLAPPED] += overlapped;
    }
  }
}

// A thread's A registers of one bf16x3 k step: the pieces l, m, h, four
// registers a piece. Only RMCM pipelines its k loop (k_pipelined).
using AFrag = uint32_t[12];

// The pipelined loop's k step at `a` (the warpgroup's 64 rows of a (sample
// x feature) buffer of row stride ld): acquired, its A fragment loaded and
// split into p, its three wgmmas (l, m, h) issued into acc as one commit
// group.
template <int W, int N, bool TRACE>
__device__ __forceinline__ void issue_step(Acc<W>& acc, Ring<W, true>& rg,
                                           AFrag& p, const float* a, int ld,
                                           long long* waited) {
  const uint64_t d = b_desc(rg.template acquire<TRACE>(waited));
  const float2 v0 = *reinterpret_cast<const float2*>(a);
  const float2 v1 = *reinterpret_cast<const float2*>(a + 8 * ld);
  const float2 v2 = *reinterpret_cast<const float2*>(a + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(a + 8 * ld + 8);
  const Bf16x3 q0 = split_bf16x3(v0.x, v0.y), q1 = split_bf16x3(v1.x, v1.y);
  const Bf16x3 q2 = split_bf16x3(v2.x, v2.y), q3 = split_bf16x3(v3.x, v3.y);
  const uint32_t v[12] = {q0.l, q1.l, q2.l, q3.l, q0.m, q1.m, q2.m, q3.m,
                          q0.h, q1.h, q2.h, q3.h};
#pragma unroll
  for (int i = 0; i < 12; ++i) p[i] = v[i];
  fence_a(p);
  wgmma_fence();
  wgmma_bf16<N>(acc, p[0], p[1], p[2], p[3], d);
  wgmma_bf16<N>(acc, p[4], p[5], p[6], p[7], d);
  wgmma_bf16<N>(acc, p[8], p[9], p[10], p[11], d);
  wgmma_commit();
  ++rg.gs;
}

// The warpgroup's older step in flight, whose A registers were `old`, is
// done; its slot is released if it held one (`held`: false before the
// first step, where wgmma_wait<1> finds one group in flight and returns).
template <int W>
__device__ __forceinline__ void retire_step(Ring<W, true>& rg, AFrag& old,
                                            bool held) {
  wgmma_wait<1>();
  fence_a(old);
  if (held) rg.release();
}

// acc += in[the warpgroup's 64 rows][nk k steps] . the next nk steps of
// the ring, a layer N columns wide (W or C); `in` is (sample x feature)
// with row stride ld. Per k step the A fragment is loaded and split, then
// three wgmmas of the full width make one commit group. wgmma reads A
// from the registers while it runs, so a step's A registers are not
// written again until its group is waited for.
// Pipelined (k_pipelined): two A register sets, taken in turn; step j + 1
// is acquired, loaded, split and issued while step j's group runs, then
// wgmma_wait<1> retires step j and releases its slot, so the tensor cores
// have a step queued while the warpgroup splits. The last step is waited
// for with wgmma_wait<0>, so acc is final at the segment's end.
// Otherwise each step's group is waited for before the next step's loads
// (this loop's instances compile as they did before the pipelined one).
// The wgmmas run in the same order on the same accumulators either way:
// the sums are the same bits.
template <int W, bool Q, int N, bool TRACE = false, bool PIPELINE = true>
__device__ __forceinline__ void mma_segment(Acc<W>& acc, Ring<W, Q>& rg,
                                            const float* in, int ld, int nk,
                                            long long* waited = nullptr) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x >> 7;
  const int g = lane >> 2, t = lane & 3;
  const float* a = in + (64 * wg + 16 * w4 + g) * ld + (Q ? 2 * t : t);
  if constexpr (PIPELINE && k_pipelined<W, Q>()) {
    AFrag p0, p1 = {};
#pragma unroll 1
    for (int j = 0;;) {
      issue_step<W, N, TRACE>(acc, rg, p0, a, ld, waited);
      retire_step(rg, p1, j > 0);
      if (++j == nk) break;
      issue_step<W, N, TRACE>(acc, rg, p1, a + kstep<Q>(), ld, waited);
      retire_step(rg, p0, true);
      if (++j == nk) break;
      a += 2 * kstep<Q>();
    }
    wgmma_wait<0>();
    fence_a(p0);
    fence_a(p1);
    rg.release();
    count_steps<TRACE>(nk, nk - 1);
    return;
  }
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
    const uint64_t d = b_desc(rg.template acquire<TRACE>(waited));
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
  count_steps<TRACE>(nk, 0);
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

// k steps of one network's stream per chunk, and the first of color0's
template <bool Q>
__device__ __forceinline__ void stream_steps(const Dims& D, int* per_chunk,
                                             int* color_from) {
  const int nkh = D.W / kstep<Q>(), nkp = D.kpe / kstep<Q>();
  const int nskip = __popc(D.skip_mask & ~1 & ((1 << D.L) - 1));
  *color_from = nkp + (D.L - 1) * nkh + nskip * nkp + nkh;
  *per_chunk = *color_from + nkh;
}

// The rays of one pass: nr (1, or 2 when pairs(N)) of the block's, from
// ray k0, N samples each. Ray k's positions and spacing are at ts and dl
// + k * tstride (tstride 0: one row for every ray); with w, the VRU writes
// its per-sample weights to w + k * N.
struct Walk {
  const float* ts;
  const float* dl;
  float* w;
  int tstride, N, k0, nr;

  // the walk's rows, and the real ones in the chunk from row c0
  __device__ __forceinline__ int total() const { return nr * N; }
  __device__ __forceinline__ int rows(int c0) const {
    return min(S, total() - c0);
  }
  // the walk's ray j of row p
  __device__ __forceinline__ int ray_of(int p) const {
    return min(p / N, nr - 1);
  }
};

// The VRU over the rows c0 .. c0 + rows - 1 of a walk (sig and rgb hold
// them): T_{i+1} = exp(cumsum x), w_i = T_i - T_{i+1}, sequential per ray
// on lane 0 of warp j for the walk's ray j, which carries T, the cumsum,
// rgb and depth in the ray's res slot from one chunk to the next and
// leaves acc there after the ray's last sample.
__device__ __forceinline__ void vru_rows(Smem& sm, const Walk& wk, int c0,
                                         int rows) {
  const int j = threadIdx.x >> 5, N = wk.N;
  if ((threadIdx.x & 31) != 0 || j >= wk.nr) return;
  const int p0 = max(c0, j * N), p1 = min(c0 + rows, (j + 1) * N);
  if (p0 >= p1) return;
  const int k = wk.k0 + j;
  float* v = sm.res + 8 * k;
  const float* ts = wk.ts + k * wk.tstride;
  const float* dl = wk.dl + k * wk.tstride;
  const bool first = p0 == j * N;
  float Ti = first ? 1.f : v[RES_T], cum = first ? 0.f : v[RES_CUM];
  float r0 = first ? 0.f : v[0], r1 = first ? 0.f : v[1];
  float r2 = first ? 0.f : v[2], dep = first ? 0.f : v[RES_DEPTH];
  for (int p = p0; p < p1; ++p) {
    const int n = p - j * N, s = p - c0;
    const float x = __fmul_rn(-fmaxf(sm.sig[s], 0.f), dl[n]);
    cum = __fadd_rn(cum, x);
    const float Tn = expf(cum);
    const float w = __fsub_rn(Ti, Tn);
    if (wk.w) wk.w[k * N + n] = w;
    r0 = fmaf(w, sm.rgb[3 * s + 0], r0);
    r1 = fmaf(w, sm.rgb[3 * s + 1], r1);
    r2 = fmaf(w, sm.rgb[3 * s + 2], r2);
    dep = fmaf(w, ts[n], dep);
    Ti = Tn;
  }
  v[0] = r0; v[1] = r1; v[2] = r2;
  v[RES_DEPTH] = dep;
  v[RES_T] = Ti;
  v[RES_CUM] = cum;
  if (p1 == (j + 1) * N) v[RES_ACC] = __fsub_rn(1.f, Ti);
}

// One PEU -> MLP -> VRU pass over the walk's rays. Their rows follow one
// another, ray after ray: row p is sample p - jN of the walk's ray j = p /
// N. A chunk holds 128 rows, 64 a warpgroup, and a warpgroup's rows belong
// to one ray (a pair's N is a multiple of 64), so a row's arithmetic is
// the same as in a walk of its ray alone. A lone ray's last chunk may be
// short: the rows past N are computed and never stored. Leaves each ray's
// rgb, acc and depth in its res slot. Every thread of the block calls it.
// TRACE: the MLP layers (with their epilogues and barriers) go to PH_MLP,
// their ring waits to PH_RING, the encoding, the exact heads, the
// direction part of the color layer and the VRU to PH_SCALAR; each chunk
// counts its rows. PIPELINE: the pass's k loops are pipelined where its
// ring allows it (k_pipelined).
template <int W, int C, bool Q, bool TRACE = false, bool PIPELINE = true>
__device__ PLCORE_PASS void ray_pass(const Net& net, const Dims& D, Smem& sm,
                                     Ring<W, Q>& rg, const Walk& wk) {
  const int tid = threadIdx.x;
  const int as = sm.as, ps = sm.ps;
  const int nkh = W / kstep<Q>(), nkp = D.kpe / kstep<Q>();
  rg.begin(net.stream, rg.per_chunk * ((wk.total() + S - 1) / S));

  // direction part of the color layer, once per ray and network (the
  // ring's first steps land meanwhile)
  for (int idx = tid; idx < wk.nr * C; idx += NT) {
    const int k = wk.k0 + idx / C, j = idx % C;
    const float scl = Q ? net.color.scl[j] : 0.f;
    const float* ped = sm.ped + k * sm.ds;
    float s = 0.f;
    for (int i = 0; i < D.de; ++i)
      s = fmaf(ped[i], wget<Q>(net.color, W + i, j, scl), s);
    sm.cold[k * C + j] = s;
  }

  Acc<W> acc;
  long long waited = 0;   // TRACE: ring-wait cycles since the last border
  for (int c0 = 0; c0 < wk.total(); c0 += S) {
    // ---- PEU: positions of this chunk, double-angle encoded; the K
    // padding is zero. The rows past a lone ray's N (up to the chunk's
    // 128) repeat its sample N - 1, so every row the MMAs read is finite;
    // they are never stored.
    for (int idx = tid; idx < 3 * S; idx += NT) {
      const int s = idx / 3, a = idx % 3;
      const int p = c0 + s, j = wk.ray_of(p), k = wk.k0 + j;
      const int n = min(p - j * wk.N, wk.N - 1);
      const float* o = sm.ray + 8 * k;
      const float x = __fadd_rn(o[a], __fmul_rn(wk.ts[k * wk.tstride + n],
                                                o[3 + a]));
      encode(x, a, D.pos_freqs, sm.pe + s * ps, 1, 0);
    }
    const int npad = D.kpe - D.pe;
    for (int idx = tid; idx < S * npad; idx += NT)
      sm.pe[(idx / npad) * ps + D.pe + idx % npad] = 0.f;
    __syncthreads();
    lap<TRACE, PH_SCALAR>();
    count_rows<TRACE>(wk.rows(c0));

    // ---- trunk ---------------------------------------------------------
    for (int i = 0; i < D.L; ++i) {
      mma_start<W>(acc);
      if (i == 0) {
        mma_segment<W, Q, W, TRACE, PIPELINE>(acc, rg, sm.pe, ps, nkp,
                                              &waited);
      } else {
        mma_segment<W, Q, W, TRACE, PIPELINE>(acc, rg, sm.act, as, nkh,
                                              &waited);
        if ((D.skip_mask >> i) & 1)
          mma_segment<W, Q, W, TRACE, PIPELINE>(acc, rg, sm.pe, ps, nkp,
                                                &waited);
      }
      mma_finish<W>(acc);
      __syncthreads();
      store<W, Q, W>(sm.act, as, acc, Q ? net.tscl + i * W : nullptr,
                     net.tb + i * W, nullptr, true);
      __syncthreads();
    }

    // ---- heads: sigma (exact) and feature ------------------------------
    mma_start<W>(acc);
    mma_segment<W, Q, W, TRACE, PIPELINE>(acc, rg, sm.act, as, nkh, &waited);
    mma_finish<W>(acc);
    lap_mlp<TRACE>(waited);
    if (tid < wk.rows(c0)) {
      float s = 0.f;
      for (int k = 0; k < W; ++k) s = fmaf(sm.act[tid * as + k], net.sw[k], s);
      sm.sig[tid] = __fadd_rn(s, net.sb[0]);
    }
    __syncthreads();
    lap<TRACE, PH_SCALAR>();
    store<W, Q, W>(sm.act, as, acc, net.fscl, net.fb, nullptr, false);
    __syncthreads();

    // ---- color branch: feature rows per sample + direction part of the
    // warpgroup's ray
    mma_start<W>(acc);
    mma_segment<W, Q, C, TRACE, PIPELINE>(acc, rg, sm.act, as, nkh, &waited);
    mma_finish<W>(acc);
    __syncthreads();
    const int kw = wk.k0 + wk.ray_of(c0 + SLAB * (tid >> 7));
    store<W, Q, C>(sm.act, as, acc, net.color.scl, sm.cold + kw * C, net.cb,
                   true);
    __syncthreads();
    lap_mlp<TRACE>(waited);

    // ---- rgb head (exact) + sigmoid ------------------------------------
    const int rows = wk.rows(c0);
    for (int idx = tid; idx < 3 * rows; idx += NT) {
      const int c = idx / rows, s = idx % rows;
      float r = 0.f;
      for (int k = 0; k < C; ++k) r = fmaf(sm.act[s * as + k], net.rw[k * 3 + c], r);
      r = __fadd_rn(r, net.rb[c]);
      sm.rgb[s * 3 + c] = 1.0f / (1.0f + expf(-r));
    }
    __syncthreads();
    lap<TRACE, PH_SCALAR>();

    // ---- VRU over the chunk's rows, done before the next chunk's heads
    // overwrite sig and rgb (the MLP's barriers lie between) -------------
    vru_rows(sm, wk, c0, rows);
  }
  __syncthreads();
  lap<TRACE, PH_SCALAR>();
}

// rays r .. r + nr - 1 -> the block's ray slots (o, d), and their
// normalized directions -> ped (every thread of the block calls it;
// thread 8k + i takes ray k's component i)
__device__ void load_rays(const Dims& D, Smem& sm, const float* o,
                          const float* d, int r, int nr) {
  const int k = threadIdx.x >> 3, i = threadIdx.x & 7;
  float* ray = sm.ray + 8 * k;
  if (k < nr && i < 6)
    ray[i] = i < 3 ? o[3 * (r + k) + i] : d[3 * (r + k) + i - 3];
  __syncthreads();
  if (k < nr && i < 3) {
    const float* dk = ray + 3;
    const float ss = __fadd_rn(__fadd_rn(__fmul_rn(dk[0], dk[0]),
                                         __fmul_rn(dk[1], dk[1])),
                               __fmul_rn(dk[2], dk[2]));
    const float dn = __fmul_rn(dk[i], rsqrtf(ss));
    encode(dn, i, D.dir_freqs, sm.ped + k * sm.ds, 1, 0);
  }
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
    load_rays(D, sm, rays_o, rays_d, r, 1);
    ray_pass<W, C, Q>(net, D, sm, rg, Walk{sm.ts, sm.dl, sm.wbuf, 0, N, 0, 1});
    for (int n = threadIdx.x; n < N; n += NT) w_out[(size_t)r * N + n] = sm.wbuf[n];
    if (threadIdx.x < 3) rgb[3 * r + threadIdx.x] = sm.res[threadIdx.x];
    if (threadIdx.x == 0) acc_out[r] = sm.res[RES_ACC];
    __syncthreads();
  }
}

// --------------------------------------------------------------- K2 -------
// a ray's rgb from its res slot to dst; with white, composited onto a
// white background with its acc, rgb + (1 - acc), rounded as the caller's
// composite would be (volume.white_background)
__device__ __forceinline__ void put_rgb(float* dst, const float* v,
                                        int white) {
  for (int c = 0; c < 3; ++c)
    dst[c] = white ? __fadd_rn(v[c], __fsub_rn(1.f, v[RES_ACC])) : v[c];
}

// The rays under way in two_pass_rays: nr of them from ray r, and in bit
// k of live whether ray r + k takes its fine pass. In shared memory, read
// where used, so neither holds a register through a pass: at full width
// the MLP layers take every register a thread has (the f32 instance ran
// 6% slower with them in registers).
struct Group {
  int nr, live;
};

__device__ __forceinline__ Group& group_now() {
  __shared__ Group g;
  return g;
}

// The rays of one block's tile: coarse pass through rgc, fine pass through
// rgf (the same ring when both networks have one format). Where a pass
// pairs (k2_group), the block takes its rays two at a time: the pair's
// coarse pass walks both rays at once when pairs(Nc), its fine pass when
// both live and pairs(Nt); otherwise each ray walks alone, as does the
// last ray of an odd tile. The pair's CDFs run side by side, on two
// threads. TRACE: the resample goes to PH_RESAMPLE, loading and encoding
// the rays to PH_SCALAR. One pass's k loops are pipelined: with both
// passes' loops pipelined ptxas finds too few registers for the wgmma
// pipeline and serialises every wgmma (C7512). The fine pass takes it
// where its ring allows (it walks 3 of every 4 chunks at 64 + 128
// samples), else the coarse pass.
template <int W, int C, bool QC, bool QF, bool TRACE>
__device__ PLCORE_PASS void two_pass_rays(
    Ring<W, QC>& rgc, Ring<W, QF>& rgf, const Net& netc, const Net& netf,
    const Dims& D, Smem& sm, int Nc, int Nf, int ert, float thr, int white,
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ alive, float* __restrict__ rgb,
    float* __restrict__ rgb_c, float* __restrict__ acc,
    float* __restrict__ acc_c, float* __restrict__ depth) {
  const int Nt = Nc + Nf, M1 = Nc - 1, tid = threadIdx.x;
  const int group = k2_group(Nc, Nf);
  const int r_end = min(D.R, (int)(blockIdx.x + 1) * D.rt);
  const Group& g = group_now();
  // rays a walk of either pass takes at once
  const auto coarse_rays = [&] { return g.nr == 2 && pairs(Nc) ? 2 : 1; };
  const auto fine_rays = [&] { return g.live == 3 && pairs(Nt) ? 2 : 1; };
  for (int r = blockIdx.x * D.rt; r < r_end; r += group) {
    const int nr = min(group, r_end - r);
    if (tid == 0) group_now() = Group{nr, 0};
    lap<TRACE, -1>();
    load_rays(D, sm, rays_o, rays_d, r, nr);
    lap<TRACE, PH_SCALAR>();

    // ---- pass 1: coarse, over the pinned row -----------------------------
    for (int k = 0; k < g.nr; k += coarse_rays())
      ray_pass<W, C, QC, TRACE, (!k_pipelined<W, QF>())>(
          netc, D, sm, rgc, Walk{sm.tc, sm.dlc, sm.wbuf, 0, Nc, k,
                                 coarse_rays()});
    int live = 0;
    for (int k = 0; k < g.nr; ++k) {
      bool l = true;
      if (ert) l = sm.res[8 * k + RES_ACC] < thr;
      if (alive) l = l && alive[r + k] > 0.f;
      live |= (int)l << k;
    }
    if (tid == 0) group_now().live = live;

    if (tid < g.nr) {
      const float* v = sm.res + 8 * tid;
      const int q = r + tid;
      put_rgb(rgb_c + 3 * q, v, white);
      acc_c[q] = v[RES_ACC];
      if (!((live >> tid) & 1)) {   // a dead ray keeps the coarse estimate
        put_rgb(rgb + 3 * q, v, white);
        acc[q] = v[RES_ACC];
        depth[q] = v[RES_DEPTH];
      }
    }
    if (!live) {
      __syncthreads();
      continue;
    }

    // ---- inverse-CDF resample over the interior coarse weights, per live
    // ray; ray k's CDF on lane 0 of warp k ---------------------------------
    if ((tid & 31) == 0 && ((live >> (tid >> 5)) & 1)) {
      const int k = tid >> 5;
      const float* wb = sm.wbuf + k * Nc;
      float* cdf = sm.cdf + k * Nc;
      float wsum = 0.f;
      for (int i = 1; i < Nc - 1; ++i)
        wsum = __fadd_rn(wsum, __fadd_rn(wb[i], 1e-5f));
      float c = 0.f;
      cdf[0] = 0.f;
      for (int i = 1; i < Nc - 1; ++i) {
        c = __fadd_rn(c, __fdiv_rn(__fadd_rn(wb[i], 1e-5f), wsum));
        cdf[i] = c;
      }
    }
    __syncthreads();
    for (int k = 0; k < g.nr; ++k) {
      if (!((live >> k) & 1)) continue;
      const float* cdf = sm.cdf + k * Nc;
      for (int j = tid; j < Nf; j += NT) {
        const float u = sm.u[j];
        int lo = 0, hi = M1;            // count of cdf entries <= u
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cdf[mid] <= u) lo = mid + 1; else hi = mid;
        }
        const int i = min(max(lo - 1, 0), M1 - 2);
        const float cl = cdf[i], chh = cdf[i + 1];
        const float tl = sm.tc[i], th = sm.tc[i + 1];
        const float diff = __fsub_rn(chh, cl);
        const float den = diff < 1e-8f ? 1.0f : diff;
        const float frac = __fdiv_rn(__fsub_rn(u, cl), den);
        sm.tf[k * Nf + j] = __fadd_rn(tl, __fmul_rn(frac, __fsub_rn(th, tl)));
      }
    }
    __syncthreads();

    // ---- sorted merge, ties to the coarse sample --------------------------
    for (int k = 0; k < g.nr; ++k) {
      if (!((live >> k) & 1)) continue;
      const float* tf = sm.tf + k * Nf;
      float* ts = sm.ts + k * Nt;
      for (int i = tid; i < Nt; i += NT) {
        if (i < Nc) {
          const float v = sm.tc[i];
          int lo = 0, hi = Nf;            // count of tf < v
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (tf[mid] < v) lo = mid + 1; else hi = mid;
          }
          ts[i + lo] = v;
        } else {
          const int j = i - Nc;
          const float v = tf[j];
          int lo = 0, hi = Nc;            // count of tc <= v
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (sm.tc[mid] <= v) lo = mid + 1; else hi = mid;
          }
          ts[j + lo] = v;
        }
      }
    }
    __syncthreads();
    for (int k = 0; k < g.nr; ++k) {
      if (!((live >> k) & 1)) continue;
      const float* ts = sm.ts + k * Nt;
      for (int n = tid; n < Nt; n += NT)
        sm.dl[k * Nt + n] = n + 1 < Nt ? __fsub_rn(ts[n + 1], ts[n]) : 1e10f;
    }
    __syncthreads();
    lap<TRACE, PH_RESAMPLE>();

    // ---- pass 2: fine over the merged samples -----------------------------
    for (int k = 0; k < g.nr; k += fine_rays())
      if (fine_rays() == 2 || ((g.live >> k) & 1))
        ray_pass<W, C, QF, TRACE>(netf, D, sm, rgf,
                                  Walk{sm.ts, sm.dl, nullptr, Nt, Nt, k,
                                       fine_rays()});
    if (tid < g.nr && ((g.live >> tid) & 1)) {
      const float* v = sm.res + 8 * tid;
      const int q = r + tid;
      put_rgb(rgb + 3 * q, v, white);
      acc[q] = v[RES_ACC];
      depth[q] = v[RES_DEPTH];
    }
    __syncthreads();
  }
}

// TRACE: the traced instance, which writes each block's phase cycles to
// its row of phase_cycles (PH_OUT int64 a row, pinned host memory); the
// untraced one never reads it.
template <int W, int C, bool QC, bool QF, bool TRACE>
__global__ void __launch_bounds__(NT, min_blocks<W>())
plcore_two_pass_kernel(Net netc, Net netf, Dims D, int Nc, int Nf, int ert,
                       float thr, int white,
                       const float* __restrict__ rays_o,
                       const float* __restrict__ rays_d,
                       const float* __restrict__ t_row,
                       const float* __restrict__ u_row,
                       const float* __restrict__ alive,
                       float* __restrict__ rgb, float* __restrict__ rgb_c,
                       float* __restrict__ acc, float* __restrict__ acc_c,
                       float* __restrict__ depth,
                       long long* __restrict__ phase_cycles) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  phases_begin<TRACE>();
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
    two_pass_rays<W, C, QC, QF, TRACE>(rgc, rgc, netc, netf, D, sm, Nc, Nf,
                                       ert, thr, white, rays_o, rays_d,
                                       alive, rgb, rgb_c, acc, acc_c, depth);
  } else {
    Ring<W, QF> rgf;
    ring_init<W, QF>(rgf, sm, D, Ring<W, QC>::NS);
    two_pass_rays<W, C, QC, QF, TRACE>(rgc, rgf, netc, netf, D, sm, Nc, Nf,
                                       ert, thr, white, rays_o, rays_d,
                                       alive, rgb, rgb_c, acc, acc_c, depth);
  }
  phases_end<TRACE>(phase_cycles);
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

// TRACE: the traced instance, writing to the phase rows at
// ptrs[10 + 2 * NET_PTRS] (a row a block, in pinned host memory)
template <int W, int C, bool QC, bool QF, bool TRACE>
int k2_launch(const void* const* ptrs, const int* dims, float thr,
              void* stream) {
  const Dims D = make_dims(dims);
  const int Nc = dims[10], Nf = dims[11], ert = dims[14], white = dims[15];
  if (!dims_ok<W, C>(D) || Nc < 3 || Nf < 1) return (int)cudaErrorInvalidValue;
  const Net nc = make_net(ptrs + 10, D.C);
  const Net nf = make_net(ptrs + 10 + NET_PTRS, D.C);
  const dim3 grid((D.R + D.rt - 1) / D.rt);
  const float* in[5];
  for (int i = 0; i < 5; ++i) in[i] = static_cast<const float*>(ptrs[i]);
  float* out[5];
  for (int i = 0; i < 5; ++i)
    out[i] = static_cast<float*>(const_cast<void*>(ptrs[5 + i]));
  long long* phase = TRACE ? static_cast<long long*>(const_cast<void*>(
                                ptrs[10 + 2 * NET_PTRS]))
                          : nullptr;
  const size_t smem = carve<W, QC, QF>(nullptr, nullptr, D, Nc + Nf, Nc, Nf);
  auto kernel = plcore_two_pass_kernel<W, C, QC, QF, TRACE>;
  cudaError_t e = launch_setup(kernel, smem);
  if (e) return (int)e;
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      nc, nf, D, Nc, Nf, ert, thr, white, in[0], in[1], in[2], in[3], in[4],
      out[0], out[1], out[2], out[3], out[4], phase);
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
  return (int)resident(plcore_two_pass_kernel<W, C, QC, QF, false>,
                       carve<W, QC, QF>(nullptr, nullptr, D, Nc + Nf, Nc, Nf),
                       blocks);
}

}  // namespace plcore

// Explicit instances of one width pair: the same-format family (K1 and
// K2, f32 and RMCM) or the mixed K2 family (qc != qf), and K2's traced
// instances of either family (translation units of their own, so nvcc
// builds them beside the untraced ones).
#define PLCORE_INSTANCES_SAME(W, C)                                          \
  template int plcore::k1_launch<W, C, false>(const void* const*,            \
                                              const int*, void*);            \
  template int plcore::k1_launch<W, C, true>(const void* const*,             \
                                             const int*, void*);             \
  template int plcore::k2_launch<W, C, false, false, false>(                 \
      const void* const*, const int*, float, void*);                         \
  template int plcore::k2_launch<W, C, true, true, false>(                   \
      const void* const*, const int*, float, void*);                         \
  template int plcore::k1_resident<W, C, false>(const int*, int*);           \
  template int plcore::k1_resident<W, C, true>(const int*, int*);            \
  template int plcore::k2_resident<W, C, false, false>(const int*, int*);    \
  template int plcore::k2_resident<W, C, true, true>(const int*, int*);

#define PLCORE_INSTANCES_FORMAT(W, C, Q)                                     \
  template int plcore::k1_launch<W, C, Q>(const void* const*, const int*,    \
                                          void*);                            \
  template int plcore::k2_launch<W, C, Q, Q, false>(                         \
      const void* const*, const int*, float, void*);                         \
  template int plcore::k1_resident<W, C, Q>(const int*, int*);               \
  template int plcore::k2_resident<W, C, Q, Q>(const int*, int*);

#define PLCORE_INSTANCES_MIXED(W, C)                                         \
  template int plcore::k2_launch<W, C, false, true, false>(                  \
      const void* const*, const int*, float, void*);                         \
  template int plcore::k2_launch<W, C, true, false, false>(                  \
      const void* const*, const int*, float, void*);                         \
  template int plcore::k2_resident<W, C, false, true>(const int*, int*);     \
  template int plcore::k2_resident<W, C, true, false>(const int*, int*);

#define PLCORE_INSTANCE_TRACED(W, C, QC, QF)                                 \
  template int plcore::k2_launch<W, C, QC, QF, true>(                        \
      const void* const*, const int*, float, void*);
