// K2's Mip-NeRF instance for Hopper (sm_90a): the whole two-level
// Mip-NeRF render of a tile's cones in one launch, one thread block a ray
// at a time. It reuses plcore_kernels.cuh's pieces as they are (the weight
// ring, the wgmma segments and epilogues, the VRU rows, the phase clock)
// and adds what Mip-NeRF changes; the NeRF instances compile none of it.
//
// Which reference each part follows (github.com/google/mip-nerf):
//   mip_encode      <- internal/mip.py :: cast_rays, conical_frustum_to_
//                      gaussian (stable forms), lift_gaussian,
//                      integrated_pos_enc
//   mip_resample    <- internal/mip.py :: resample_along_rays,
//                      sorted_piecewise_constant_pdf (deterministic)
//   mip_pass        <- internal/models.py :: MLP (8 x 256, the encoding
//                      joined after the 5th layer), the softplus density and
//                      padded sigmoid heads; internal/mip.py ::
//                      volumetric_rendering (deltas (t1 - t0) |d|)
// The plain version of each is kernels/ref.py (mip_two_pass_tile).
//
// What differs from NeRF's K2, and what the design does about it:
// * One network serves both levels: both passes read the same weight
//   stream through the same ring, 128 sample rows a ray and pass, so a
//   chunk is one ray's level, every MMA row real and no pairing.
// * The integrated positional encoding (IPE): per chunk row the frustum's
//   along-ray moments (t_mean, t_var, r_var / r^2; of the coarse edges
//   computed once per block, of a ray's fine edges once per ray), then per
//   row and axis the Gaussian's mean and variance and, per degree l,
//   exp(-4^l var / 2) times sin and cos of 2^l x: 96 features, all sines
//   first, as mip-NeRF orders them. Scaling by 2^l and 4^l is exact; once
//   the weight underflows to zero every higher degree's features are zero,
//   so their sines (the slow argument reduction of large arguments) are
//   never computed.
// * No buffer holds the encoding through the trunk: K = 96 in the first
//   layer and 256 + 96 at the skip layer would need 128 x 100 more floats
//   of shared memory, which with NeRF's three 16 KB ring slots leaves no
//   room below the block's 227 KB. The encoding is written into the
//   activation buffer for the first layer and written there again at the
//   skip layer, after that layer's h segment has read the hidden rows:
//   the encoding is computed twice a chunk, and the ring keeps its three
//   slots.
// * The resample: the coarse weights blurred by neighbour maxima, +0.01,
//   the pdf's CDF summed left to right on one thread, then 129 new edges
//   by a binary search per point of the fixed grid (find_interval's
//   semantics), no merge with the coarse edges.
// * The heads: softplus(raw - 1) density, sigmoid(raw) * 1.002 - 0.001
//   colour, the published constants compiled in (kernels/fused_plcore.py
//   refuses a configuration with others); deltas (t1 - t0) |d| with no far
//   cap; depth sum(w t_mid) / acc clipped to the edges.
// * Traced (TRACE): NeRF's phases with NeRF's meanings (both encodings
//   in the scalar phase), the row counts, and the encoding's cycles alone
//   in the row's tenth slot (MIP_PH_OUT).
//
// Shared memory at full width (W = 256, f32, 128 + 128 samples): the
// ring (3 x 16 KB), its barriers, activations 128 x 260 f32 and the
// per-ray scratch (edges, moments, weights, CDF, grid): 192,832 B, one
// block per SM.

#pragma once

#include "plcore_kernels.cuh"

namespace {

// mip-NeRF's published constants, as float32 operands
constexpr float MIP_DENSITY_BIAS = -1.0f;
constexpr float MIP_RGB_SCALE = (float)(1.0 + 2.0 * 0.001);
constexpr float MIP_RGB_PAD = (float)0.001;
constexpr float MIP_RESAMPLE_PAD = (float)0.01;
constexpr float MIP_PDF_EPS = (float)1e-5;
constexpr float MIP_4_15 = (float)(4.0 / 15.0);
constexpr float MIP_5_12 = (float)(5.0 / 12.0);

// a traced row: NeRF's PH_OUT slots, then the encoding's cycles
constexpr int MIP_PH_OUT = PH_OUT + 1;

// per warpgroup: the encoding's cycles (traced instance)
__device__ __forceinline__ long long* encode_slots() {
  __shared__ __align__(8) long long slots[2];
  return slots;
}

template <bool TRACE>
__device__ __forceinline__ void mip_phases_begin() {
  phases_begin<TRACE>();
  if constexpr (TRACE) {
    if (phase_leader()) encode_slots()[threadIdx.x >> 7] = 0;
  }
}

// the warpgroup's encoding clock: at its start (sign -1) and end (+1)
template <bool TRACE>
__device__ __forceinline__ void encode_lap(int sign) {
  if constexpr (TRACE) {
    if (phase_leader()) encode_slots()[threadIdx.x >> 7] += sign * clock64();
  }
}

template <bool TRACE>
__device__ __forceinline__ void mip_phases_end(long long* rows) {
  if constexpr (TRACE) {
    if (phase_leader()) phase_slots(threadIdx.x >> 7)[PH_TOTAL] += clock64();
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long* a = phase_slots(0);
      const long long* b = phase_slots(1);
      long long* row = rows + (size_t)blockIdx.x * MIP_PH_OUT;
      for (int p = 0; p < PH_OUT; ++p)
        row[p] = a[p] + b[p] - (p == PH_MLP ? a[PH_RING] + b[PH_RING] : 0);
      row[PH_OUT] = encode_slots()[0] + encode_slots()[1];
    }
  }
}

// A ray's values that every row of its encoding reads: o (0..2), d
// (3..5), r (6) as loaded; d_a^2 (8..10), 1 - d_a^2 / |d|^2 (11..13),
// r^2 (14), |d| (15).
enum { MR_D2 = 8, MR_NULL = 11, MR_RR = 14, MR_NORM = 15, MR_SIZE = 16 };

// The shared-memory carve-up of a Mip-NeRF block: the ring and act as in
// NeRF's Smem (pe unused), and the scratch of one ray.
struct MipSmem {
  Smem s;         // ring, barriers, act, ped, cold, res, sig, rgb
  float* ray;     // MR_SIZE: the ray's values
  float* tc;      // N + 1: the coarse edges
  float* gc;      // 3 x N: the coarse moments (t_mean, t_var, r_unit)
  float* mc;      // N: the coarse midpoints
  float* lc;      // N: the coarse interval lengths in t
  float* gf;      // 3 x N: the fine moments
  float* tf;      // N + 1: the fine edges
  float* u;       // N + 1: the resample grid
  float* cdf;     // N + 1
  float* wb;      // N: the coarse weights, then the blurred ones
  float* ts;      // N: this pass's midpoints
  float* dl;      // N: this pass's deltas
};

template <int W>
__host__ __device__ inline size_t carve_mip(MipSmem* ms, uint8_t* base,
                                            const Dims& D, int N) {
  constexpr int NB = ring_barriers<W, false, false>();
  constexpr size_t RB = ring_bytes<W, false, false>();
  const int chunk_rows = N < S ? N : S;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + RB);
  float* p = reinterpret_cast<float*>(bars + 2 * NB);
  float* const fbase = p;
  auto take = [&](int n) { float* q = p; p += rup4(n); return q; };
  MipSmem m;
  Smem& s = m.s;
  s.ring = base;
  s.full = bars;
  s.rel = reinterpret_cast<int*>(bars + NB);
  s.as = stride(D.W > D.C ? D.W : D.C, false);
  s.ps = 0;
  s.ds = rup4(D.de);
  s.act = take(S * s.as);
  s.pe = nullptr;
  s.ped = take(s.ds);
  s.cold = take(D.C);
  s.ray = nullptr;
  s.res = take(8);
  s.sig = take(chunk_rows);
  s.rgb = take(3 * chunk_rows);
  s.wbuf = s.ts = s.dl = s.tc = s.dlc = s.cdf = s.u = s.tf = nullptr;
  m.ray = take(MR_SIZE);
  m.tc = take(N + 1);
  m.gc = take(3 * N);
  m.mc = take(N);
  m.lc = take(N);
  m.gf = take(3 * N);
  m.tf = take(N + 1);
  m.u = take(N + 1);
  m.cdf = take(N + 1);
  m.wb = take(N);
  m.ts = take(N);
  m.dl = take(N);
  if (ms) *ms = m;
  return RB + 16 * NB + (size_t)(p - fbase) * sizeof(float);
}

// the moments of the interval [t0, t1] into g[n], g[N + n], g[2N + n]:
// t_mean, t_var and r_var / r^2, in core/encoding.py frustum_rows' order
__device__ __forceinline__ void frustum(float t0, float t1, float* g, int n,
                                        int N) {
  const float mu = __fmul_rn(__fadd_rn(t0, t1), 0.5f);
  const float hw = __fmul_rn(__fsub_rn(t1, t0), 0.5f);
  const float mu2 = __fmul_rn(mu, mu), hw2 = __fmul_rn(hw, hw);
  const float den = __fadd_rn(__fmul_rn(3.0f, mu2), hw2);
  const float hw4 = __fmul_rn(hw2, hw2);
  g[n] = __fadd_rn(mu, __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, mu), hw2), den));
  g[N + n] = __fsub_rn(
      __fdiv_rn(hw2, 3.0f),
      __fmul_rn(MIP_4_15,
                __fdiv_rn(__fmul_rn(hw4, __fsub_rn(__fmul_rn(12.0f, mu2), hw2)),
                          __fmul_rn(den, den))));
  g[2 * N + n] = __fsub_rn(
      __fadd_rn(__fdiv_rn(mu2, 4.0f), __fmul_rn(MIP_5_12, hw2)),
      __fdiv_rn(__fmul_rn(MIP_4_15, hw4), den));
}

// The IPE of the chunk's rows c0 .. c0 + 127 of one ray (moments g, N
// rows; a row past N repeats row N - 1, computed and never stored) into
// columns 0 .. 6L - 1 of out (row stride ld): thread items (row, axis).
__device__ void mip_encode(const float* ray, const float* g, int N, int c0,
                           int L, float* out, int ld) {
  for (int idx = threadIdx.x; idx < 3 * S; idx += NT) {
    const int s = idx / 3, a = idx % 3;
    const int n = min(c0 + s, N - 1);
    const float x = __fadd_rn(ray[a], __fmul_rn(ray[3 + a], g[n]));
    const float r_var = __fmul_rn(ray[MR_RR], g[2 * N + n]);
    const float v = __fadd_rn(__fmul_rn(g[N + n], ray[MR_D2 + a]),
                              __fmul_rn(r_var, ray[MR_NULL + a]));
    float* row = out + s * ld;
    float sc = 1.0f, sc2 = 1.0f;
    int l = 0;
    for (; l < L; ++l) {
      const float w = expf(__fmul_rn(-0.5f, __fmul_rn(v, sc2)));
      if (w == 0.0f) break;   // and for every higher degree
      float sn, cs;
      sincosf(__fmul_rn(x, sc), &sn, &cs);
      row[3 * l + a] = __fmul_rn(w, sn);
      row[3 * (L + l) + a] = __fmul_rn(w, cs);
      sc = __fmul_rn(sc, 2.0f);
      sc2 = __fmul_rn(sc2, 4.0f);
    }
    for (; l < L; ++l) row[3 * l + a] = row[3 * (L + l) + a] = 0.0f;
  }
}

// The encoding of rows c0.. into act, every thread of the block; TRACE:
// its cycles to the encoding slot (they lie inside the scalar phase)
template <bool TRACE>
__device__ __forceinline__ void encode_chunk(MipSmem& ms, const Dims& D,
                                             const float* g, int N, int c0) {
  encode_lap<TRACE>(-1);
  mip_encode(ms.ray, g, N, c0, D.pos_freqs, ms.s.act, ms.s.as);
  __syncthreads();
  encode_lap<TRACE>(1);
}

// One level of one ray: IPE -> MLP -> VRU over its N intervals (moments
// g, midpoints ms.ts, deltas ms.dl); with w, the VRU's weights go there.
// Leaves rgb, acc and sum(w t_mid) in the ray's res slot. Every thread of
// the block calls it. TRACE: as ray_pass's phases.
template <int W, int C, bool TRACE>
__device__ void mip_pass(const Net& net, const Dims& D, MipSmem& ms,
                         Ring<W, false>& rg, const float* g, int N,
                         float* w) {
  Smem& sm = ms.s;
  const int tid = threadIdx.x;
  const int as = sm.as;
  const int nkh = W / kstep<false>(), nkp = D.kpe / kstep<false>();
  rg.begin(net.stream, rg.per_chunk * ((N + S - 1) / S));

  // direction part of the color layer (the ring's first steps land
  // meanwhile)
  for (int j = tid; j < C; j += NT) {
    float s = 0.f;
    for (int i = 0; i < D.de; ++i)
      s = fmaf(sm.ped[i], wget<false>(net.color, W + i, j, 0.f), s);
    sm.cold[j] = s;
  }

  const Walk wk{ms.ts, ms.dl, w, 0, N, 0, 1};
  Acc<W> acc;
  long long waited = 0;   // TRACE: ring-wait cycles since the last border
  for (int c0 = 0; c0 < N; c0 += S) {
    encode_chunk<TRACE>(ms, D, g, N, c0);
    lap<TRACE, PH_SCALAR>();
    const int rows = wk.rows(c0);
    count_rows<TRACE>(rows);

    // ---- trunk; at a skip layer the encoding is written again into act
    // once the layer's h segment has read it ------------------------------
    for (int i = 0; i < D.L; ++i) {
      mma_start<W>(acc);
      if (i == 0) {
        mma_segment<W, false, W, TRACE>(acc, rg, sm.act, as, nkp, &waited);
      } else {
        mma_segment<W, false, W, TRACE>(acc, rg, sm.act, as, nkh, &waited);
        if ((D.skip_mask >> i) & 1) {
          lap_mlp<TRACE>(waited);
          __syncthreads();
          encode_chunk<TRACE>(ms, D, g, N, c0);
          lap<TRACE, PH_SCALAR>();
          mma_segment<W, false, W, TRACE>(acc, rg, sm.act, as, nkp, &waited);
        }
      }
      mma_finish<W>(acc);
      __syncthreads();
      store<W, false, W>(sm.act, as, acc, nullptr, net.tb + i * W, nullptr,
                         true);
      __syncthreads();
    }

    // ---- heads: density softplus(raw - 1) (exact) and the bottleneck ----
    mma_start<W>(acc);
    mma_segment<W, false, W, TRACE>(acc, rg, sm.act, as, nkh, &waited);
    mma_finish<W>(acc);
    lap_mlp<TRACE>(waited);
    if (tid < rows) {
      float s = 0.f;
      for (int k = 0; k < W; ++k) s = fmaf(sm.act[tid * as + k], net.sw[k], s);
      const float x = __fadd_rn(__fadd_rn(s, net.sb[0]), MIP_DENSITY_BIAS);
      sm.sig[tid] = __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
    }
    __syncthreads();
    lap<TRACE, PH_SCALAR>();
    store<W, false, W>(sm.act, as, acc, nullptr, net.fb, nullptr, false);
    __syncthreads();

    // ---- color branch: bottleneck rows + the ray's direction part --------
    mma_start<W>(acc);
    mma_segment<W, false, C, TRACE>(acc, rg, sm.act, as, nkh, &waited);
    mma_finish<W>(acc);
    __syncthreads();
    store<W, false, C>(sm.act, as, acc, nullptr, sm.cold, net.cb, true);
    __syncthreads();
    lap_mlp<TRACE>(waited);

    // ---- rgb head (exact), padded sigmoid ---------------------------------
    for (int idx = tid; idx < 3 * rows; idx += NT) {
      const int c = idx / rows, s = idx % rows;
      float r = 0.f;
      for (int k = 0; k < C; ++k) r = fmaf(sm.act[s * as + k], net.rw[k * 3 + c], r);
      r = __fadd_rn(r, net.rb[c]);
      const float sg = 1.0f / (1.0f + expf(-r));
      sm.rgb[s * 3 + c] = __fsub_rn(__fmul_rn(sg, MIP_RGB_SCALE), MIP_RGB_PAD);
    }
    __syncthreads();
    lap<TRACE, PH_SCALAR>();
    vru_rows(sm, wk, c0, rows);
  }
  __syncthreads();
  lap<TRACE, PH_SCALAR>();
}

// this pass's midpoints and deltas (t1 - t0) |d| from edges t (every
// thread of the block)
__device__ __forceinline__ void mip_spacing(MipSmem& ms, const float* t,
                                            int N) {
  for (int n = threadIdx.x; n < N; n += NT) {
    ms.ts[n] = __fmul_rn(__fadd_rn(t[n], t[n + 1]), 0.5f);
    ms.dl[n] = __fmul_rn(__fsub_rn(t[n + 1], t[n]), ms.ray[MR_NORM]);
  }
}

// The fine edges ms.tf from the coarse weights ms.wb (every thread of the
// block): blur and pdf on thread 0, in sampling.mip_resample's order, then
// one search per grid point.
__device__ void mip_resample(MipSmem& ms, int N) {
  if (threadIdx.x == 0) {
    float* wb = ms.wb;
    float prev = wb[0];   // the raw weight before i (the first, repeated)
    float sum = 0.f;
    for (int i = 0; i < N; ++i) {
      const float wi = wb[i], wn = wb[min(i + 1, N - 1)];
      const float m0 = fmaxf(prev, wi), m1 = fmaxf(wi, wn);
      wb[i] = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(m0, m1)), MIP_RESAMPLE_PAD);
      sum = __fadd_rn(sum, wb[i]);
      prev = wi;
    }
    const float pad = fmaxf(__fsub_rn(MIP_PDF_EPS, sum), 0.f);
    const float add = __fdiv_rn(pad, (float)N);
    sum = __fadd_rn(sum, pad);
    float c = 0.f;
    ms.cdf[0] = 0.f;
    for (int i = 0; i + 1 < N; ++i) {
      c = __fadd_rn(c, __fdiv_rn(__fadd_rn(wb[i], add), sum));
      ms.cdf[i + 1] = fminf(c, 1.f);
    }
    ms.cdf[N] = 1.f;
  }
  __syncthreads();
  for (int k = threadIdx.x; k <= N; k += NT) {
    const float u = ms.u[k];
    int lo = 0, hi = N + 1;           // count of cdf entries <= u
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ms.cdf[mid] <= u) lo = mid + 1; else hi = mid;
    }
    const int i0 = min(max(lo - 1, 0), N), i1 = min(i0 + 1, N);
    const float c0 = ms.cdf[i0], c1 = ms.cdf[i1];
    const float b0 = ms.tc[i0], b1 = ms.tc[i1];
    float q = __fdiv_rn(__fsub_rn(u, c0), __fsub_rn(c1, c0));
    if (q != q) q = 0.f;
    q = fminf(fmaxf(q, 0.f), 1.f);
    ms.tf[k] = __fadd_rn(b0, __fmul_rn(q, __fsub_rn(b1, b0)));
  }
  __syncthreads();
}

// ray r's values into ms.ray and its direction encoding into ped (every
// thread of the block): unit direction by rsqrt, as NeRF's load_rays
__device__ void mip_load_ray(MipSmem& ms, const Dims& D,
                             const float* __restrict__ rays, int r) {
  const int tid = threadIdx.x;
  float* ray = ms.ray;
  if (tid < 7) ray[tid] = rays[7 * (size_t)r + tid];
  __syncthreads();
  if (tid < 3) {
    const float* d = ray + 3;
    const float ss = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]),
                                         __fmul_rn(d[1], d[1])),
                               __fmul_rn(d[2], d[2]));
    const float d2 = __fmul_rn(d[tid], d[tid]);
    ray[MR_D2 + tid] = d2;
    ray[MR_NULL + tid] = __fsub_rn(1.f, __fdiv_rn(d2, fmaxf(ss, 1e-10f)));
    if (tid == 0) {
      ray[MR_RR] = __fmul_rn(ray[6], ray[6]);
      ray[MR_NORM] = sqrtf(ss);
    }
    const float dn = __fmul_rn(d[tid], rsqrtf(ss));
    float* ped = ms.s.ped;
    const int L = D.dir_freqs;
    ped[tid] = dn;
    float sc = 1.0f;
    for (int l = 0; l < L; ++l) {
      float sn, cs;
      sincosf(__fmul_rn(dn, sc), &sn, &cs);
      ped[3 + 3 * l + tid] = sn;
      ped[3 + 3 * (L + l) + tid] = cs;
      sc = __fmul_rn(sc, 2.0f);
    }
  }
  __syncthreads();
}

// K2 for Mip-NeRF: each block renders its rays one after another, both
// levels through the one network `net`. rays: R x 7 (o, d with camera z
// = -1, r); t_row and u_row: the N + 1 coarse edges and grid points, shared
// by every ray. TRACE: the traced instance (rows of MIP_PH_OUT int64).
template <int W, int C, bool TRACE>
__global__ void __launch_bounds__(NT, min_blocks<W>())
plcore_two_pass_mip_kernel(Net net, Dims D, int N, int white,
                           const float* __restrict__ rays,
                           const float* __restrict__ t_row,
                           const float* __restrict__ u_row,
                           float* __restrict__ rgb, float* __restrict__ rgb_c,
                           float* __restrict__ acc, float* __restrict__ acc_c,
                           float* __restrict__ depth,
                           long long* __restrict__ phase_cycles) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  mip_phases_begin<TRACE>();
  const int tid = threadIdx.x;
  MipSmem ms;
  carve_mip<W>(&ms, smem_raw, D, N);
  for (int n = tid; n <= N; n += NT) {
    ms.tc[n] = t_row[n];
    ms.u[n] = u_row[n];
  }
  __syncthreads();
  for (int n = tid; n < N; n += NT) {
    frustum(ms.tc[n], ms.tc[n + 1], ms.gc, n, N);
    ms.mc[n] = __fmul_rn(__fadd_rn(ms.tc[n], ms.tc[n + 1]), 0.5f);
    ms.lc[n] = __fsub_rn(ms.tc[n + 1], ms.tc[n]);
  }
  Ring<W, false> rg;
  ring_init<W, false>(rg, ms.s, D, 0);
  const int r_end = min(D.R, (int)(blockIdx.x + 1) * D.rt);
  for (int r = blockIdx.x * D.rt; r < r_end; ++r) {
    lap<TRACE, -1>();
    mip_load_ray(ms, D, rays, r);
    for (int n = tid; n < N; n += NT) {
      ms.ts[n] = ms.mc[n];
      ms.dl[n] = __fmul_rn(ms.lc[n], ms.ray[MR_NORM]);
    }
    __syncthreads();
    lap<TRACE, PH_SCALAR>();

    // ---- coarse level over the shared edges -----------------------------
    mip_pass<W, C, TRACE>(net, D, ms, rg, ms.gc, N, ms.wb);
    if (tid == 0) {
      put_rgb(rgb_c + 3 * r, ms.s.res, white);
      acc_c[r] = ms.s.res[RES_ACC];
    }

    // ---- resample, then the fine level's moments and spacing ------------
    mip_resample(ms, N);
    for (int n = tid; n < N; n += NT) frustum(ms.tf[n], ms.tf[n + 1], ms.gf, n, N);
    mip_spacing(ms, ms.tf, N);
    __syncthreads();
    lap<TRACE, PH_RESAMPLE>();

    // ---- fine level -----------------------------------------------------
    mip_pass<W, C, TRACE>(net, D, ms, rg, ms.gf, N, nullptr);
    if (tid == 0) {
      const float* v = ms.s.res;
      put_rgb(rgb + 3 * r, v, white);
      acc[r] = v[RES_ACC];
      float dist = __fdiv_rn(v[RES_DEPTH], v[RES_ACC]);
      if (dist != dist) dist = __int_as_float(0x7f800000);
      depth[r] = fminf(fmaxf(dist, ms.tf[0]), ms.tf[N]);
    }
    __syncthreads();
  }
  mip_phases_end<TRACE>(phase_cycles);
}

}  // namespace

namespace plcore {

// ptrs: rays, t_row, u_row, rgb, rgb_c, acc, acc_c, depth, net[14],
// phase|null; dims: R, rt, W, L, skip_mask, C, IPE degrees, dir_freqs, P,
// P2, N, white
template <int W, int C, bool TRACE>
int k2_mip_launch(const void* const* ptrs, const int* dims, void* stream) {
  Dims D = make_dims(dims);
  D.pe = 6 * D.pos_freqs;
  D.kpe = D.pe;
  const int N = dims[10], white = dims[11];
  if (!dims_ok<W, C>(D) || N < 2 || D.pe % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Net net = make_net(ptrs + 8, D.C);
  const dim3 grid((D.R + D.rt - 1) / D.rt);
  const float* in[3];
  for (int i = 0; i < 3; ++i) in[i] = static_cast<const float*>(ptrs[i]);
  float* out[5];
  for (int i = 0; i < 5; ++i)
    out[i] = static_cast<float*>(const_cast<void*>(ptrs[3 + i]));
  long long* phase = TRACE ? static_cast<long long*>(const_cast<void*>(
                                ptrs[8 + NET_PTRS]))
                          : nullptr;
  const size_t smem = carve_mip<W>(nullptr, nullptr, D, N);
  auto kernel = plcore_two_pass_mip_kernel<W, C, TRACE>;
  cudaError_t e = launch_setup(kernel, smem);
  if (e) return (int)e;
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      net, D, N, white, in[0], in[1], in[2], out[0], out[1], out[2], out[3],
      out[4], phase);
  return (int)cudaGetLastError();
}

template <int W, int C>
int k2_mip_resident(const int* dims, int* blocks) {
  Dims D = make_dims(dims);
  D.pe = 6 * D.pos_freqs;
  D.kpe = D.pe;
  if (!dims_ok<W, C>(D)) return (int)cudaErrorInvalidValue;
  return (int)resident(plcore_two_pass_mip_kernel<W, C, false>,
                       carve_mip<W>(nullptr, nullptr, D, dims[10]), blocks);
}

}  // namespace plcore

#define PLCORE_MIP_INSTANCE(W, C, TRACE)                                     \
  template int plcore::k2_mip_launch<W, C, TRACE>(const void* const*,        \
                                                  const int*, void*);

#define PLCORE_MIP_RESIDENT(W, C)                                            \
  template int plcore::k2_mip_resident<W, C>(const int*, int*);
