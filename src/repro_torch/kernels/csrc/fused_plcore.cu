// Fused PLCore kernels for Hopper (sm_90a): the whole NeRF pass, PEU ->
// MLP engine -> VRU, inside one thread block per ray tile.
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
// So the bound is fp32 FMA throughput of the CUDA cores.
//
// What the design does about it:
// * A block owns whole rays and walks its tile one ray at a time, 64
//   samples per chunk. Activations of a chunk live in shared memory as
//   (features x samples) rows; a layer is computed with every thread
//   holding 2 output columns x 32 samples in registers (64 accumulators),
//   so each broadcast float4 read of shared memory feeds 8 FMAs and each
//   weight read from L2 feeds 32. The layer's output overwrites its input
//   in place after a barrier, so one buffer holds the chunk.
// * Weights (7.2 MB for both f32 networks) stay resident in the 50 MB L2
//   and stream through registers, one k-row per step; RMCM weights are
//   dequantized in registers as mag * (1 - 2 sign) * scale, as the
//   reference's _dq does, so the dequantized values are bit-identical.
// * fp32 FMA throughout: no TF32, no tensor cores.
// * The VRU prefix, the coarse CDF, the inverse-CDF binary search and the
//   sorted merge run inside the block: coarse weights, sample positions
//   and resample scratch never leave shared memory. The prefix sums run
//   sequentially per ray, in the order cumsum adds, with explicitly
//   rounded operations (no FMA contraction), because the resampler turns
//   last-ulp differences into moved samples.
// * With early ray termination or an alive mask, a dead ray skips its
//   fine pass and keeps its coarse rgb/acc/depth (per ray, no compaction).
//
// Interface: plain C entry points for ctypes. Pointers arrive as an array
// of addresses, shapes as an array of ints; each entry point launches one
// kernel on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int S = 64;         // samples per chunk
constexpr int HS = S / 2;     // samples per thread
constexpr int AS = S + 4;     // activation row stride in floats (16 B aligned)
constexpr int CH = NT / 2;    // a thread owns columns jp and jp + CH
constexpr int MAXW = 2 * CH;  // widest layer a block computes

struct Mat {
  const float* w;       // f32 (rows, ncol), or null under RMCM
  const uint8_t* mag;   // RMCM magnitudes (rows, ncol)
  const uint8_t* sgn;   // RMCM sign bits (rows / 8, ncol)
  const float* scl;     // RMCM per-column scale (ncol)
  int ncol;
};

struct Net {
  Mat trunk;            // layer 0 of the (L, P, W) stack
  const float* tb;      // (L, W)
  const float* sw;      // (W, 1)
  const float* sb;      // (1)
  Mat feat;             // (W, W)
  const float* fb;      // (W)
  Mat color;            // (P2, C)
  const float* cb;      // (C)
  const float* rw;      // (C, 3)
  const float* rb;      // (3)
};

struct Dims {
  int R, rt, W, L, skip_mask, C, pos_freqs, dir_freqs, pe, de, P, P2;
};

// the shared-memory carve-up of one block
struct Smem {
  float* act;   // max(W, C) rows x AS: hidden activations of a chunk
  float* pe;    // pe rows x AS: position encoding of a chunk
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

__host__ __device__ inline size_t carve(Smem* sm, float* base, const Dims& D,
                                        int N, int Nc, int Nf) {
  float* p = base;
  auto take = [&](int n) { float* q = p; p += rup4(n); return q; };
  int rows = D.W > D.C ? D.W : D.C;
  Smem s;
  s.act = take(rows * AS);
  s.pe = take(D.pe * AS);
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
  return (size_t)(p - base) * sizeof(float);
}

__device__ __forceinline__ Mat trunk_layer(const Mat& t, int i, const Dims& D) {
  Mat m = t;
  size_t off = (size_t)i * D.P * D.W;
  if (m.w) m.w += off;
  if (m.mag) {
    m.mag += off;
    m.sgn += (size_t)i * (D.P / 8) * D.W;
    m.scl += (size_t)i * D.W;
  }
  return m;
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

// acc[c][s] += sum_k in[k][sh*HS + s] * W[row0 + k][col c]
template <bool Q>
__device__ __forceinline__ void mac(float (&acc)[2][HS], const Mat& m,
                                    int row0, const float* in, int kin,
                                    int j0, int j1, int sh) {
  const float s0 = (Q && j0 >= 0) ? m.scl[j0] : 0.f;
  const float s1 = (Q && j1 >= 0) ? m.scl[j1] : 0.f;
  const float* base = in + sh * HS;
#pragma unroll 2
  for (int k = 0; k < kin; ++k) {
    const float w0 = j0 >= 0 ? wget<Q>(m, row0 + k, j0, s0) : 0.f;
    const float w1 = j1 >= 0 ? wget<Q>(m, row0 + k, j1, s1) : 0.f;
    const float4* x = reinterpret_cast<const float4*>(base + k * AS);
#pragma unroll
    for (int q = 0; q < HS / 4; ++q) {
      const float4 v = x[q];
      acc[0][4 * q + 0] = fmaf(v.x, w0, acc[0][4 * q + 0]);
      acc[0][4 * q + 1] = fmaf(v.y, w0, acc[0][4 * q + 1]);
      acc[0][4 * q + 2] = fmaf(v.z, w0, acc[0][4 * q + 2]);
      acc[0][4 * q + 3] = fmaf(v.w, w0, acc[0][4 * q + 3]);
      acc[1][4 * q + 0] = fmaf(v.x, w1, acc[1][4 * q + 0]);
      acc[1][4 * q + 1] = fmaf(v.y, w1, acc[1][4 * q + 1]);
      acc[1][4 * q + 2] = fmaf(v.z, w1, acc[1][4 * q + 2]);
      acc[1][4 * q + 3] = fmaf(v.w, w1, acc[1][4 * q + 3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][HS]) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int s = 0; s < HS; ++s) acc[c][s] = 0.f;
}

// out[j][sh*HS + s] = act((acc + b1[j]) + b2[j]); b2 may be null
__device__ __forceinline__ void store(float* out, float (&acc)[2][HS], int j0,
                                      int j1, int sh, const float* b1,
                                      const float* b2, bool relu) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = c ? j1 : j0;
    if (j < 0) continue;
    const float bb1 = b1[j];
    const float bb2 = b2 ? b2[j] : 0.f;
    float4* row = reinterpret_cast<float4*>(out + j * AS + sh * HS);
#pragma unroll
    for (int q = 0; q < HS / 4; ++q) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float y = __fadd_rn(acc[c][4 * q + e], bb1);
        if (b2) y = __fadd_rn(y, bb2);
        v[e] = relu ? fmaxf(y, 0.f) : y;
      }
      row[q] = make_float4(v[0], v[1], v[2], v[3]);
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

// One PEU -> MLP -> VRU pass of one ray over N samples at sm.ts / sm.dl
// (or the given arrays). Leaves rgb, acc, depth in sm.res and the per-sample
// weights in sm.wbuf. Every thread of the block calls it.
template <bool Q>
__device__ void ray_pass(const Net& net, const Dims& D, Smem& sm,
                         const float* ts, const float* dl, int N) {
  const int tid = threadIdx.x;
  const int sh = tid / CH, jp = tid % CH;
  const int W = D.W, C = D.C;
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

  float acc[2][HS];
  for (int c0 = 0; c0 < N; c0 += S) {
    // ---- PEU: positions of this chunk, double-angle encoded ----------
    for (int idx = tid; idx < 3 * S; idx += NT) {
      const int s = idx / 3, a = idx % 3;
      const int n = min(c0 + s, N - 1);
      const float x = __fadd_rn(o[a], __fmul_rn(ts[n], d[a]));
      encode(x, a, D.pos_freqs, sm.pe, AS, s);
    }
    __syncthreads();

    // ---- trunk ---------------------------------------------------------
    int j0 = jp < W ? jp : -1;
    int j1 = jp + CH < W ? jp + CH : -1;
    for (int i = 0; i < D.L; ++i) {
      const Mat m = trunk_layer(net.trunk, i, D);
      zero(acc);
      if (i == 0) {
        mac<Q>(acc, m, 0, sm.pe, D.pe, j0, j1, sh);
      } else {
        mac<Q>(acc, m, 0, sm.act, W, j0, j1, sh);
        if ((D.skip_mask >> i) & 1) mac<Q>(acc, m, W, sm.pe, D.pe, j0, j1, sh);
      }
      __syncthreads();
      store(sm.act, acc, j0, j1, sh, net.tb + i * W, nullptr, true);
      __syncthreads();
    }

    // ---- heads: sigma (exact) and feature ------------------------------
    zero(acc);
    mac<Q>(acc, net.feat, 0, sm.act, W, j0, j1, sh);
    if (tid < S) {
      float s = 0.f;
      for (int k = 0; k < W; ++k) s = fmaf(sm.act[k * AS + tid], net.sw[k], s);
      if (c0 + tid < N) sm.sig[c0 + tid] = __fadd_rn(s, net.sb[0]);
    }
    __syncthreads();
    store(sm.act, acc, j0, j1, sh, net.fb, nullptr, false);
    __syncthreads();

    // ---- color branch: feature rows per sample + direction part per ray
    j0 = jp < C ? jp : -1;
    j1 = jp + CH < C ? jp + CH : -1;
    zero(acc);
    mac<Q>(acc, net.color, 0, sm.act, W, j0, j1, sh);
    __syncthreads();
    store(sm.act, acc, j0, j1, sh, sm.cold, net.cb, true);
    __syncthreads();

    // ---- rgb head (exact) + sigmoid ------------------------------------
    for (int idx = tid; idx < 3 * S; idx += NT) {
      const int c = idx / S, s = idx % S;
      float r = 0.f;
      for (int k = 0; k < C; ++k) r = fmaf(sm.act[k * AS + s], net.rw[k * 3 + c], r);
      r = __fadd_rn(r, net.rb[c]);
      if (c0 + s < N) sm.rgb[(c0 + s) * 3 + c] = 1.0f / (1.0f + expf(-r));
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

// --------------------------------------------------------------- K1 -------
template <bool Q>
__global__ void __launch_bounds__(NT, 2)
plcore_fused_kernel(Net net, Dims D, int N, const float* __restrict__ rays_o,
                    const float* __restrict__ rays_d,
                    const float* __restrict__ t,
                    const float* __restrict__ deltas,
                    const float* __restrict__ alive, float* __restrict__ rgb,
                    float* __restrict__ w_out, float* __restrict__ acc_out) {
  extern __shared__ float4 smem_raw[];
  Smem sm;
  carve(&sm, reinterpret_cast<float*>(smem_raw), D, N, 0, 0);
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
    ray_pass<Q>(net, D, sm, sm.ts, sm.dl, N);
    for (int n = threadIdx.x; n < N; n += NT) w_out[(size_t)r * N + n] = sm.wbuf[n];
    if (threadIdx.x < 3) rgb[3 * r + threadIdx.x] = sm.res[threadIdx.x];
    if (threadIdx.x == 0) acc_out[r] = sm.res[3];
    __syncthreads();
  }
}

// --------------------------------------------------------------- K2 -------
template <bool QC, bool QF>
__global__ void __launch_bounds__(NT, 2)
plcore_two_pass_kernel(Net netc, Net netf, Dims D, int Nc, int Nf, int ert,
                       float thr, const float* __restrict__ rays_o,
                       const float* __restrict__ rays_d,
                       const float* __restrict__ t_row,
                       const float* __restrict__ u_row,
                       const float* __restrict__ alive,
                       float* __restrict__ rgb, float* __restrict__ rgb_c,
                       float* __restrict__ acc, float* __restrict__ acc_c,
                       float* __restrict__ depth) {
  extern __shared__ float4 smem_raw[];
  const int Nt = Nc + Nf, M1 = Nc - 1, tid = threadIdx.x;
  Smem sm;
  carve(&sm, reinterpret_cast<float*>(smem_raw), D, Nt, Nc, Nf);
  // the pinned coarse row and u-grid, shared by every ray of the tile
  for (int n = tid; n < Nc; n += NT) {
    sm.tc[n] = t_row[n];
    sm.dlc[n] = n + 1 < Nc ? __fsub_rn(t_row[n + 1], t_row[n]) : 1e10f;
  }
  for (int n = tid; n < Nf; n += NT) sm.u[n] = u_row[n];

  const int r_end = min(D.R, (int)(blockIdx.x + 1) * D.rt);
  for (int r = blockIdx.x * D.rt; r < r_end; ++r) {
    load_ray(sm, rays_o, rays_d, r);
    encode_dir(D, sm);

    // ---- pass 1: coarse --------------------------------------------------
    ray_pass<QC>(netc, D, sm, sm.tc, sm.dlc, Nc);
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
    ray_pass<QF>(netf, D, sm, sm.ts, sm.dl, Nt);
    if (tid == 0) {
      rgb[3 * r + 0] = sm.res[0]; rgb[3 * r + 1] = sm.res[1];
      rgb[3 * r + 2] = sm.res[2];
      acc[r] = sm.res[3];
      depth[r] = sm.res[4];
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ host side ---
Net make_net(const void* const* p, int W, int C) {
  // order: tw tb sw sb fw fb cw cb rw rb tmag tsgn tscl fmag fsgn fscl
  //        cmag csgn cscl
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  auto b = [&](int i) { return static_cast<const uint8_t*>(p[i]); };
  Net n;
  n.trunk = Mat{f(0), b(10), b(11), f(12), W};
  n.tb = f(1); n.sw = f(2); n.sb = f(3);
  n.feat = Mat{f(4), b(13), b(14), f(15), W};
  n.fb = f(5);
  n.color = Mat{f(6), b(16), b(17), f(18), C};
  n.cb = f(7); n.rw = f(8); n.rb = f(9);
  return n;
}

Dims make_dims(const int* v) {
  Dims D;
  D.R = v[0]; D.rt = v[1]; D.W = v[2]; D.L = v[3]; D.skip_mask = v[4];
  D.C = v[5]; D.pos_freqs = v[6]; D.dir_freqs = v[7];
  D.pe = 3 + 6 * D.pos_freqs; D.de = 3 + 6 * D.dir_freqs;
  D.P = v[8]; D.P2 = v[9];
  return D;
}

bool dims_ok(const Dims& D) {
  return D.W > 0 && D.W <= MAXW && D.C > 0 && D.C <= MAXW && D.rt > 0 &&
         D.R > 0 && D.P % 8 == 0 && D.P >= D.W + D.pe && D.P2 >= D.W + D.de;
}

template <typename K>
cudaError_t launch_setup(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

// K1. ptrs: rays_o, rays_d, t, deltas, alive|null, rgb, w, acc, net[19].
// dims: R, rt, W, L, skip_mask, C, pos_freqs, dir_freqs, P, P2, N, quantized.
int plcore_fused(const void* const* ptrs, const int* dims, void* stream) {
  const Dims D = make_dims(dims);
  const int N = dims[10], q = dims[11];
  if (!dims_ok(D) || N < 1) return (int)cudaErrorInvalidValue;
  const Net net = make_net(ptrs + 8, D.W, D.C);
  const size_t smem = carve(nullptr, nullptr, D, N, 0, 0);
  const dim3 grid((D.R + D.rt - 1) / D.rt);
  const float* o = static_cast<const float*>(ptrs[0]);
  const float* d = static_cast<const float*>(ptrs[1]);
  const float* t = static_cast<const float*>(ptrs[2]);
  const float* dl = static_cast<const float*>(ptrs[3]);
  const float* alive = static_cast<const float*>(ptrs[4]);
  float* rgb = static_cast<float*>(const_cast<void*>(ptrs[5]));
  float* w = static_cast<float*>(const_cast<void*>(ptrs[6]));
  float* acc = static_cast<float*>(const_cast<void*>(ptrs[7]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q) {
    if ((e = launch_setup(plcore_fused_kernel<true>, smem))) return (int)e;
    plcore_fused_kernel<true><<<grid, NT, smem, st>>>(net, D, N, o, d, t, dl,
                                                      alive, rgb, w, acc);
  } else {
    if ((e = launch_setup(plcore_fused_kernel<false>, smem))) return (int)e;
    plcore_fused_kernel<false><<<grid, NT, smem, st>>>(net, D, N, o, d, t, dl,
                                                       alive, rgb, w, acc);
  }
  return (int)cudaGetLastError();
}

// K2. ptrs: rays_o, rays_d, t_row, u_row, alive|null, rgb, rgb_c, acc, acc_c,
// depth, net_c[19], net_f[19].
// dims: R, rt, W, L, skip_mask, C, pos_freqs, dir_freqs, P, P2, Nc, Nf,
// qc, qf, ert. thr: a ray stays alive while acc_c < thr (under ert).
int plcore_two_pass(const void* const* ptrs, const int* dims, float thr,
                    void* stream) {
  const Dims D = make_dims(dims);
  const int Nc = dims[10], Nf = dims[11], qc = dims[12], qf = dims[13];
  const int ert = dims[14];
  if (!dims_ok(D) || Nc < 3 || Nf < 1) return (int)cudaErrorInvalidValue;
  const Net nc = make_net(ptrs + 10, D.W, D.C);
  const Net nf = make_net(ptrs + 29, D.W, D.C);
  const size_t smem = carve(nullptr, nullptr, D, Nc + Nf, Nc, Nf);
  const dim3 grid((D.R + D.rt - 1) / D.rt);
  const float* in[5];
  for (int i = 0; i < 5; ++i) in[i] = static_cast<const float*>(ptrs[i]);
  float* out[5];
  for (int i = 0; i < 5; ++i)
    out[i] = static_cast<float*>(const_cast<void*>(ptrs[5 + i]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define PLCORE_K2(A, B)                                                       \
  if ((e = launch_setup(plcore_two_pass_kernel<A, B>, smem))) return (int)e;  \
  plcore_two_pass_kernel<A, B><<<grid, NT, smem, st>>>(                       \
      nc, nf, D, Nc, Nf, ert, thr, in[0], in[1], in[2], in[3], in[4], out[0], \
      out[1], out[2], out[3], out[4]);
  if (qc && qf) { PLCORE_K2(true, true) }
  else if (qc) { PLCORE_K2(true, false) }
  else if (qf) { PLCORE_K2(false, true) }
  else { PLCORE_K2(false, false) }
#undef PLCORE_K2
  return (int)cudaGetLastError();
}

}  // extern "C"
