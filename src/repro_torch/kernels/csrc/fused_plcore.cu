// C interface of the fused PLCore kernels (K1, K2) for ctypes: the
// kernels are templates over the layer widths and the weight formats
// (plcore_kernels.cuh), instantiated per width pair in plcore_w*.cu; each
// entry point here reads the widths and formats from `dims` and launches
// the matching instance on the given stream, returning
// cudaGetLastError(), or cudaErrorInvalidValue for a width pair that is
// not built. Pointers arrive as an array of addresses, shapes as an array
// of ints.
//
// Built width pairs (W, C), the list kernels/fused_plcore.py
// KERNEL_WIDTHS names: (256, 128), the full NerfConfig; (64, 32), tiny()
// and the reference kernel tests' 5-layer config; (32, 16), their
// 2-layer config. K2's Mip-NeRF instance (plcore_mip.cuh) at the pairs
// of MIP_KERNEL_WIDTHS: (256, 128), the published MipNerfConfig, and
// (64, 32), its tiny().

#include <cuda_runtime.h>

#define PLCORE_WIDTHS(X) X(256, 128) X(64, 32) X(32, 16)
#define PLCORE_MIP_WIDTHS(X) X(256, 128) X(64, 32)

namespace plcore {
template <int W, int C, bool Q>
int k1_launch(const void* const* ptrs, const int* dims, void* stream);
template <int W, int C, bool QC, bool QF, bool TRACE>
int k2_launch(const void* const* ptrs, const int* dims, float thr,
              void* stream);
template <int W, int C, bool Q>
int k1_resident(const int* dims, int* blocks);
template <int W, int C, bool QC, bool QF>
int k2_resident(const int* dims, int* blocks);
template <int W, int C, bool TRACE>
int k2_mip_launch(const void* const* ptrs, const int* dims, void* stream);
template <int W, int C>
int k2_mip_resident(const int* dims, int* blocks);
}  // namespace plcore

namespace {

template <int W, int C>
int k1(const void* const* ptrs, const int* dims, void* stream) {
  return dims[11] ? plcore::k1_launch<W, C, true>(ptrs, dims, stream)
                  : plcore::k1_launch<W, C, false>(ptrs, dims, stream);
}

template <int W, int C, bool TRACE>
int k2_formats(const void* const* ptrs, const int* dims, float thr,
               void* stream) {
  const int qc = dims[12], qf = dims[13];
  if (qc && qf)
    return plcore::k2_launch<W, C, true, true, TRACE>(ptrs, dims, thr, stream);
  if (qc)
    return plcore::k2_launch<W, C, true, false, TRACE>(ptrs, dims, thr, stream);
  if (qf)
    return plcore::k2_launch<W, C, false, true, TRACE>(ptrs, dims, thr, stream);
  return plcore::k2_launch<W, C, false, false, TRACE>(ptrs, dims, thr, stream);
}

// the traced instance when the phase rows (after the 10 tensors and the
// two networks' 14 pointers each) are given
template <int W, int C>
int k2(const void* const* ptrs, const int* dims, float thr, void* stream) {
  return ptrs[10 + 2 * 14] ? k2_formats<W, C, true>(ptrs, dims, thr, stream)
                           : k2_formats<W, C, false>(ptrs, dims, thr, stream);
}

template <int W, int C>
int resident(const int* dims, int kernel, int* blocks) {
  if (kernel == 0)
    return dims[11] ? plcore::k1_resident<W, C, true>(dims, blocks)
                    : plcore::k1_resident<W, C, false>(dims, blocks);
  const int qc = dims[12], qf = dims[13];
  if (qc && qf) return plcore::k2_resident<W, C, true, true>(dims, blocks);
  if (qc) return plcore::k2_resident<W, C, true, false>(dims, blocks);
  if (qf) return plcore::k2_resident<W, C, false, true>(dims, blocks);
  return plcore::k2_resident<W, C, false, false>(dims, blocks);
}

}  // namespace

extern "C" {

// K1. ptrs: rays_o, rays_d, t, deltas, alive|null, rgb, w, acc, net[14].
// dims: R, rt, W, L, skip_mask, C, pos_freqs, dir_freqs, P, P2, N, quantized.
int plcore_fused(const void* const* ptrs, const int* dims, void* stream) {
#define PLCORE_K1(W, C) \
  if (dims[2] == W && dims[5] == C) return k1<W, C>(ptrs, dims, stream);
  PLCORE_WIDTHS(PLCORE_K1)
#undef PLCORE_K1
  return (int)cudaErrorInvalidValue;
}

// K2. ptrs: rays_o, rays_d, t_row, u_row, alive|null, rgb, rgb_c, acc, acc_c,
// depth, net_c[14], net_f[14], phase|null. With phase rows (pinned host
// memory, a row of 9 int64 a block: mlp, ring_wait, resample, scalar,
// total cycles, then the MMA rows and the real sample rows among them,
// the k steps and those issued with the previous one in flight)
// the traced instance runs and writes each block's row; without, the
// untraced one.
// dims: R, rt, W, L, skip_mask, C, pos_freqs, dir_freqs, P, P2, Nc, Nf,
// qc, qf, ert, white. thr: a ray stays alive while acc_c < thr (under
// ert); white: rgb and rgb_c composited onto a white background.
int plcore_two_pass(const void* const* ptrs, const int* dims, float thr,
                    void* stream) {
#define PLCORE_K2(W, C) \
  if (dims[2] == W && dims[5] == C) return k2<W, C>(ptrs, dims, thr, stream);
  PLCORE_WIDTHS(PLCORE_K2)
#undef PLCORE_K2
  return (int)cudaErrorInvalidValue;
}

// K2 for Mip-NeRF (one network for both levels). ptrs: rays (R x 7: o, d
// with camera z = -1, cone radius), t_row and u_row (N + 1 each: the
// coarse edges and the resample grid), rgb, rgb_c, acc, acc_c, depth,
// net[14], phase|null (a row of 10 int64 a block: K2's 9, then the
// encoding's cycles). dims: R, rt, W, L, skip_mask, C, IPE degrees,
// dir_freqs, P, P2, N (intervals a level), white.
int plcore_mip_two_pass(const void* const* ptrs, const int* dims,
                        void* stream) {
  const bool traced = ptrs[8 + 14] != nullptr;
#define PLCORE_K2_MIP(W, C)                                                 \
  if (dims[2] == W && dims[5] == C)                                         \
    return traced ? plcore::k2_mip_launch<W, C, true>(ptrs, dims, stream)   \
                  : plcore::k2_mip_launch<W, C, false>(ptrs, dims, stream);
  PLCORE_MIP_WIDTHS(PLCORE_K2_MIP)
#undef PLCORE_K2_MIP
  return (int)cudaErrorInvalidValue;
}

// Blocks of K2's Mip-NeRF instance resident on one SM (dims as
// plcore_mip_two_pass's), written to *blocks.
int plcore_mip_blocks_per_sm(const int* dims, int* blocks) {
#define PLCORE_MIP_RES(W, C) \
  if (dims[2] == W && dims[5] == C) return plcore::k2_mip_resident<W, C>(dims, blocks);
  PLCORE_MIP_WIDTHS(PLCORE_MIP_RES)
#undef PLCORE_MIP_RES
  return (int)cudaErrorInvalidValue;
}

// Blocks of K1 (kernel 0, dims as plcore_fused's) or K2 (kernel 1, dims as
// plcore_two_pass's) resident on one SM, from the occupancy calculator at
// the launch's shared memory; written to *blocks.
int plcore_blocks_per_sm(const int* dims, int kernel, int* blocks) {
#define PLCORE_RES(W, C) \
  if (dims[2] == W && dims[5] == C) return resident<W, C>(dims, kernel, blocks);
  PLCORE_WIDTHS(PLCORE_RES)
#undef PLCORE_RES
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
