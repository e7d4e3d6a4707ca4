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
// 2-layer config.

#include <cuda_runtime.h>

#define PLCORE_WIDTHS(X) X(256, 128) X(64, 32) X(32, 16)

namespace plcore {
template <int W, int C, bool Q>
int k1_launch(const void* const* ptrs, const int* dims, void* stream);
template <int W, int C, bool QC, bool QF>
int k2_launch(const void* const* ptrs, const int* dims, float thr,
              void* stream);
template <int W, int C, bool Q>
int k1_resident(const int* dims, int* blocks);
template <int W, int C, bool QC, bool QF>
int k2_resident(const int* dims, int* blocks);
}  // namespace plcore

namespace {

template <int W, int C>
int k1(const void* const* ptrs, const int* dims, void* stream) {
  return dims[11] ? plcore::k1_launch<W, C, true>(ptrs, dims, stream)
                  : plcore::k1_launch<W, C, false>(ptrs, dims, stream);
}

template <int W, int C>
int k2(const void* const* ptrs, const int* dims, float thr, void* stream) {
  const int qc = dims[12], qf = dims[13];
  if (qc && qf) return plcore::k2_launch<W, C, true, true>(ptrs, dims, thr, stream);
  if (qc) return plcore::k2_launch<W, C, true, false>(ptrs, dims, thr, stream);
  if (qf) return plcore::k2_launch<W, C, false, true>(ptrs, dims, thr, stream);
  return plcore::k2_launch<W, C, false, false>(ptrs, dims, thr, stream);
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
// depth, net_c[14], net_f[14].
// dims: R, rt, W, L, skip_mask, C, pos_freqs, dir_freqs, P, P2, Nc, Nf,
// qc, qf, ert. thr: a ray stays alive while acc_c < thr (under ert).
int plcore_two_pass(const void* const* ptrs, const int* dims, float thr,
                    void* stream) {
#define PLCORE_K2(W, C) \
  if (dims[2] == W && dims[5] == C) return k2<W, C>(ptrs, dims, thr, stream);
  PLCORE_WIDTHS(PLCORE_K2)
#undef PLCORE_K2
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
