// The fused PLCore kernels (plcore_kernels.cuh) at W = 256, C = 128: K1 and
// K2 with both networks in one weight format (f32 or RMCM).
#include "plcore_kernels.cuh"

PLCORE_INSTANCES_SAME(256, 128)
