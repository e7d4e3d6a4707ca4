// The fused PLCore kernels (plcore_kernels.cuh) at W = 32, C = 16: K1 and
// K2 with both networks in one weight format (f32 or RMCM).
#include "plcore_kernels.cuh"

PLCORE_INSTANCES_SAME(32, 16)
