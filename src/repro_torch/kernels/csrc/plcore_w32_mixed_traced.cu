// The fused PLCore kernels (plcore_kernels.cuh) at W = 32, C = 16: K2's
// traced instances with a coarse and a fine network of different weight
// formats.
#include "plcore_kernels.cuh"

PLCORE_INSTANCE_TRACED(32, 16, false, true)
PLCORE_INSTANCE_TRACED(32, 16, true, false)
