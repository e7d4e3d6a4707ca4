// The fused PLCore kernels (plcore_kernels.cuh) at W = 64, C = 32: K2's
// traced instances with a coarse and a fine network of different weight
// formats.
#include "plcore_kernels.cuh"

PLCORE_INSTANCE_TRACED(64, 32, false, true)
PLCORE_INSTANCE_TRACED(64, 32, true, false)
