// The fused PLCore kernels (plcore_kernels.cuh) at W = 256, C = 128: K2's
// traced instances with a coarse and a fine network of different weight
// formats.
#define PLCORE_INLINE_PASSES
#include "plcore_kernels.cuh"

PLCORE_INSTANCE_TRACED(256, 128, false, true)
PLCORE_INSTANCE_TRACED(256, 128, true, false)
