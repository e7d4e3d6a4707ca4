// The fused PLCore kernels (plcore_kernels.cuh) at W = 256, C = 128: K2's
// traced instances with both networks in one weight format.
#define PLCORE_INLINE_PASSES
#include "plcore_kernels.cuh"

PLCORE_INSTANCE_TRACED(256, 128, false, false)
PLCORE_INSTANCE_TRACED(256, 128, true, true)
