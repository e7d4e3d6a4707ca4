// The fused PLCore kernels (plcore_kernels.cuh) at W = 64, C = 32: K2's
// traced instances with both networks in one weight format.
#include "plcore_kernels.cuh"

PLCORE_INSTANCE_TRACED(64, 32, false, false)
PLCORE_INSTANCE_TRACED(64, 32, true, true)
