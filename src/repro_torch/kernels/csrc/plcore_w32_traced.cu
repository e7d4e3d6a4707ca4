// The fused PLCore kernels (plcore_kernels.cuh) at W = 32, C = 16: K2's
// traced instances with both networks in one weight format.
#include "plcore_kernels.cuh"

PLCORE_INSTANCE_TRACED(32, 16, false, false)
PLCORE_INSTANCE_TRACED(32, 16, true, true)
