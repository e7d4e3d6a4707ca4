// The fused PLCore kernels (plcore_kernels.cuh) at W = 256, C = 128: K1 and
// K2 with both networks in float32 weights.
#include "plcore_kernels.cuh"

PLCORE_INSTANCES_FORMAT(256, 128, false)
