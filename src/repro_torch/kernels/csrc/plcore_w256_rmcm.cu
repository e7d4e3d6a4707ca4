// The fused PLCore kernels (plcore_kernels.cuh) at W = 256, C = 128: K1 and
// K2 with both networks in RMCM weights, whose k loops are pipelined.
#define PLCORE_INLINE_PASSES
#include "plcore_kernels.cuh"

PLCORE_INSTANCES_FORMAT(256, 128, true)
