// The fused PLCore kernels (plcore_kernels.cuh) at W = 256, C = 128: K2 with
// a coarse and a fine network of different weight formats.
#define PLCORE_INLINE_PASSES
#include "plcore_kernels.cuh"

PLCORE_INSTANCES_MIXED(256, 128)
