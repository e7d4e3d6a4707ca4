// The fused PLCore kernels (plcore_kernels.cuh) at W = 64, C = 32: K2 with
// a coarse and a fine network of different weight formats.
#include "plcore_kernels.cuh"

PLCORE_INSTANCES_MIXED(64, 32)
