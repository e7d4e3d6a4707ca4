// K2's Mip-NeRF instance (plcore_mip.cuh) at W = 256, C = 128, float32
// weights: the published Mip-NeRF network.
#include "plcore_mip.cuh"

PLCORE_MIP_INSTANCE(256, 128, false)
PLCORE_MIP_RESIDENT(256, 128)
