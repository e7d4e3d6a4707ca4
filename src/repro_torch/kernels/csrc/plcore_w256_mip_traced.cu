// K2's Mip-NeRF instance (plcore_mip.cuh) at W = 256, C = 128: the traced
// instance.
#include "plcore_mip.cuh"

PLCORE_MIP_INSTANCE(256, 128, true)
