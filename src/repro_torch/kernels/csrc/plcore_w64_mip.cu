// K2's Mip-NeRF instance (plcore_mip.cuh) at W = 64, C = 32, the widths of
// MipNerfConfig's tiny(): untraced and traced.
#include "plcore_mip.cuh"

PLCORE_MIP_INSTANCE(64, 32, false)
PLCORE_MIP_INSTANCE(64, 32, true)
PLCORE_MIP_RESIDENT(64, 32)
