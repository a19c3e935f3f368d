// The fused VarPro LM kernel's instances for the michaelis_menten basis,
// phi = x / (a + x) (kernel_varpro.cuh).

#include "kernel_varpro.cuh"

namespace lso_varpro {
LSO_VARPRO_INSTANCES(, MichaelisMenten)
}  // namespace lso_varpro
