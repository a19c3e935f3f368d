// The fused VarPro LM kernel's instances for the power basis, phi = x^a
// (kernel_varpro.cuh).

#include "kernel_varpro.cuh"

namespace lso_varpro {
LSO_VARPRO_INSTANCES(, Power)
}  // namespace lso_varpro
