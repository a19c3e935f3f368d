// The float16 fused VarPro LM kernel's instances for the michaelis_menten basis, phi = x / (a + x)
// (kernel_varpro_f16.cuh).

#include "kernel_varpro_f16.cuh"

namespace lso_varpro {
namespace f16 {
LSO_VARPRO_F16_INSTANCE(, MichaelisMenten)
}  // namespace f16
}  // namespace lso_varpro
