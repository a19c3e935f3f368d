// The fused VarPro LM kernel's float16 instances, every basis, and their C
// entry point (kernel_varpro.cuh: the Half type and its arithmetic).

#include "kernel_varpro.cuh"

namespace lso_varpro {
LSO_VARPRO_INSTANCES_F16(, ExpSaturation)
LSO_VARPRO_INSTANCES_F16(, Power)
LSO_VARPRO_INSTANCES_F16(, MichaelisMenten)
}  // namespace lso_varpro

// Bound with ctypes; the constants come as float and are rounded to half
// here (ops/kernel_varpro.py passes values that are already half values).
// Returns cudaGetLastError() right after the launch: 0 means enqueued.
extern "C" int lso_kernel_varpro_f16(const void* x, const void* Y, void* state,
                                     int B, int m, int k_iters, float x_tol,
                                     float f_tol, float g_tol, float max_iters,
                                     float min_step_quality, float min_radius,
                                     float max_radius, int basis, int lanes,
                                     int block_fits, void* stream) {
  using lso_varpro::Half;
  lso_varpro::Consts<Half> cs{Half(x_tol), Half(f_tol), Half(g_tol),
                              Half(max_iters), Half(min_step_quality),
                              Half(min_radius), Half(max_radius)};
  return lso_varpro::launch<Half>(x, Y, state, B, m, k_iters, cs, basis, lanes,
                                  block_fits, stream);
}
