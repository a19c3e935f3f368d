// The float16 fused VarPro LM kernel's instances for the exp_saturation
// basis (kernel_varpro_f16.cuh) and the C entry point of every basis.

#include "kernel_varpro_f16.cuh"

namespace lso_varpro {
namespace f16 {
LSO_VARPRO_F16_INSTANCE(, ExpSaturation)
}  // namespace f16
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
  using namespace lso_varpro;
  auto h = [](float v) { const __half r = __float2half_rn(v); return __half2(r, r); };
  const f16::Consts2 cs{h(x_tol), h(f_tol), h(g_tol), h(max_iters),
                        h(min_step_quality), h(min_radius), h(max_radius)};
  const __half* xp = static_cast<const __half*>(x);
  const __half* yp = static_cast<const __half*>(Y);
  __half* sp = static_cast<__half*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case ExpSaturation::kCode:
      return f16::launch_basis<ExpSaturation>(xp, yp, sp, B, m, k_iters, cs, lanes,
                                              block_fits, s);
    case Power::kCode:
      return f16::launch_basis<Power>(xp, yp, sp, B, m, k_iters, cs, lanes, block_fits, s);
    case MichaelisMenten::kCode:
      return f16::launch_basis<MichaelisMenten>(xp, yp, sp, B, m, k_iters, cs, lanes,
                                                block_fits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
