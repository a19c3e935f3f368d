// The fused VarPro LM kernel's float32 and float64 C entry points and its
// exp_saturation instances. The kernel, its design and its contract are in
// kernel_varpro.cuh; kernel_varpro_power.cu and
// kernel_varpro_michaelis_menten.cu hold the other bases' instances;
// the float16 kernel is kernel_varpro_f16.cuh (kernel_varpro_f16*.cu).

#include "kernel_varpro.cuh"

namespace lso_varpro {

LSO_VARPRO_INSTANCES(, ExpSaturation)
}  // namespace lso_varpro

// Plain C entry points (bound with ctypes). Each returns cudaGetLastError()
// right after the launch: 0 means the kernel was enqueued.
extern "C" int lso_kernel_varpro_f32(const void* x, const void* Y, void* state,
                                     int B, int m, int k_iters, float x_tol,
                                     float f_tol, float g_tol, float max_iters,
                                     float min_step_quality, float min_radius,
                                     float max_radius, int basis, int lanes,
                                     int block_fits, void* stream) {
  lso_varpro::Consts<float> cs{x_tol, f_tol, g_tol, max_iters, min_step_quality,
                               min_radius, max_radius};
  return lso_varpro::launch<float>(x, Y, state, B, m, k_iters, cs, basis, lanes,
                                   block_fits, stream);
}

extern "C" int lso_kernel_varpro_f64(const void* x, const void* Y, void* state,
                                     int B, int m, int k_iters, double x_tol,
                                     double f_tol, double g_tol,
                                     double max_iters, double min_step_quality,
                                     double min_radius, double max_radius,
                                     int basis, int lanes, int block_fits,
                                     void* stream) {
  lso_varpro::Consts<double> cs{x_tol, f_tol, g_tol, max_iters,
                                min_step_quality, min_radius, max_radius};
  return lso_varpro::launch<double>(x, Y, state, B, m, k_iters, cs, basis,
                                    lanes, block_fits, stream);
}
