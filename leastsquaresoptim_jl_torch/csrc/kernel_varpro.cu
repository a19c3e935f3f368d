// The fused VarPro LM kernel's C entry points and its exp_saturation
// instances. The kernel, its design and its contract are in
// kernel_varpro.cuh; kernel_varpro_power.cu and
// kernel_varpro_michaelis_menten.cu hold the other bases' instances.

#include "kernel_varpro.cuh"

namespace lso_varpro {

LSO_VARPRO_INSTANCES(, ExpSaturation)

namespace {

template <typename T>
int launch(const void* x, const void* Y, void* state, int B, int m,
           int k_iters, Consts<T> cs, int basis, int lanes, int block_fits,
           void* stream) {
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(Y);
  T* sp = static_cast<T*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case ExpSaturation::kCode:
      return launch_basis<T, ExpSaturation>(xp, yp, sp, B, m, k_iters, cs,
                                            lanes, block_fits, s);
    case Power::kCode:
      return launch_basis<T, Power>(xp, yp, sp, B, m, k_iters, cs, lanes,
                                    block_fits, s);
    case MichaelisMenten::kCode:
      return launch_basis<T, MichaelisMenten>(xp, yp, sp, B, m, k_iters, cs,
                                              lanes, block_fits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
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
