// Fused batched Levenberg-Marquardt for p = 1 separable (VarPro) curve fits.
//
// Replaces leastsquaresoptim_jl_tpu/ops/kernel_varpro.py::_make_kernel (the
// Pallas kernel body over _iteration). It computes what _iteration computes,
// K whole LM iterations per launch for B independent fits, not the TPU
// block structure:
//   basis phi and dphi at alpha; the floored projection n2, R, q, z, c, r;
//   the exact hand derivative of the reduced residual (dn2, dR, dz, dc, Jr);
//   the 1x1 Gram g = Jr'Jr and rhs b = Jr'r; the damped step
//   dx = b / (g + g/delta); the trial projection at alpha - dx; ared
//   (cancellation-free), pred and rho; accept at rho > MIN_STEP_QUALITY;
//   Ceres radius growth or the doubling shrink; the f > x > g priority
//   flags; and the per-fit freeze (a done fit is left untouched).
//
// What bounds it on Hopper: one read of the fit's m observations per
// launch, then K x ~10 m-length elementwise passes (two exps per sample per
// iteration) and their reductions per fit. There is no matrix product, so
// no tensor-core work; at m = 64 the arithmetic and the reductions, not the
// 32 MB read of Y, are the cost.
//
// Design: one warp per fit. Lane l holds samples l, l + 32, ... (K = m/32
// rounded up to a power of two) of x and y in registers, loaded once per
// launch with neighbouring lanes on neighbouring addresses; every reduction
// is a __shfl_xor_sync butterfly, so the sums never touch shared or global
// memory and every lane ends with the same bits. The fit's 8-word state
// lives in registers for all K iterations and is written back once. A fit
// that is done does not read Y at all. The ragged last block is masked by
// the fit index; samples past m contribute exact zeros.
//
// Summation order: each lane adds its K terms in order, then the butterfly
// (offsets 16, 8, 4, 2, 1) adds across lanes. The plain PyTorch version
// (ops/kernel_varpro.py::_iteration_reference) reduces in exactly this
// order, and the library is built without FMA contraction (-fmad=false),
// so the two can be compared to the last bit where expf/exp agree.
//
// The state (B, 8) is updated IN PLACE: each warp reads and writes only its
// own fit's row.
//
// The constants (tolerances, max_iters, MIN_STEP_QUALITY and the trust
// region radius bounds) come from the caller, so they cannot drift from
// config.py. m <= 1024.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

enum { kAlpha = 0, kDelta, kDec, kC, kIters, kDone, kConv, kFlags, kNS };

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float eps() { return FLT_EPSILON; }
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float exp_(float v) { return expf(v); }
  __device__ static float sqrt_(float v) { return sqrtf(v); }
  __device__ static float abs_(float v) { return fabsf(v); }
};
template <> struct Num<double> {
  __device__ static double eps() { return DBL_EPSILON; }
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double exp_(double v) { return exp(v); }
  __device__ static double sqrt_(double v) { return sqrt(v); }
  __device__ static double abs_(double v) { return fabs(v); }
};

// NaN-propagating max/min (jnp.maximum / torch.clamp semantics).
template <typename T> __device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T> __device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

template <typename T> __device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Basis functors: phi(x, a) and its alpha-derivative dphi(x, a).
struct ExpSaturation {  // phi = 1 - exp(-a x), dphi = x exp(-a x)
  template <typename T>
  __device__ static void eval(T x, T a, T& phi, T& dphi) {
    T e = Num<T>::exp_(-a * x);
    phi = T(1) - e;
    dphi = x * e;
  }
};

template <typename T> struct Consts {
  T x_tol, f_tol, g_tol, max_iters, min_step_quality, min_radius, max_radius;
};

template <typename T, int K, typename Basis>
__global__ void varpro_lm_p1_kernel(const T* __restrict__ xg,
                                    const T* __restrict__ Y,
                                    T* __restrict__ state, int B, int m,
                                    int k_iters, Consts<T> cs) {
  const int lane = threadIdx.x & 31;
  const int fit = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (fit >= B) return;  // the whole warp leaves together
  T* st = state + static_cast<size_t>(fit) * kNS;
  T done = st[kDone];
  if (done > T(0)) return;  // frozen: nothing below would change it
  T alpha = st[kAlpha], delta = st[kDelta], dec = st[kDec], c = st[kC];
  T iters = st[kIters], conv = st[kConv], flags = st[kFlags];

  const T eps = Num<T>::eps();
  const T tiny = Num<T>::tiny();
  const T* yrow = Y + static_cast<size_t>(fit) * m;
  T x[K], y[K];
  bool valid[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    valid[k] = i < m;
    x[k] = valid[k] ? xg[i] : T(0);
    y[k] = valid[k] ? yrow[i] : T(0);
  }

  for (int it = 0; it < k_iters && !(done > T(0)); ++it) {
    // Basis, projection and residual at alpha.
    T P[K], dP[K], r[K];
    T s_n2 = T(0), s_pdp = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      Basis::eval(x[k], alpha, P[k], dP[k]);
      if (!valid[k]) { P[k] = T(0); dP[k] = T(0); }
      s_n2 = s_n2 + P[k] * P[k];
      s_pdp = s_pdp + P[k] * dP[k];
    }
    const T n2 = warp_sum(s_n2);
    const T floor2 = (eps * n2 + tiny) * eps;
    const T R = Num<T>::sqrt_(n2 + floor2);
    T s_z = T(0), s_dpy = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s_z = s_z + (P[k] / R) * y[k];
      s_dpy = s_dpy + dP[k] * y[k];
    }
    const T z = warp_sum(s_z);
    const T cc = z / R;
    T s_ssr = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r[k] = y[k] - z * (P[k] / R);
      s_ssr = s_ssr + r[k] * r[k];
    }
    const T ssr = warp_sum(s_ssr);

    // Exact VarPro Jacobian of the reduced residual.
    const T dn2 = T(2) * warp_sum(s_pdp);
    const T dR = dn2 * (T(1) + eps * eps) / (T(2) * R);
    const T dz = warp_sum(s_dpy) / R - z * dR / R;
    const T dc = dz / R - z * dR / (R * R);
    T s_g = T(0), s_b = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T jr = -(dc * P[k] + cc * dP[k]);
      s_g = s_g + jr * jr;
      s_b = s_b + jr * r[k];
    }
    const T g = warp_sum(s_g);
    const T b = warp_sum(s_b);
    const T maxabs_gr = Num<T>::abs_(b);

    // Damped step and trial projection.
    const T damp = g / delta;
    const T dx = b / (g + damp);
    const T alpha_t = alpha - dx;
    T Pt[K];
    T s_n2t = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T unused;
      Basis::eval(x[k], alpha_t, Pt[k], unused);
      if (!valid[k]) Pt[k] = T(0);
      s_n2t = s_n2t + Pt[k] * Pt[k];
    }
    const T n2t = warp_sum(s_n2t);
    const T Rt = Num<T>::sqrt_(n2t + (eps * n2t + tiny) * eps);
    T s_zt = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) s_zt = s_zt + (Pt[k] / Rt) * y[k];
    const T zt = warp_sum(s_zt);
    const T c_t = zt / Rt;
    T s_ared = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T rt = y[k] - zt * (Pt[k] / Rt);
      s_ared = s_ared + (r[k] - rt) * (r[k] + rt);
    }
    const T ared = warp_sum(s_ared);
    const T pred = Num<T>::abs_(T(2) * dx * b - dx * dx * g);
    const T rho = pred > T(0) ? ared / pred : T(0);

    const bool accepted = rho > cs.min_step_quality;
    const bool step_finite = isfinite(dx);
    // Priority-gated: f beats x beats g, at most one flag set.
    const bool f_conv =
        accepted && (Num<T>::abs_(ared) <= cs.f_tol * (Num<T>::abs_(ssr) + cs.f_tol));
    const bool x_conv = !f_conv && (Num<T>::abs_(dx) <= cs.x_tol);
    const bool g_conv = !f_conv && !x_conv && (maxabs_gr <= cs.g_tol);
    const bool cv = f_conv || x_conv || g_conv;

    const T t = T(2) * rho - T(1);
    const T grow = nan_min(delta / nan_max(T(1.0 / 3.0), T(1) - t * t * t),
                           cs.max_radius);
    const T shrink = nan_max(delta / dec, cs.min_radius);

    const T new_alpha = (accepted || !step_finite) ? alpha_t : alpha;
    delta = accepted ? grow : shrink;
    dec = accepted ? T(2) : dec * T(2);
    c = accepted ? c_t : cc;
    const bool new_done =
        cv || !isfinite(new_alpha) || (iters + T(1) >= cs.max_iters);
    alpha = new_alpha;
    iters = iters + T(1);
    done = new_done ? T(1) : T(0);
    conv = cv ? T(1) : T(0);
    flags = T(f_conv) * T(2) + T(x_conv) * T(4) + T(g_conv) * T(8);
  }

  if (lane == 0) {
    st[kAlpha] = alpha;
    st[kDelta] = delta;
    st[kDec] = dec;
    st[kC] = c;
    st[kIters] = iters;
    st[kDone] = done;
    st[kConv] = conv;
    st[kFlags] = flags;
  }
}

template <typename T, typename Basis>
cudaError_t launch_basis(const T* x, const T* Y, T* state, int B, int m,
                         int k_iters, Consts<T> cs, int warps_per_block,
                         cudaStream_t stream) {
  const dim3 block(32 * warps_per_block);
  const dim3 grid((B + warps_per_block - 1) / warps_per_block);
  const int lanes = (m + 31) / 32;
  if (lanes <= 1) {
    varpro_lm_p1_kernel<T, 1, Basis><<<grid, block, 0, stream>>>(x, Y, state, B, m, k_iters, cs);
  } else if (lanes <= 2) {
    varpro_lm_p1_kernel<T, 2, Basis><<<grid, block, 0, stream>>>(x, Y, state, B, m, k_iters, cs);
  } else if (lanes <= 4) {
    varpro_lm_p1_kernel<T, 4, Basis><<<grid, block, 0, stream>>>(x, Y, state, B, m, k_iters, cs);
  } else if (lanes <= 8) {
    varpro_lm_p1_kernel<T, 8, Basis><<<grid, block, 0, stream>>>(x, Y, state, B, m, k_iters, cs);
  } else if (lanes <= 16) {
    varpro_lm_p1_kernel<T, 16, Basis><<<grid, block, 0, stream>>>(x, Y, state, B, m, k_iters, cs);
  } else {
    varpro_lm_p1_kernel<T, 32, Basis><<<grid, block, 0, stream>>>(x, Y, state, B, m, k_iters, cs);
  }
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* Y, void* state, int B, int m,
           int k_iters, Consts<T> cs, int basis, int warps_per_block,
           void* stream) {
  if (B <= 0 || m < 1 || m > 1024 || k_iters < 1 || warps_per_block < 1 ||
      warps_per_block > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(Y);
  T* sp = static_cast<T*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case 0:
      return static_cast<int>(launch_basis<T, ExpSaturation>(
          xp, yp, sp, B, m, k_iters, cs, warps_per_block, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns cudaGetLastError()
// right after the launch: 0 means the kernel was enqueued.
extern "C" int lso_kernel_varpro_f32(const void* x, const void* Y, void* state,
                                     int B, int m, int k_iters, float x_tol,
                                     float f_tol, float g_tol, float max_iters,
                                     float min_step_quality, float min_radius,
                                     float max_radius, int basis,
                                     int warps_per_block, void* stream) {
  Consts<float> cs{x_tol, f_tol, g_tol, max_iters, min_step_quality,
                   min_radius, max_radius};
  return launch<float>(x, Y, state, B, m, k_iters, cs, basis, warps_per_block,
                       stream);
}

extern "C" int lso_kernel_varpro_f64(const void* x, const void* Y, void* state,
                                     int B, int m, int k_iters, double x_tol,
                                     double f_tol, double g_tol,
                                     double max_iters, double min_step_quality,
                                     double min_radius, double max_radius,
                                     int basis, int warps_per_block,
                                     void* stream) {
  Consts<double> cs{x_tol, f_tol, g_tol, max_iters, min_step_quality,
                    min_radius, max_radius};
  return launch<double>(x, Y, state, B, m, k_iters, cs, basis,
                        warps_per_block, stream);
}
