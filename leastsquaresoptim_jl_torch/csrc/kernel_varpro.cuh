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
// launch (33.5 MB at B = 131072, m = 64, f32: 0.0125 ms at 3.35 TB/s),
// then K x ~10 m-length elementwise passes (two exps per sample per
// iteration), their reductions and a scalar step per fit. There is no
// matrix product, so no tensor-core work: the kernel is bound by issue
// slots, and the design spends them on per-sample work.
//
// Design: G lanes per fit, 32 / G fits per warp (G a power of two, a launch
// argument; ops/kernel_varpro.py::lanes_per_fit chooses it from m). Lane l
// of a fit holds the contiguous run of L = ceil(m / G) samples starting at
// l L, as its basis input u (x, or log x for the power basis) and its
// observations y, in registers for the whole launch; where L and m are
// multiples of 16 bytes' worth of elements the run is read with 16-byte
// vector loads. Every reduction is a __shfl_xor_sync butterfly of width G
// (log2 G levels), so the sums never touch shared or global memory and
// every lane of a fit ends with the same bits. The scalar step of each fit
// (the divisions and square roots above) runs once per group of G lanes,
// so the 32 / G fits of a warp share its instructions. The projection
// takes one reciprocal per fit (inv_R = 1 / R, q = P inv_R). The fit's
// 8-word state lives in registers for all K iterations and is written back
// once. The residual, its sum of squares and the Jacobian's sums share one
// pass, so that a lane keeps four runs live (u, y, P, dP, then u, y, r and
// the trial's P). float32 instances with runs of up to 16 samples are held
// to 128 registers, two 256-thread blocks an SM.
//
// Control flow is uniform over the warp, since every shuffle names the
// whole warp: a lane whose fit lies past B (the ragged end) or is done
// stays in the loop as a frozen fit. It loads no observations, changes no
// state and stores nothing. The loop runs while any fit of the warp is
// live. Samples past m contribute exact zeros; where every run is whole
// (L = S and G L = m, as at m = 64) no sample is masked.
//
// Summation order: each lane adds its L terms in turn, then the butterfly
// (offsets G/2, ..., 2, 1) adds across the fit's lanes. The plain PyTorch
// version (ops/kernel_varpro.py::_iteration_reference) reduces in exactly
// this order with the same G, and the library is built without FMA
// contraction (-fmad=false), so the two can be compared to the last bit
// where the exp and log of the two agree.
//
// Instances: one per (type, basis, G, S), S the power of two >= L that
// sizes the register runs, for the 16 (G, S) pairs of launch_instance:
// those ops/kernel_varpro.py::lanes_per_fit reaches at any m <= 1024, and
// the other layouts of the lanes sweep at m = 64 (ops/kernel_varpro.py's
// _INSTANCES lists the same pairs and refuses the others). The basis is a
// compile-time functor: exp_saturation, power and michaelis_menten, the
// n = 1 entries of the JAX package's SEPARABLE table. The instances of
// each basis are compiled in their own source file (kernel_varpro*.cu),
// so that the build runs them in parallel.
//
// float16 runs another kernel, in kernel_varpro_f16.cuh: the same
// iteration in packed half arithmetic, two fits to a __half2 (+ - * the
// native f16x2 instructions; /, sqrt, exp and log in float, rounded once
// to the correctly rounded half result), so it too matches the plain
// version bit for bit. It takes the state columns, the limits and the
// basis codes from this header.
//
// The state (B, 8) is updated IN PLACE: each group reads and writes only
// its own fit's row. The constants (tolerances, max_iters,
// MIN_STEP_QUALITY and the trust region radius bounds) come from the
// caller, so they cannot drift from config.py. m <= 1024.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace lso_varpro {

enum { kAlpha = 0, kDelta, kDec, kC, kIters, kDone, kConv, kFlags, kNS };
enum { kMaxM = 1024 };                  // samples per fit
enum { kMaxThreads = 256 };             // per block

template <typename T> struct Num;
template <> struct Num<float> {
  using Vec = float4;  // 16 bytes
  static constexpr int kVec = 4;
  __device__ static float eps() { return FLT_EPSILON; }
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float exp_(float v) { return expf(v); }
  __device__ static float log_(float v) { return logf(v); }
  __device__ static float sqrt_(float v) { return sqrtf(v); }
  __device__ static float abs_(float v) { return fabsf(v); }
  __device__ static bool finite(float v) { return isfinite(v); }
  __device__ static float shfl_xor(float v, int o, int w) {
    return __shfl_xor_sync(0xffffffffu, v, o, w);
  }
  __device__ static void unpack(float4 v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Num<double> {
  using Vec = double2;
  static constexpr int kVec = 2;
  __device__ static double eps() { return DBL_EPSILON; }
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double exp_(double v) { return exp(v); }
  __device__ static double log_(double v) { return log(v); }
  __device__ static double sqrt_(double v) { return sqrt(v); }
  __device__ static double abs_(double v) { return fabs(v); }
  __device__ static bool finite(double v) { return isfinite(v); }
  __device__ static double shfl_xor(double v, int o, int w) {
    return __shfl_xor_sync(0xffffffffu, v, o, w);
  }
  __device__ static void unpack(double2 v, double* o) { o[0] = v.x; o[1] = v.y; }
};
// NaN-propagating max/min (jnp.maximum / torch.clamp semantics).
template <typename T> __device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T> __device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// Sum over the G lanes of a fit; every lane ends with the same bits.
template <int G, typename T> __device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = v + Num<T>::shfl_xor(v, o, G);
  return v;
}

// Basis functors: u = prep(x) once per launch, then phi(x, a) and its
// alpha-derivative dphi(x, a) from u.
struct ExpSaturation {  // phi = 1 - exp(-a x), dphi = x exp(-a x)
  static constexpr int kCode = 0;
  template <typename T> __device__ static T prep(T x) { return x; }
  template <typename T>
  __device__ static void eval(T u, T a, T& phi, T& dphi) {
    const T e = Num<T>::exp_(-a * u);
    phi = T(1) - e;
    dphi = u * e;
  }
};
struct Power {  // phi = x^a = exp(a log x), dphi = x^a log x; u = log x
  static constexpr int kCode = 1;
  template <typename T> __device__ static T prep(T x) { return Num<T>::log_(x); }
  template <typename T>
  __device__ static void eval(T u, T a, T& phi, T& dphi) {
    phi = Num<T>::exp_(a * u);
    dphi = phi * u;
  }
};
struct MichaelisMenten {  // phi = x / (a + x), dphi = -x / (a + x)^2
  static constexpr int kCode = 2;
  template <typename T> __device__ static T prep(T x) { return x; }
  template <typename T>
  __device__ static void eval(T u, T a, T& phi, T& dphi) {
    const T inv = T(1) / (a + u);
    phi = u * inv;
    dphi = -(phi * inv);
  }
};

template <typename T> struct Consts {
  T x_tol, f_tol, g_tol, max_iters, min_step_quality, min_radius, max_radius;
};

template <typename T> struct Args {
  const T* xg;  // (m,) shared grid
  const T* Y;   // (B, m) observations
  T* state;     // (B, 8), updated in place
  int B, m, L, block_fits, k_iters;
  bool vec;     // 16-byte loads: L, m multiples of Num<T>::kVec, aligned rows
  Consts<T> cs;
};

// out[k] = src[k] where valid[k]; src is a lane's run.
template <typename T, int S>
__device__ __forceinline__ void load_run(const T* __restrict__ src,
                                         const bool (&valid)[S], bool vec,
                                         T (&out)[S]) {
  constexpr int V = Num<T>::kVec;
  if constexpr (S % V == 0) {
    if (vec) {  // a run's V-blocks are wholly inside or wholly past m
#pragma unroll
      for (int k = 0; k < S; k += V) {
        if (valid[k]) {
          Num<T>::unpack(*reinterpret_cast<const typename Num<T>::Vec*>(src + k),
                         &out[k]);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (valid[k]) out[k] = src[k];
  }
}

// phi and dphi at a over a lane's run. Masked: samples past the run or
// past m are exact zeros. Whole runs skip the selects and the unpacking of
// the packed valid bits that each select needs.
template <typename Basis, bool Masked, typename T, int S>
__device__ __forceinline__ void eval_run(const T (&u)[S], const bool (&valid)[S],
                                         T a, T (&P)[S], T (&dP)[S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    Basis::eval(u[k], a, P[k], dP[k]);
    if (Masked && !valid[k]) { P[k] = T(0); dP[k] = T(0); }
  }
}

// At most 256 threads a block. float32 runs of up to 16 samples are held
// to 128 registers, so that two blocks (16 warps) share an SM; longer runs
// and float64 would spill there. With 255 registers, the float64 runs of
// 32 and 64 samples and the float32 runs of 64 still spill (PERF.md).
template <typename T, int S>
constexpr int kMinBlocks = (sizeof(T) <= 4 && S <= 16) ? 2 : 1;

template <typename T, int G, int S, typename Basis>
__global__ void __launch_bounds__(kMaxThreads, (kMinBlocks<T, S>))
varpro_lm_p1_kernel(Args<T> a) {
  const int gl = threadIdx.x % G;  // lane within the fit's group
  const int fit = blockIdx.x * a.block_fits + threadIdx.x / G;
  const bool live = fit < a.B;
  T* st = a.state + static_cast<size_t>(live ? fit : 0) * kNS;
  T alpha = T(0), delta = T(1), dec = T(2), c = T(0), iters = T(0);
  T done = T(1), conv = T(0), flags = T(0);  // past B: frozen
  if (live) {
    alpha = st[kAlpha]; delta = st[kDelta]; dec = st[kDec]; c = st[kC];
    iters = st[kIters]; done = st[kDone]; conv = st[kConv]; flags = st[kFlags];
  }
  const bool active0 = !(done > T(0));

  const T eps = Num<T>::eps();
  const T tiny = Num<T>::tiny();
  const int first = gl * a.L;
  // Every lane's run is whole (uniform over the grid): no masks needed.
  const bool full = a.L == S && G * S == a.m;
  T u[S], y[S];
  bool valid[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    valid[k] = k < a.L && first + k < a.m;
    u[k] = T(0);
    y[k] = T(0);
  }
  load_run<T, S>(a.xg + first, valid, a.vec, u);
#pragma unroll
  for (int k = 0; k < S; ++k) u[k] = valid[k] ? Basis::prep(u[k]) : T(0);
  if (active0) {
    load_run<T, S>(a.Y + static_cast<size_t>(fit) * a.m + first, valid, a.vec, y);
  }

  for (int it = 0; it < a.k_iters && __any_sync(0xffffffffu, !(done > T(0))); ++it) {
    // Basis and projection at alpha.
    T P[S], dP[S], r[S];
    if (full) {
      eval_run<Basis, false>(u, valid, alpha, P, dP);
    } else {
      eval_run<Basis, true>(u, valid, alpha, P, dP);
    }
    T s_n2 = T(0), s_pdp = T(0);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      s_n2 = s_n2 + P[k] * P[k];
      s_pdp = s_pdp + P[k] * dP[k];
    }
    const T n2 = group_sum<G>(s_n2);
    const T floor2 = (eps * n2 + tiny) * eps;
    const T R = Num<T>::sqrt_(n2 + floor2);
    const T inv_R = T(1) / R;
    T s_z = T(0), s_dpy = T(0);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      s_z = s_z + (P[k] * inv_R) * y[k];
      s_dpy = s_dpy + dP[k] * y[k];
    }
    const T z = group_sum<G>(s_z);
    const T cc = z / R;

    // Exact VarPro Jacobian of the reduced residual, with the residual.
    const T dn2 = T(2) * group_sum<G>(s_pdp);
    const T dR = dn2 * (T(1) + eps * eps) / (T(2) * R);
    const T dz = group_sum<G>(s_dpy) / R - z * dR / R;
    const T dc = dz / R - z * dR / (R * R);
    T s_ssr = T(0), s_g = T(0), s_b = T(0);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      r[k] = y[k] - z * (P[k] * inv_R);
      s_ssr = s_ssr + r[k] * r[k];
      const T jr = -(dc * P[k] + cc * dP[k]);
      s_g = s_g + jr * jr;
      s_b = s_b + jr * r[k];
    }
    const T ssr = group_sum<G>(s_ssr);
    const T g = group_sum<G>(s_g);
    const T b = group_sum<G>(s_b);
    const T maxabs_gr = Num<T>::abs_(b);

    // Damped step and trial projection.
    const T damp = g / delta;
    const T dx = b / (g + damp);
    const T alpha_t = alpha - dx;
    T Pt[S], unused[S];
    if (full) {
      eval_run<Basis, false>(u, valid, alpha_t, Pt, unused);
    } else {
      eval_run<Basis, true>(u, valid, alpha_t, Pt, unused);
    }
    T s_n2t = T(0);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      s_n2t = s_n2t + Pt[k] * Pt[k];
    }
    const T n2t = group_sum<G>(s_n2t);
    const T Rt = Num<T>::sqrt_(n2t + (eps * n2t + tiny) * eps);
    const T inv_Rt = T(1) / Rt;
    T s_zt = T(0);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      Pt[k] = Pt[k] * inv_Rt;  // qt
      s_zt = s_zt + Pt[k] * y[k];
    }
    const T zt = group_sum<G>(s_zt);
    const T c_t = zt / Rt;
    T s_ared = T(0);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const T rt = y[k] - zt * Pt[k];
      s_ared = s_ared + (r[k] - rt) * (r[k] + rt);
    }
    const T ared = group_sum<G>(s_ared);
    const T pred = Num<T>::abs_(T(2) * dx * b - dx * dx * g);
    const T rho = pred > T(0) ? ared / pred : T(0);

    if (!(done > T(0))) {
      const bool accepted = rho > a.cs.min_step_quality;
      const bool step_finite = Num<T>::finite(dx);
      // Priority-gated: f beats x beats g, at most one flag set.
      const bool f_conv = accepted && (Num<T>::abs_(ared) <=
                                       a.cs.f_tol * (Num<T>::abs_(ssr) + a.cs.f_tol));
      const bool x_conv = !f_conv && (Num<T>::abs_(dx) <= a.cs.x_tol);
      const bool g_conv = !f_conv && !x_conv && (maxabs_gr <= a.cs.g_tol);
      const bool cv = f_conv || x_conv || g_conv;

      const T t = T(2) * rho - T(1);
      const T grow = nan_min(delta / nan_max(T(1.0 / 3.0), T(1) - t * t * t),
                             a.cs.max_radius);
      const T shrink = nan_max(delta / dec, a.cs.min_radius);

      const T new_alpha = (accepted || !step_finite) ? alpha_t : alpha;
      delta = accepted ? grow : shrink;
      dec = accepted ? T(2) : dec * T(2);
      c = accepted ? c_t : cc;
      const bool new_done =
          cv || !Num<T>::finite(new_alpha) || (iters + T(1) >= a.cs.max_iters);
      alpha = new_alpha;
      iters = iters + T(1);
      done = new_done ? T(1) : T(0);
      conv = cv ? T(1) : T(0);
      flags = T(f_conv) * T(2) + T(x_conv) * T(4) + T(g_conv) * T(8);
    }
  }

  if (live && active0 && gl == 0) {
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

template <typename T, typename Basis, int G, int S>
cudaError_t run(const Args<T>& a, dim3 grid, dim3 block, cudaStream_t s) {
  varpro_lm_p1_kernel<T, G, S, Basis><<<grid, block, 0, s>>>(a);
  return cudaGetLastError();
}

// The instance of G lanes and runs of S samples: the pairs that
// lanes_per_fit reaches (G = 1 with S <= 16; G = 2..16 with S = 16; G = 32
// with S = 16 and 32), then the m = 64 sweep's (1, 64), (2, 32), (8, 8),
// (16, 4) and (32, 2). Any other pair is refused.
template <typename T, typename Basis>
cudaError_t launch_instance(const Args<T>& a, int G, int S, dim3 grid,
                            dim3 block, cudaStream_t s) {
  if (G == 1 && S == 1) return run<T, Basis, 1, 1>(a, grid, block, s);
  if (G == 1 && S == 2) return run<T, Basis, 1, 2>(a, grid, block, s);
  if (G == 1 && S == 4) return run<T, Basis, 1, 4>(a, grid, block, s);
  if (G == 1 && S == 8) return run<T, Basis, 1, 8>(a, grid, block, s);
  if (G == 1 && S == 16) return run<T, Basis, 1, 16>(a, grid, block, s);
  if (G == 2 && S == 16) return run<T, Basis, 2, 16>(a, grid, block, s);
  if (G == 4 && S == 16) return run<T, Basis, 4, 16>(a, grid, block, s);
  if (G == 8 && S == 16) return run<T, Basis, 8, 16>(a, grid, block, s);
  if (G == 16 && S == 16) return run<T, Basis, 16, 16>(a, grid, block, s);
  if (G == 32 && S == 16) return run<T, Basis, 32, 16>(a, grid, block, s);
  if (G == 32 && S == 32) return run<T, Basis, 32, 32>(a, grid, block, s);
  if (G == 1 && S == 64) return run<T, Basis, 1, 64>(a, grid, block, s);
  if (G == 2 && S == 32) return run<T, Basis, 2, 32>(a, grid, block, s);
  if (G == 8 && S == 8) return run<T, Basis, 8, 8>(a, grid, block, s);
  if (G == 16 && S == 4) return run<T, Basis, 16, 4>(a, grid, block, s);
  if (G == 32 && S == 2) return run<T, Basis, 32, 2>(a, grid, block, s);
  return cudaErrorInvalidValue;
}

// Checks the launch and runs it: G = lanes lanes per fit, block_fits fits
// (block_fits * lanes threads, whole warps, at most 256) per block.
template <typename T, typename Basis>
int launch_basis(const T* x, const T* Y, T* state, int B, int m, int k_iters,
                 Consts<T> cs, int lanes, int block_fits, cudaStream_t stream) {
  if (B <= 0 || m < 1 || m > kMaxM || k_iters < 1 || lanes < 1 || block_fits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int L = (m + lanes - 1) / lanes;
  const long long threads = static_cast<long long>(block_fits) * lanes;
  if (threads % 32 != 0 || threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int S = 1;
  while (S < L) S *= 2;
  constexpr int V = Num<T>::kVec;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  const Args<T> a{x, Y, state, B, m, L, block_fits, k_iters,
                  aligned && L % V == 0 && m % V == 0, cs};
  const dim3 block(static_cast<unsigned>(threads));
  const dim3 grid((B + block_fits - 1) / block_fits);
  return static_cast<int>(launch_instance<T, Basis>(a, lanes, S, grid, block, stream));
}

// The launch of basis code ``basis`` (BASES in ops/kernel_varpro.py).
template <typename T>
int launch(const void* x, const void* Y, void* state, int B, int m,
           int k_iters, Consts<T> cs, int basis, int lanes, int block_fits,
           void* stream);

// Each basis is instantiated in its own source file.
#define LSO_VARPRO_INSTANCES(EXTERN, BASIS)                                         \
  EXTERN template int launch_basis<float, BASIS>(const float*, const float*,      \
                                                 float*, int, int, int,           \
                                                 Consts<float>, int, int,         \
                                                 cudaStream_t);                   \
  EXTERN template int launch_basis<double, BASIS>(const double*, const double*,   \
                                                  double*, int, int, int,         \
                                                  Consts<double>, int, int,       \
                                                  cudaStream_t);

LSO_VARPRO_INSTANCES(extern, ExpSaturation)
LSO_VARPRO_INSTANCES(extern, Power)
LSO_VARPRO_INSTANCES(extern, MichaelisMenten)

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

}  // namespace lso_varpro
