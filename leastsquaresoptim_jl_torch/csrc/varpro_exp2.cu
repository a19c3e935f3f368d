// One VarPro evaluation of the gridded two-term exponential sum for B
// independent fits: varpro_exp2_eval.
//
// Replaces no TPU kernel: the JAX package leaves this evaluation to XLA's
// fusion of the vmapped reduced residual (models/separable.py at p = 2),
// its forward-mode Jacobian and the Gram products, which eager PyTorch
// runs as some 520 kernels a lockstep iteration. Its bound on the card is
// Y read once (4 B m bytes); the arithmetic, some 300 float32 operations
// a sample with the two tangents, costs about as much at the card's peak.
// So each fit's samples are read once, 16 bytes a lane, into registers;
// every per-sample value of the QR arm that a later pass reads stays there
// (8 samples a lane at m = 256: the arm's 10 arrays, no spill), the other
// arms load the samples again; reductions over m are xor butterflies
// within the fit's warp; Gram mode writes eight floats a fit and nothing
// of size m.
//
// Layout: a warp a fit, lane l holding samples 4 (l + 32 k) + j, k < NV,
// j < 4. A lane sums its samples in that order, starting from the first,
// then the warp folds by __shfl_xor_sync at offsets 16 .. 1 (a halving
// tree: every lane ends with the same bits, so every lane takes the same
// branch). Samples past
// m are zero inputs and go through every formula. The plain version,
// ops/varpro_exp2.py, repeats this arithmetic and order; built with
// -fmad=false the two agree bit for bit on the card.
//
// Per fit, the arm of models/separable._coefficients_and_residual at
// p = 2, only that one computed: dead basis (r = y, J = 0); MGS QR with
// reorthogonalisation and the floored R diagonal where it survives and is
// finite; the ridged normal equations by the unrolled Cholesky otherwise.
// The residual's two tangents come from dual numbers through the arm's
// own formulas: the exact VarPro Jacobian.

#include <cuda_runtime.h>
#include <math.h>

namespace lso_exp2 {

constexpr float kEps = 0x1p-23f;                 // float32 eps
constexpr float kTiny = 0x1p-126f;               // float32 tiny
constexpr float kDead = 0x1p-80f;                // tiny / eps^2
constexpr float kSurvive = 25.0f * 0x1p-42f;     // (10 p eps)^2, p = 2
constexpr int kThreads = 256;
constexpr int kLanes = 32;  // a warp a fit

// Butterfly reductions over a fit's warp: every lane ends with the same
// bits.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ int warp_any(int f) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) f = f | __shfl_xor_sync(0xffffffffu, f, o);
  return f;
}

// Dekker two-product and the sloppy two-float add of ops/linalg.py.
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  const float split = 4097.0f;  // 2^12 + 1
  float ca = split * a;
  float a_hi = ca - (ca - a);
  float a_lo = a - a_hi;
  float cb = split * b;
  float b_hi = cb - (cb - b);
  float b_lo = b - b_hi;
  p = a * b;
  e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo;
}

__device__ __forceinline__ void dd_add(float& hi, float& lo, float bh, float bl) {
  float s = hi + bh;
  float bb = s - hi;
  float e = (hi - (s - bb)) + (bh - bb);
  e = e + (lo + bl);
  hi = s + e;
  lo = e - (hi - s);
}

// A fit's samples in a lane's registers: y, the grid x and the basis,
// zero past m. Loaded again by the normal-equations and dead arms, so
// that the QR arm's passes need not keep them live.
template <int NV>
__device__ __forceinline__ void load(const float* __restrict__ yrow, int lane,
                                     int m, double t0, double dt, float a0,
                                     float a1, int vec, float* y, float* x,
                                     float* e0, float* e1) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int base = 4 * (lane + kLanes * k);
    if (vec) {
      float4 v = base < m ? *reinterpret_cast<const float4*>(yrow + base)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      y[4 * k] = v.x;
      y[4 * k + 1] = v.y;
      y[4 * k + 2] = v.z;
      y[4 * k + 3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) y[4 * k + j] = base + j < m ? yrow[base + j] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * k + j;
      if (base + j < m) {
        x[t] = (float)(t0 + (double)(base + j) * dt);
        e0[t] = expf(-a0 * x[t]);
        e1[t] = expf(-a1 * x[t]);
      } else {
        x[t] = 0.0f;
        e0[t] = 0.0f;
        e1[t] = 0.0f;
      }
    }
  }
}

// Lane sums of N per-sample terms, first sample first: p[u] over t of
// term(t, u).
#define LSO_EXP2_ACC(N, p, t, ...)                         \
  {                                                        \
    const float v_[N] = {__VA_ARGS__};                     \
    _Pragma("unroll") for (int u_ = 0; u_ < N; ++u_)       \
      p[u_] = t == 0 ? v_[u_] : p[u_] + v_[u_];            \
  }

// MODE 0: Gram mode into out (B, 8) = J'J (2x2), J'r, ssr (hi, lo).
// MODE 1: r (B, m) and J (B, m, 2). MODE 2: r alone.
template <int NV, int MODE>
__global__ void __launch_bounds__(kThreads)
varpro_exp2_eval(const float* __restrict__ Y, const float* __restrict__ alpha,
                 int B, int m, double t0, double dt, float* __restrict__ out,
                 float* __restrict__ R, float* __restrict__ J, int vec) {
  constexpr int S = 4 * NV;
  const int lane = threadIdx.x % kLanes;
  const long fit = (long)blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  if (fit >= B) return;  // whole warps only
  const float a0 = alpha[2 * fit];
  const float a1 = alpha[2 * fit + 1];
  const float* yrow = Y + fit * (long)m;

  float y[S], x[S], e0[S], e1[S];
  load<NV>(yrow, lane, m, t0, dt, a0, a1, vec, y, x, e0, e1);

  // Pass 1: the column norms and their tangents.
  float G00, G11, S00, S11;
  {
    float p[4];
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const float D0 = -(x[t] * e0[t]);
      const float D1 = -(x[t] * e1[t]);
      LSO_EXP2_ACC(4, p, t, e0[t] * e0[t], e1[t] * e1[t], e0[t] * D0, e1[t] * D1)
    }
    G00 = warp_sum(p[0]);
    G11 = warp_sum(p[1]);
    S00 = warp_sum(p[2]);
    S11 = warp_sum(p[3]);
  }
  const float scale2 = (G00 + G11) / 2.0f;
  int kind = scale2 > kDead ? 1 : 0;  // 0 dead, 1 QR, 2 normal equations

  // The chosen arm's residual and its two tangents, sample by sample.
  float r[S], ra[S], rb[S];
  if (kind == 1) {  // MGS QR, then its survival and finiteness test
    const float floor2 = (kEps * scale2 + kTiny) * kEps;
    const float df2a = (kEps * S00) * kEps;
    const float df2b = (kEps * S11) * kEps;
    const float R00 = sqrtf(G00 + floor2);
    const float dR00a = (2.0f * S00 + df2a) / (2.0f * R00);
    const float dR00b = df2b / (2.0f * R00);
    // q0 and its tangents; then v, w, q1 in w*; then bb, r in r*.
    float q0[S], q0a[S], q0b[S], w[S], wa[S], wb[S];
    float R01a, dR01aA, dR01aB, z0, dz0A, dz0B;
    {  // pass 2
      float p[6];
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const float D0 = -(x[t] * e0[t]);
        q0[t] = e0[t] / R00;
        q0a[t] = (D0 - q0[t] * dR00a) / R00;
        q0b[t] = -(q0[t] * dR00b) / R00;
        const float D1 = -(x[t] * e1[t]);
        LSO_EXP2_ACC(6, p, t, q0[t] * e1[t], q0a[t] * e1[t],
                     q0b[t] * e1[t] + q0[t] * D1, q0[t] * y[t], q0a[t] * y[t],
                     q0b[t] * y[t])
      }
      R01a = warp_sum(p[0]);
      dR01aA = warp_sum(p[1]);
      dR01aB = warp_sum(p[2]);
      z0 = warp_sum(p[3]);
      dz0A = warp_sum(p[4]);
      dz0B = warp_sum(p[5]);
    }
    float cc, dccA, dccB;
    {  // pass 3: v, and its reorthogonalisation
      float p[3];
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const float D1 = -(x[t] * e1[t]);
        w[t] = e1[t] - R01a * q0[t];
        wa[t] = -(dR01aA * q0[t] + R01a * q0a[t]);
        wb[t] = D1 - (dR01aB * q0[t] + R01a * q0b[t]);
        LSO_EXP2_ACC(3, p, t, q0[t] * w[t], q0a[t] * w[t] + q0[t] * wa[t],
                     q0b[t] * w[t] + q0[t] * wb[t])
      }
      cc = warp_sum(p[0]);
      dccA = warp_sum(p[1]);
      dccB = warp_sum(p[2]);
    }
    float s21, R11, dR11a, dR11b;
    {  // pass 4: w
      float p[3];
#pragma unroll
      for (int t = 0; t < S; ++t) {
        w[t] = w[t] - cc * q0[t];
        wa[t] = wa[t] - (dccA * q0[t] + cc * q0a[t]);
        wb[t] = wb[t] - (dccB * q0[t] + cc * q0b[t]);
        LSO_EXP2_ACC(3, p, t, w[t] * w[t], w[t] * wa[t], w[t] * wb[t])
      }
      s21 = warp_sum(p[0]);
      const float tA = warp_sum(p[1]);
      const float tB = warp_sum(p[2]);
      R11 = sqrtf(s21 + floor2);
      dR11a = (2.0f * tA + df2a) / (2.0f * R11);
      dR11b = (2.0f * tB + df2b) / (2.0f * R11);
    }
    float z1, dz1A, dz1B;
    {  // pass 5: q1 and the deflated right side
      float p[3];
#pragma unroll
      for (int t = 0; t < S; ++t) {
        w[t] = w[t] / R11;
        wa[t] = (wa[t] - w[t] * dR11a) / R11;
        wb[t] = (wb[t] - w[t] * dR11b) / R11;
        r[t] = y[t] - z0 * q0[t];
        ra[t] = -(dz0A * q0[t] + z0 * q0a[t]);
        rb[t] = -(dz0B * q0[t] + z0 * q0b[t]);
        LSO_EXP2_ACC(3, p, t, w[t] * r[t], wa[t] * r[t] + w[t] * ra[t],
                     wb[t] * r[t] + w[t] * rb[t])
      }
      z1 = warp_sum(p[0]);
      dz1A = warp_sum(p[1]);
      dz1B = warp_sum(p[2]);
    }
    int bad = 0;
#pragma unroll
    for (int t = 0; t < S; ++t) {  // the residual
      r[t] = r[t] - z1 * w[t];
      ra[t] = ra[t] - (dz1A * w[t] + z1 * wa[t]);
      rb[t] = rb[t] - (dz1B * w[t] + z1 * wb[t]);
      bad |= (4 * (lane + kLanes * (t / 4)) + t % 4 < m) & !isfinite(r[t]);
    }
    const float R01 = R01a + cc;
    const float c1 = z1 / R11;
    const float c0 = (z0 - R01 * c1) / R00;
    const bool ok = G00 > kSurvive * G00 && s21 > kSurvive * G11 &&
                    isfinite(c0) && isfinite(c1) && !warp_any(bad);
    if (!ok) kind = 2;
  }

  if (kind != 1) {
    load<NV>(yrow, lane, m, t0, dt, a0, a1, vec, y, x, e0, e1);
    if (kind == 0) {
#pragma unroll
      for (int t = 0; t < S; ++t) {
        r[t] = y[t];
        ra[t] = 0.0f;
        rb[t] = 0.0f;
      }
    } else {  // ridged normal equations, unrolled Cholesky
      float p[7];
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const float D0 = -(x[t] * e0[t]);
        const float D1 = -(x[t] * e1[t]);
        LSO_EXP2_ACC(7, p, t, e0[t] * e1[t], e0[t] * y[t], e1[t] * y[t],
                     D0 * e1[t], e0[t] * D1, D0 * y[t], D1 * y[t])
      }
      const float G01 = warp_sum(p[0]);
      const float b0 = warp_sum(p[1]);
      const float b1 = warp_sum(p[2]);
      const float T01 = warp_sum(p[3]);
      const float T10 = warp_sum(p[4]);
      const float U0 = warp_sum(p[5]);
      const float U1 = warp_sum(p[6]);
      const float ridge = kEps * scale2 + kTiny;
      const float A00 = G00 + ridge;
      const float A11 = G11 + ridge;
      const float dA00a = 2.0f * S00 + kEps * S00;
      const float dA00b = kEps * S11;
      const float dA11a = kEps * S00;
      const float dA11b = 2.0f * S11 + kEps * S11;
      const float L00 = sqrtf(A00);
      const float dL00a = dA00a / (2.0f * L00);
      const float dL00b = dA00b / (2.0f * L00);
      const float L10 = G01 / L00;
      const float dL10a = (T01 - L10 * dL00a) / L00;
      const float dL10b = (T10 - L10 * dL00b) / L00;
      const float L11 = sqrtf(A11 - L10 * L10);
      const float dL11a = (dA11a - 2.0f * (L10 * dL10a)) / (2.0f * L11);
      const float dL11b = (dA11b - 2.0f * (L10 * dL10b)) / (2.0f * L11);
      const float y0 = b0 / L00;
      const float dy0a = (U0 - y0 * dL00a) / L00;
      const float dy0b = -(y0 * dL00b) / L00;
      const float y1 = (b1 - L10 * y0) / L11;
      const float dy1a = (-(dL10a * y0 + L10 * dy0a) - y1 * dL11a) / L11;
      const float dy1b = ((U1 - (dL10b * y0 + L10 * dy0b)) - y1 * dL11b) / L11;
      const float k1 = y1 / L11;
      const float dk1a = (dy1a - k1 * dL11a) / L11;
      const float dk1b = (dy1b - k1 * dL11b) / L11;
      const float k0 = (y0 - L10 * k1) / L00;
      const float dk0a = ((dy0a - (dL10a * k1 + L10 * dk1a)) - k0 * dL00a) / L00;
      const float dk0b = ((dy0b - (dL10b * k1 + L10 * dk1b)) - k0 * dL00b) / L00;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const float D0 = -(x[t] * e0[t]);
        const float D1 = -(x[t] * e1[t]);
        r[t] = y[t] - (e0[t] * k0 + e1[t] * k1);
        ra[t] = -((D0 * k0 + e0[t] * dk0a) + e1[t] * dk1a);
        rb[t] = -(e0[t] * dk0b + (D1 * k1 + e1[t] * dk1b));
      }
    }
  }

  // Output pass.
  if (MODE == 0) {
    float p[5], hi, lo;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      LSO_EXP2_ACC(5, p, t, ra[t] * ra[t], ra[t] * rb[t], rb[t] * rb[t],
                   ra[t] * r[t], rb[t] * r[t])
      float h, l;
      two_prod(r[t], r[t], h, l);
      if (t == 0) {
        hi = h;
        lo = l;
      } else {
        dd_add(hi, lo, h, l);
      }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      const float oh = __shfl_xor_sync(0xffffffffu, hi, o);
      const float ol = __shfl_xor_sync(0xffffffffu, lo, o);
      dd_add(hi, lo, oh, ol);
    }
    float g[5];
#pragma unroll
    for (int u = 0; u < 5; ++u) g[u] = kind == 0 ? 0.0f : warp_sum(p[u]);
    if (lane == 0) {
      float* o = out + 8 * fit;
      o[0] = g[0];
      o[1] = g[1];
      o[2] = g[1];
      o[3] = g[2];
      o[4] = g[3];
      o[5] = g[4];
      o[6] = hi;
      o[7] = lo;
    }
  } else {
    float* rrow = R + fit * (long)m;
    float* jrow = J + 2 * fit * (long)m;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int base = 4 * (lane + kLanes * k);
      const int t = 4 * k;
      if (vec) {
        if (base < m) {
          *reinterpret_cast<float4*>(rrow + base) =
              make_float4(r[t], r[t + 1], r[t + 2], r[t + 3]);
          if (MODE == 1) {
            *reinterpret_cast<float4*>(jrow + 2 * base) =
                make_float4(ra[t], rb[t], ra[t + 1], rb[t + 1]);
            *reinterpret_cast<float4*>(jrow + 2 * base + 4) =
                make_float4(ra[t + 2], rb[t + 2], ra[t + 3], rb[t + 3]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (base + j < m) {
            rrow[base + j] = r[t + j];
            if (MODE == 1) {
              jrow[2 * (base + j)] = ra[t + j];
              jrow[2 * (base + j) + 1] = rb[t + j];
            }
          }
        }
      }
    }
  }
}

#undef LSO_EXP2_ACC

template <int NV>
int launch(const float* Y, const float* alpha, int B, int m, double t0,
           double dt, float* out, float* R, float* J, int vec,
           cudaStream_t stream) {
  const int fits_per_block = kThreads / kLanes;
  const unsigned blocks = (unsigned)((B + fits_per_block - 1) / fits_per_block);
  if (out != nullptr) {
    varpro_exp2_eval<NV, 0><<<blocks, kThreads, 0, stream>>>(
        Y, alpha, B, m, t0, dt, out, R, J, vec);
  } else if (J != nullptr) {
    varpro_exp2_eval<NV, 1><<<blocks, kThreads, 0, stream>>>(
        Y, alpha, B, m, t0, dt, out, R, J, vec);
  } else {
    varpro_exp2_eval<NV, 2><<<blocks, kThreads, 0, stream>>>(
        Y, alpha, B, m, t0, dt, out, R, J, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace lso_exp2

// Plain C entry point (bound with ctypes). Gram mode where ``out`` is set,
// else Jacobian mode into R and J (J null: R alone). NV (1, 2 or 4, as
// ops/varpro_exp2.layout gives it) is the float4 runs a lane holds, so
// m <= 128 NV. Returns cudaGetLastError() right after the launch (0:
// enqueued), or cudaErrorInvalidValue for another NV, an m past 128 NV or
// an empty batch.
extern "C" int lso_varpro_exp2_eval_f32(const void* Y, const void* alpha, int B,
                                        int m, double t0, double dt, void* out,
                                        void* R, void* J, int NV, int vec,
                                        void* stream) {
  using namespace lso_exp2;
  const float* y = static_cast<const float*>(Y);
  const float* a = static_cast<const float*>(alpha);
  float* o = static_cast<float*>(out);
  float* r = static_cast<float*>(R);
  float* j = static_cast<float*>(J);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || m <= 0 || m > 4 * kLanes * NV || (out == nullptr && R == nullptr))
    return (int)cudaErrorInvalidValue;
  if (NV == 1) return launch<1>(y, a, B, m, t0, dt, o, r, j, vec, s);
  if (NV == 2) return launch<2>(y, a, B, m, t0, dt, o, r, j, vec, s);
  if (NV == 4) return launch<4>(y, a, B, m, t0, dt, o, r, j, vec, s);
  return (int)cudaErrorInvalidValue;
}
