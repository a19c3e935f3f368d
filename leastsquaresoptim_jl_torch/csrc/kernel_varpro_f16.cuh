// The fused VarPro LM kernel in float16: packed half arithmetic, two fits
// to a __half2. Each basis is instantiated in its own source file
// (kernel_varpro_f16*.cu), so that the build runs them in parallel;
// kernel_varpro_f16.cu also holds the C entry point.
//
// Computes what kernel_varpro.cuh's varpro_lm_p1_kernel computes, in the
// same order, with the same G lanes per fit and the same width-G butterfly
// (so ops/kernel_varpro.py::_iteration_reference is its plain version),
// but a group of G lanes carries a PAIR of fits: every register holds
// sample k of fit A in its low half and of fit B in its high half, so that
// each packed instruction and each 32-bit shuffle serves two fits, and a
// warp runs 2 x 32 / G fits. Each half goes through exactly the scalar
// sequence of operations of the float32 kernel.
//
// Rounding. + - * are the native packed half instructions with explicit
// rounding (__hadd2_rn, __hsub2_rn, __hmul2_rn: add/sub/mul.rn.f16x2,
// which ptxas never contracts into an fma). sqrt is float's, rounded once
// to half: float's 24 bits are at least 2 x 11 + 2, so that is the
// correctly rounded half result, as torch's eager half arithmetic gives it
// (it computes in float and rounds). / is a float quotient within
// 2^-24 (1 + 2^-20) of the exact one, without IEEE division's slow path,
// rounded once: no quotient of two halves lies that close to a half
// rounding midpoint, so that too is the correctly rounded half quotient
// (quot below; tests/test_torch_kernel_f16_rounding.py). exp and log are
// float expf and logf rounded to half, as torch's half kernels compute
// them (h2exp is not). So the kernel matches its plain version bit for
// bit.
//
// Control. Comparisons are packed (__hgt2_mask and friends: 0xffff in each
// half where true), and the freeze, the accept test, the priority-gated
// f > x > g flags and the radius update are per-half bit blends, so a done
// fit beside a live one keeps its state bit for bit. NaN-propagating
// max/min keep nan_max/nan_min's semantics (the first NaN operand wins).
//
// Geometry: ceil(block_fits / 2) pairs a block, ceil(block_fits / 2) x G
// threads (whole warps, at most 256). A pair whose second fit lies past B
// or past the block (odd B, odd block_fits) carries a frozen fit that
// loads nothing and stores nothing. Each lane loads its run of fit A's row
// and of fit B's row (16-byte loads where vec holds) and interleaves them
// once per launch; the grid u, shared by all fits, is broadcast to both
// halves. State rows are read and written once per fit.

#pragma once

#include "kernel_varpro.cuh"

namespace lso_varpro {
namespace f16 {

using h2 = __half2;

__device__ __forceinline__ h2 splat(__half v) { return __half2half2(v); }
__device__ __forceinline__ h2 splat_bits(unsigned short v) {
  return __half2half2(__ushort_as_half(v));
}
__device__ __forceinline__ unsigned bits(h2 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ h2 from_bits(unsigned v) {
  return *reinterpret_cast<const h2*>(&v);
}

__device__ __forceinline__ h2 add(h2 a, h2 b) { return __hadd2_rn(a, b); }
__device__ __forceinline__ h2 sub(h2 a, h2 b) { return __hsub2_rn(a, b); }
__device__ __forceinline__ h2 mul(h2 a, h2 b) { return __hmul2_rn(a, b); }
__device__ __forceinline__ h2 neg(h2 a) { return __hneg2(a); }
__device__ __forceinline__ h2 abs_(h2 a) { return __habs2(a); }

// a / b for floats that hold half values: q0 = a r from the approximate
// reciprocal r (1 ulp), then one Newton step, q1 = q0 + r (a - b q0),
// which is within 2^-24 (1 + 2^-20) of a / b. Where q0 is 0, inf or NaN
// (a zero, an infinity or a NaN operand) q0 is the IEEE quotient itself.
// Operands of half range never reach float's subnormals or overflow, so
// there is no slow path.
__device__ __forceinline__ float half_quotient(float a, float b) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(b));
  const float q0 = __fmul_rn(a, r);
  const float q1 = __fmaf_rn(r, __fmaf_rn(-b, q0, a), q0);
  return fabsf(q0) <= FLT_MAX && q0 != 0.0f ? q1 : q0;
}

// The correctly rounded half quotient: a quotient of two halves is never
// within 2^-23 of a half rounding midpoint, so rounding a float within
// 2^-24 (1 + 2^-20) of it gives the half that the exact quotient rounds to.
__device__ __forceinline__ h2 quot(h2 a, h2 b) {
  const float2 fa = __half22float2(a), fb = __half22float2(b);
  return __floats2half2_rn(half_quotient(fa.x, fb.x), half_quotient(fa.y, fb.y));
}
__device__ __forceinline__ h2 sqrt_(h2 a) {
  const float2 f = __half22float2(a);
  return __floats2half2_rn(sqrtf(f.x), sqrtf(f.y));
}
__device__ __forceinline__ h2 exp_(h2 a) {
  const float2 f = __half22float2(a);
  return __floats2half2_rn(expf(f.x), expf(f.y));
}

// a where the mask's half is set, else b.
__device__ __forceinline__ h2 sel(unsigned m, h2 a, h2 b) {
  return from_bits(bits(b) ^ ((bits(a) ^ bits(b)) & m));
}
__device__ __forceinline__ unsigned isnan_(h2 a) { return ~__heq2_mask(a, a); }
__device__ __forceinline__ unsigned finite_(h2 a) {
  return __hlt2_mask(__habs2(a), splat_bits(0x7c00));  // |a| < inf
}
// nan_max / nan_min of kernel_varpro.cuh, per half.
__device__ __forceinline__ h2 nan_max(h2 a, h2 b) {
  return sel(isnan_(a), a, sel(isnan_(b), b, sel(__hgt2_mask(a, b), a, b)));
}
__device__ __forceinline__ h2 nan_min(h2 a, h2 b) {
  return sel(isnan_(a), a, sel(isnan_(b), b, sel(__hlt2_mask(a, b), a, b)));
}

template <int G> __device__ __forceinline__ h2 group_sum(h2 v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, o, G));
  return v;
}

// The basis functors of kernel_varpro.cuh on a pair: u = prep(x) once per
// launch on the shared grid (one half); then core(u, a), the costly part
// of phi at a (an exp or a division), and phi and dphi from it.
template <typename Basis> struct Packed;
template <> struct Packed<ExpSaturation> {  // core = exp(-a u)
  __device__ static __half prep(__half x) { return x; }
  __device__ static h2 core(h2 u, h2 a) { return exp_(mul(neg(a), u)); }
  __device__ static h2 phi(h2, h2 e) { return sub(splat_bits(0x3c00), e); }  // 1 - e
  __device__ static h2 dphi(h2 u, h2 e, h2) { return mul(u, e); }
};
template <> struct Packed<Power> {  // core = exp(a u) = phi, u = log x
  __device__ static __half prep(__half x) {
    return __float2half_rn(logf(__half2float(x)));
  }
  __device__ static h2 core(h2 u, h2 a) { return exp_(mul(a, u)); }
  __device__ static h2 phi(h2, h2 p) { return p; }
  __device__ static h2 dphi(h2 u, h2, h2 p) { return mul(p, u); }
};
template <> struct Packed<MichaelisMenten> {  // core = 1 / (a + u)
  __device__ static __half prep(__half x) { return x; }
  __device__ static h2 core(h2 u, h2 a) {
    return quot(splat_bits(0x3c00), add(a, u));
  }
  __device__ static h2 phi(h2 u, h2 inv) { return mul(u, inv); }
  __device__ static h2 dphi(h2, h2 inv, h2 p) { return neg(mul(p, inv)); }
};

// The constants, rounded to half and broadcast to both fits of a pair.
struct Consts2 {
  h2 x_tol, f_tol, g_tol, max_iters, min_step_quality, min_radius, max_radius;
};

struct Args2 {
  const __half* xg;  // (m,) shared grid
  const __half* Y;   // (B, m) observations
  __half* state;     // (B, 8), updated in place
  int B, m, L, block_fits, k_iters;
  bool vec;          // 16-byte loads: L, m multiples of 8, aligned rows
  Consts2 cs;
};

// out[k] = (a[k], b[k]) where valid[k] and the fit loads, else zero halves.
template <int S>
__device__ __forceinline__ void load_pair(const __half* __restrict__ a, bool load_a,
                                          const __half* __restrict__ b, bool load_b,
                                          const bool (&valid)[S], bool vec,
                                          h2 (&out)[S]) {
  if constexpr (S % 8 == 0) {
    if (vec) {  // a run's 8-blocks are wholly inside or wholly past m
#pragma unroll
      for (int k = 0; k < S; k += 8) {
        uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
        if (valid[k] && load_a) va = *reinterpret_cast<const uint4*>(a + k);
        if (valid[k] && load_b) vb = *reinterpret_cast<const uint4*>(b + k);
        const unsigned wa[4] = {va.x, va.y, va.z, va.w};
        const unsigned wb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          out[k + 2 * j] = __lows2half2(from_bits(wa[j]), from_bits(wb[j]));
          out[k + 2 * j + 1] = __highs2half2(from_bits(wa[j]), from_bits(wb[j]));
        }
      }
      return;
    }
  }
  const __half zero = __ushort_as_half(0);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    out[k] = __halves2half2(valid[k] && load_a ? a[k] : zero,
                            valid[k] && load_b ? b[k] : zero);
  }
}

// The grid's run, prep'd and broadcast to both halves (zero past m).
template <typename Basis, int S>
__device__ __forceinline__ void load_grid(const __half* __restrict__ src,
                                          const bool (&valid)[S], bool vec,
                                          h2 (&out)[S]) {
  __half x[S];
  bool loaded = false;
  if constexpr (S % 8 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < S; k += 8) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (valid[k]) v = *reinterpret_cast<const uint4*>(src + k);
        const __half* p = reinterpret_cast<const __half*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) x[k + j] = p[j];
      }
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int k = 0; k < S; ++k) x[k] = valid[k] ? src[k] : __ushort_as_half(0);
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    out[k] = valid[k] ? splat(Packed<Basis>::prep(x[k])) : splat_bits(0);
  }
}

// phi and dphi at a over a lane's run; Masked: samples past the run or
// past m are exact zeros. The trial needs phi only.
template <typename Basis, bool Masked, int S>
__device__ __forceinline__ void eval_run(const h2 (&u)[S], const bool (&valid)[S], h2 a,
                                         h2 (&P)[S], h2 (&dP)[S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const h2 core = Packed<Basis>::core(u[k], a);
    P[k] = Packed<Basis>::phi(u[k], core);
    dP[k] = Packed<Basis>::dphi(u[k], core, P[k]);
    if (Masked && !valid[k]) { P[k] = splat_bits(0); dP[k] = splat_bits(0); }
  }
}
template <typename Basis, bool Masked, int S>
__device__ __forceinline__ void phi_run(const h2 (&u)[S], const bool (&valid)[S], h2 a,
                                        h2 (&P)[S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    P[k] = Packed<Basis>::phi(u[k], Packed<Basis>::core(u[k], a));
    if (Masked && !valid[k]) P[k] = splat_bits(0);
  }
}

// A pair's state (low half fit A, high half fit B).
struct Fit2 {
  h2 alpha, delta, dec, c, iters, done, conv, flags;
};

// One LM iteration of a pair, in the order of varpro_lm_p1_kernel
// (kernel_varpro.cuh); a done fit keeps its state bit for bit.
template <typename Basis, bool Masked, int G, int S>
__device__ __forceinline__ void iterate(Fit2& f, const h2 (&u)[S], const h2 (&y)[S],
                                        const bool (&valid)[S], const Consts2& cs) {
  const h2 zero = splat_bits(0), one = splat_bits(0x3c00), two = splat_bits(0x4000);
  const h2 eps = splat_bits(0x1400);   // 2^-10
  const h2 tiny = splat_bits(0x0400);  // 2^-14
  const unsigned live = ~__hgt2_mask(f.done, zero);
  // Basis and projection at alpha.
  h2 P[S], dP[S], r[S];
  eval_run<Basis, Masked, S>(u, valid, f.alpha, P, dP);
  h2 s_n2 = zero, s_pdp = zero;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    s_n2 = add(s_n2, mul(P[k], P[k]));
    s_pdp = add(s_pdp, mul(P[k], dP[k]));
  }
  const h2 n2 = group_sum<G>(s_n2);
  const h2 floor2 = mul(add(mul(eps, n2), tiny), eps);
  const h2 R = sqrt_(add(n2, floor2));
  const h2 inv_R = quot(one, R);
  h2 s_z = zero, s_dpy = zero;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    s_z = add(s_z, mul(mul(P[k], inv_R), y[k]));
    s_dpy = add(s_dpy, mul(dP[k], y[k]));
  }
  const h2 z = group_sum<G>(s_z);
  const h2 cc = quot(z, R);

  // Exact VarPro Jacobian of the reduced residual, with the residual.
  const h2 dn2 = mul(two, group_sum<G>(s_pdp));
  const h2 dR = quot(mul(dn2, add(one, mul(eps, eps))), mul(two, R));
  const h2 dz = sub(quot(group_sum<G>(s_dpy), R), quot(mul(z, dR), R));
  const h2 dc = sub(quot(dz, R), quot(mul(z, dR), mul(R, R)));
  h2 s_ssr = zero, s_g = zero, s_b = zero;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    r[k] = sub(y[k], mul(z, mul(P[k], inv_R)));
    s_ssr = add(s_ssr, mul(r[k], r[k]));
    const h2 jr = neg(add(mul(dc, P[k]), mul(cc, dP[k])));
    s_g = add(s_g, mul(jr, jr));
    s_b = add(s_b, mul(jr, r[k]));
  }
  const h2 ssr = group_sum<G>(s_ssr);
  const h2 g = group_sum<G>(s_g);
  const h2 b = group_sum<G>(s_b);
  const h2 maxabs_gr = abs_(b);

  // Damped step and trial projection. A done fit's step is discarded: its
  // divisors are 1, so that a fit that loaded no observations (0 / 0 here,
  // then NaN everywhere) sends no division down the slow path.
  const h2 damp = quot(g, sel(live, f.delta, one));
  const h2 dx = quot(b, sel(live, add(g, damp), one));
  const h2 alpha_t = sub(f.alpha, dx);
  h2 Pt[S];
  phi_run<Basis, Masked, S>(u, valid, alpha_t, Pt);
  h2 s_n2t = zero;
#pragma unroll
  for (int k = 0; k < S; ++k) s_n2t = add(s_n2t, mul(Pt[k], Pt[k]));
  const h2 n2t = group_sum<G>(s_n2t);
  const h2 Rt = sqrt_(add(n2t, mul(add(mul(eps, n2t), tiny), eps)));
  const h2 inv_Rt = quot(one, Rt);
  h2 s_zt = zero;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    Pt[k] = mul(Pt[k], inv_Rt);  // qt
    s_zt = add(s_zt, mul(Pt[k], y[k]));
  }
  const h2 zt = group_sum<G>(s_zt);
  const h2 c_t = quot(zt, Rt);
  h2 s_ared = zero;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const h2 rt = sub(y[k], mul(zt, Pt[k]));
    s_ared = add(s_ared, mul(sub(r[k], rt), add(r[k], rt)));
  }
  const h2 ared = group_sum<G>(s_ared);
  const h2 pred = abs_(sub(mul(mul(two, dx), b), mul(mul(dx, dx), g)));
  const unsigned pred_pos = __hgt2_mask(pred, zero);  // rho's quotient, where it is taken
  const h2 rho = sel(pred_pos, quot(ared, sel(pred_pos, pred, one)), zero);

  // The scalar step of each live fit; a done fit keeps its state.
  if (!live) return;
  const unsigned accepted = __hgt2_mask(rho, cs.min_step_quality);
  // Priority-gated: f beats x beats g, at most one flag set.
  const unsigned f_conv =
      accepted & __hle2_mask(abs_(ared), mul(cs.f_tol, add(abs_(ssr), cs.f_tol)));
  const unsigned x_conv = ~f_conv & __hle2_mask(abs_(dx), cs.x_tol);
  const unsigned g_conv = ~f_conv & ~x_conv & __hle2_mask(maxabs_gr, cs.g_tol);
  const unsigned cv = f_conv | x_conv | g_conv;

  const h2 t = sub(mul(two, rho), one);
  const h2 third = splat_bits(0x3555);  // 1/3 rounded to half
  const h2 grow = nan_min(quot(f.delta, nan_max(third, sub(one, mul(mul(t, t), t)))),
                          cs.max_radius);
  const h2 shrink = nan_max(quot(f.delta, f.dec), cs.min_radius);

  const h2 new_alpha = sel(accepted | ~finite_(dx), alpha_t, f.alpha);
  const h2 new_iters = add(f.iters, one);
  const unsigned new_done = cv | ~finite_(new_alpha) | __hge2_mask(new_iters, cs.max_iters);
  f.delta = sel(live, sel(accepted, grow, shrink), f.delta);
  f.dec = sel(live, sel(accepted, two, mul(f.dec, two)), f.dec);
  f.c = sel(live, sel(accepted, c_t, cc), f.c);
  f.alpha = sel(live, new_alpha, f.alpha);
  f.iters = sel(live, new_iters, f.iters);
  f.done = sel(live, sel(new_done, one, zero), f.done);
  f.conv = sel(live, sel(cv, one, zero), f.conv);
  const h2 flag = sel(f_conv, two, sel(x_conv, splat_bits(0x4400),     // 4
                                       sel(g_conv, splat_bits(0x4800),  // 8
                                           zero)));
  f.flags = sel(live, flag, f.flags);
}

// State row of a fit, or the frozen defaults (alpha 0, radius 1, decrease
// 2, c 0, iterations 0, done 1, converged 0, flags 0) past B.
__device__ __forceinline__ void load_row(const __half* st, bool in_batch, __half (&row)[kNS]) {
  const unsigned short frozen[kNS] = {0, 0x3c00, 0x4000, 0, 0, 0x3c00, 0, 0};
#pragma unroll
  for (int j = 0; j < kNS; ++j) row[j] = in_batch ? st[j] : __ushort_as_half(frozen[j]);
}

// S half2 hold two fits in the registers that S floats hold for one, so
// the runs of up to 16 samples keep float32's 128 registers and two
// 256-thread blocks an SM.
template <int S> constexpr int kMinBlocks2 = S <= 16 ? 2 : 1;

template <int G, int S, typename Basis>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks2<S>)
varpro_lm_p1_f16_kernel(Args2 a) {
  const int gl = threadIdx.x % G;    // lane within the pair's group
  const int pair = threadIdx.x / G;  // fits 2 pair and 2 pair + 1 of the block
  const int fit_a = blockIdx.x * a.block_fits + 2 * pair;
  const bool in_a = fit_a < a.B;
  const bool in_b = 2 * pair + 1 < a.block_fits && fit_a + 1 < a.B;
  __half* st_a = a.state + static_cast<size_t>(in_a ? fit_a : 0) * kNS;
  __half* st_b = a.state + static_cast<size_t>(in_b ? fit_a + 1 : 0) * kNS;
  Fit2 f;
  {
    __half ra[kNS], rb[kNS];
    load_row(st_a, in_a, ra);
    load_row(st_b, in_b, rb);
    f.alpha = __halves2half2(ra[kAlpha], rb[kAlpha]);
    f.delta = __halves2half2(ra[kDelta], rb[kDelta]);
    f.dec = __halves2half2(ra[kDec], rb[kDec]);
    f.c = __halves2half2(ra[kC], rb[kC]);
    f.iters = __halves2half2(ra[kIters], rb[kIters]);
    f.done = __halves2half2(ra[kDone], rb[kDone]);
    f.conv = __halves2half2(ra[kConv], rb[kConv]);
    f.flags = __halves2half2(ra[kFlags], rb[kFlags]);
  }
  const h2 zero = splat_bits(0);
  const unsigned active0 = ~__hgt2_mask(f.done, zero);  // !(done > 0), per fit

  const int first = gl * a.L;
  // Every lane's run is whole (uniform over the grid): no masks needed.
  const bool full = a.L == S && G * S == a.m;
  h2 u[S], y[S];
  bool valid[S];
#pragma unroll
  for (int k = 0; k < S; ++k) valid[k] = k < a.L && first + k < a.m;
  load_grid<Basis, S>(a.xg + first, valid, a.vec, u);
  load_pair<S>(a.Y + static_cast<size_t>(in_a ? fit_a : 0) * a.m + first,
               in_a && (active0 & 0xffffu),
               a.Y + static_cast<size_t>(in_b ? fit_a + 1 : 0) * a.m + first,
               in_b && (active0 >> 16), valid, a.vec, y);

  for (int it = 0;
       it < a.k_iters && __any_sync(0xffffffffu, __hgt2_mask(f.done, zero) != 0xffffffffu);
       ++it) {
    if (full) {
      iterate<Basis, false, G, S>(f, u, y, valid, a.cs);
    } else {
      iterate<Basis, true, G, S>(f, u, y, valid, a.cs);
    }
  }

  if (gl == 0) {
    const h2 row[kNS] = {f.alpha, f.delta, f.dec, f.c, f.iters, f.done, f.conv, f.flags};
    if (in_a && (active0 & 0xffffu)) {
#pragma unroll
      for (int j = 0; j < kNS; ++j) st_a[j] = __low2half(row[j]);
    }
    if (in_b && (active0 >> 16)) {
#pragma unroll
      for (int j = 0; j < kNS; ++j) st_b[j] = __high2half(row[j]);
    }
  }
}

template <typename Basis, int G, int S>
cudaError_t run(const Args2& a, dim3 grid, dim3 block, cudaStream_t s) {
  varpro_lm_p1_f16_kernel<G, S, Basis><<<grid, block, 0, s>>>(a);
  return cudaGetLastError();
}

// The pairs that ops/kernel_varpro.py::lanes_per_fit reaches (its
// _INSTANCES_F16); any other pair is refused.
template <typename Basis>
cudaError_t launch_instance(const Args2& a, int G, int S, dim3 grid, dim3 block,
                            cudaStream_t s) {
  if (G == 1 && S == 1) return run<Basis, 1, 1>(a, grid, block, s);
  if (G == 1 && S == 2) return run<Basis, 1, 2>(a, grid, block, s);
  if (G == 1 && S == 4) return run<Basis, 1, 4>(a, grid, block, s);
  if (G == 1 && S == 8) return run<Basis, 1, 8>(a, grid, block, s);
  if (G == 1 && S == 16) return run<Basis, 1, 16>(a, grid, block, s);
  if (G == 2 && S == 16) return run<Basis, 2, 16>(a, grid, block, s);
  if (G == 4 && S == 16) return run<Basis, 4, 16>(a, grid, block, s);
  if (G == 8 && S == 16) return run<Basis, 8, 16>(a, grid, block, s);
  if (G == 16 && S == 16) return run<Basis, 16, 16>(a, grid, block, s);
  if (G == 32 && S == 16) return run<Basis, 32, 16>(a, grid, block, s);
  if (G == 32 && S == 32) return run<Basis, 32, 32>(a, grid, block, s);
  return cudaErrorInvalidValue;
}

// Checks the launch and runs it: G = lanes lanes per pair of fits,
// block_fits fits (ceil(block_fits / 2) * lanes threads, whole warps, at
// most 256) per block.
template <typename Basis>
int launch_basis(const __half* x, const __half* Y, __half* state, int B, int m,
                 int k_iters, const Consts2& cs, int lanes, int block_fits,
                 cudaStream_t stream) {
  if (B <= 0 || m < 1 || m > kMaxM || k_iters < 1 || lanes < 1 || block_fits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int L = (m + lanes - 1) / lanes;
  const long long threads = static_cast<long long>((block_fits + 1) / 2) * lanes;
  if (threads % 32 != 0 || threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int S = 1;
  while (S < L) S *= 2;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  const Args2 a{x, Y, state, B, m, L, block_fits, k_iters,
                aligned && L % 8 == 0 && m % 8 == 0, cs};
  const dim3 block(static_cast<unsigned>(threads));
  const dim3 grid((B + block_fits - 1) / block_fits);
  return static_cast<int>(launch_instance<Basis>(a, lanes, S, grid, block, stream));
}

// Each basis is instantiated in its own source file.
#define LSO_VARPRO_F16_INSTANCE(EXTERN, BASIS)                                     \
  EXTERN template int launch_basis<BASIS>(const __half*, const __half*, __half*,  \
                                          int, int, int, const Consts2&, int, int, \
                                          cudaStream_t);

LSO_VARPRO_F16_INSTANCE(extern, ExpSaturation)
LSO_VARPRO_F16_INSTANCE(extern, Power)
LSO_VARPRO_F16_INSTANCE(extern, MichaelisMenten)

}  // namespace f16
}  // namespace lso_varpro
