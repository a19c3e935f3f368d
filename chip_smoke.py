"""Drive the PyTorch port on one NVIDIA GPU: the batched curve-fit path,
the Gram kernel and the row-sharded Gram, and the single-fit dense path.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. Card and build: the card's name and power limit (nvidia-smi), and the
   time to build the CUDA kernels from leastsquaresoptim_jl_torch/csrc/.
2. The fused VarPro LM kernel against its plain PyTorch version on the
   card: B = 4099 fits (not a block multiple), m = 64, from one numpy-made
   state, in float32 and float64, after one launch of K = 8 iterations and
   over a full solve. Limits: float64 median relative alpha difference
   <= 1e-12 and iterations/flags equal on >= 99.9% of fits; float32
   <= 1e-6 and >= 99%.
3. The plain route: the bench.py workload (B = 131072 exp_saturation fits
   on a shared 64-point grid, float32, numpy default_rng(0), starts
   0.7-1.4x the truth) through curve_fit_batch(separable=True,
   gridded=True, fused="ssr", LevenbergMarquardt(Cholesky()),
   min_converged_fraction=0.99). Limits: 0 kernel launches (counter reset
   just before); >= 99% converged; median relative error of the full
   minimizer against the truth <= 1e-4.
4. The kernel route: the same data through varpro_lm_p1_kernel_solve.
   Limits: kernel launched at least once (counter reset just before);
   >= 99% converged; median relative alpha difference from phase 3 <= 1e-5.
5. Times, after warm-up, with torch.cuda.synchronize() around each timed
   region: the routes of phases 3 and 4 and the plain reference route, and
   one K = 8 launch of the kernel against its plain version (CUDA events).
6. The Gram kernel (gram_and_rhs(use_pallas=True)) and its plain version
   against a float64 Gram on the card, at (2^20, n) for n = 256, 128, 64,
   32, at config #3's (8192, 1024), at the tail shapes (1300, 32) and
   (100, 32), float32, and at (2^20, 128) in bfloat16. Limit: every entry
   within 1e-5 of its Cauchy-Schwarz scale (bfloat16: plus 2^-8, the
   rounding of the result). A TF32 control (J and y rounded to TF32's 10
   mantissa bits, then the plain float32 Gram) must exceed that limit at
   every float32 shape with m <= 8192, so that the check would catch a
   kernel that reads J in TF32. At every shape with m >= 8192: the times
   of the kernel route (launch and chunk sum), of its plain version and
   of the library call J.mT @ J, J.mT @ y in J's dtype (TF32 off), each
   the mean of 20 back-to-back calls between two CUDA events after 3
   warm-up calls; the bound (the larger of the bytes of J, y and the
   result over 3.35 TB/s and the m n (n + 1) FLOPs of the upper triangle
   over 495 TFLOP/s in TF32, 989 in bf16) and the kernel's share of it.
6b. Measurement builds of gram.cu (LSO_GRAM_PROBE, see its header), at
   the float32 shapes of phase 6 with m >= 8192, launched alone into
   preallocated scratch (phase 6's timing): the error of a kernel that
   keeps one wgmma accumulator for a whole row chunk, beside the kernel's
   (which must be within phase 6's limit); the split pass's cost alone
   (no wgmmas, with and without the pass) and on the kernel's critical
   path (the kernel with and without the pass).
7. The row-sharded Gram on a one-rank NCCL group at (2^20, 256): equal to
   gram_and_rhs(use_pallas=True) bit for bit, the kernel's counter moved
   (reset just before), and the normal-equations solution within 1e-4
   relative of float64 lstsq.
8. The single-fit path: (a) Rosenbrock through optimize (Dogleg(QR())),
   float64, converged within 1e-6 of [1, 1]; (b) BASELINE.json config #3
   (benchmarks/bench_bounded_dogleg.py:29-50) through solve(Dogleg(
   Cholesky()), lower=0.2, 30 iterations, tolerances 0) in float64 and
   float32: finite, feasible, float32 final ssr within 1% of float64, no
   Gram kernel launch in 8a-8b (the solvers' Gram is plain), Dogleg
   iterations/s; (c) config #3's J at the float32 final iterate through the
   Gram kernel and its plain version, errors (phase 6's limit, with its
   TF32 control), and phase 6's times and bound.

The second-to-last line is a JSON object describing each kernel (times
from phase 5 for kernel_varpro, from phase 6 at (2^20, 256) float32 for
the Gram; bounds from this run's shapes and, for kernel_varpro, the
iterations its fits ran); the last is {"ok": true, "device": {...}}. The
script needs one CUDA card and imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B_MAIN, M = 131_072, 64
TOLS = dict(x_tol=1e-6, f_tol=1e-6, g_tol=1e-5)
ITERATIONS, FRAC, RADIUS, K = 50, 0.99, 100.0, 8


def bench_data(B, seed):
    """bench.py's workload (bench.py:211-255): truth, observations, starts."""
    rng = np.random.default_rng(seed)
    xdata = np.linspace(1.0, 80.0, M)
    bt = np.stack([rng.uniform(100, 400, B), rng.uniform(1e-2, 6e-2, B)], axis=1)
    Y = bt[:, :1] * (1.0 - np.exp(-bt[:, 1:2] * xdata[None, :]))
    x0s = bt * rng.uniform(0.7, 1.4, size=(B, 2))
    return xdata, Y, x0s, bt


def rel(a, b):
    a = a.double()
    b = b.double()
    return (a - b).abs() / b.abs()


def check(ok, what):
    if not ok:
        raise AssertionError(f"FAILED: {what}")
    print(f"  ok: {what}")


def agree(out_k, out_r):
    """Share of fits whose iterations and all flags agree."""
    same = out_k["iterations"] == out_r["iterations"]
    for key in ("converged", "f_converged", "x_converged", "g_converged", "done"):
        same &= out_k[key] == out_r[key]
    return float(same.double().mean())


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from leastsquaresoptim_jl_torch import Cholesky, LevenbergMarquardt, Options, _build
    from leastsquaresoptim_jl_torch.interop import kernel_state
    from leastsquaresoptim_jl_torch.models import curve_fit_batch
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # -- phase 1: card and build ------------------------------------------
    print("== phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), device 0: {name}")
    _build.load()
    print(f"kernels built and loaded in {_build.build_seconds:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # -- phase 2: kernel against its plain version ------------------------
    print("== phase 2: kernel_varpro vs plain PyTorch version (B=4099, m=64)")
    xd, Y_np, x0_np, _ = bench_data(4099, seed=1)
    limits = {torch.float64: (1e-12, 0.999), torch.float32: (1e-6, 0.99)}
    for dt, (med_lim, agree_lim) in limits.items():
        np_dt = np.float64 if dt == torch.float64 else np.float32
        x = torch.tensor(xd, dtype=dt, device=dev)
        Y = torch.tensor(Y_np, dtype=dt, device=dev)
        state0 = torch.tensor(kernel_state(x0_np[:, 1], RADIUS, np_dt), device=dev)
        tols = (TOLS["x_tol"], TOLS["f_tol"], TOLS["g_tol"])
        sk = kv._launch_kernel("exp_saturation", x, Y, state0.clone(), K, tols,
                               float(ITERATIONS), 8)
        sr = kv._launch_reference("exp_saturation", x, Y, state0.clone(), K,
                                  tols, float(ITERATIONS), None)
        torch.cuda.synchronize()
        ra = rel(sk[:, kv._ALPHA], sr[:, kv._ALPHA])
        rc = rel(sk[:, kv._C], sr[:, kv._C])
        same = ((sk[:, kv._ITERS] == sr[:, kv._ITERS])
                & (sk[:, kv._FLAGS] == sr[:, kv._FLAGS])
                & (sk[:, kv._DONE] == sr[:, kv._DONE])).double().mean().item()
        print(f"  {dt} one launch K={K}: alpha rel max {ra.max().item():.3e} "
              f"median {ra.median().item():.3e}; c rel max {rc.max().item():.3e} "
              f"median {rc.median().item():.3e}; iterations/flags equal "
              f"{same:.6f}")
        check(ra.median().item() <= med_lim and same >= agree_lim,
              f"{dt} one launch within median {med_lim:g}, agreement {agree_lim}")
        kw = dict(TOLS, iterations=ITERATIONS, min_converged_fraction=FRAC,
                  k_iters=K, radius=RADIUS)
        ok_ = kv.varpro_lm_p1_kernel_solve("exp_saturation", x, Y,
                                            state0[:, kv._ALPHA], **kw)
        or_ = kv.varpro_lm_p1_reference_solve("exp_saturation", x, Y,
                                               state0[:, kv._ALPHA], **kw)
        ra = rel(ok_["alpha"], or_["alpha"])
        rc = rel(ok_["coefficient"], or_["coefficient"])
        same = agree(ok_, or_)
        print(f"  {dt} full solve: alpha rel max {ra.max().item():.3e} median "
              f"{ra.median().item():.3e}; c rel max {rc.max().item():.3e} "
              f"median {rc.median().item():.3e}; iterations/flags equal "
              f"{same:.6f}; converged {ok_['converged'].double().mean().item():.6f}")
        check(ra.median().item() <= med_lim and same >= agree_lim,
              f"{dt} full solve within median {med_lim:g}, agreement {agree_lim}")

    # -- phases 3 and 4: the main path ------------------------------------
    xdata, Y_np, x0_np, bt = bench_data(B_MAIN, seed=0)
    Y = torch.tensor(Y_np, dtype=torch.float32, device=dev)
    P0 = torch.tensor(x0_np, dtype=torch.float32, device=dev)
    truth = torch.tensor(bt, dtype=torch.float64, device=dev)
    opts = Options(iterations=ITERATIONS, radius=RADIUS, **TOLS)

    def run_main():
        return curve_fit_batch(
            "exp_saturation", xdata, Y, P0,
            optimizer=LevenbergMarquardt(Cholesky()), options=opts,
            min_converged_fraction=FRAC, separable=True, gridded=True,
            fused="ssr",
        )

    kernel_kw = dict(TOLS, iterations=ITERATIONS, min_converged_fraction=FRAC,
                     k_iters=K, radius=RADIUS)

    def run_kernel():
        return kv.varpro_lm_p1_kernel_solve("exp_saturation", xdata, Y,
                                            P0[:, 1], **kernel_kw)

    def run_reference():
        return kv.varpro_lm_p1_reference_solve("exp_saturation", xdata, Y,
                                               P0[:, 1], **kernel_kw)

    kv.launches = 0
    print(f"== phase 3: curve_fit_batch on the card (B={B_MAIN}, m={M}, float32)")
    t_main, raw = sync_time(run_main)
    check(kv.launches == 0,
          f"phase 3 (the plain route) launched kernel_varpro {kv.launches} times, 0 expected")
    conv = raw["converged"].double().mean().item()
    err = rel(raw["minimizer"], truth).median().item()
    print(f"  converged {conv:.6f}, median rel error vs truth {err:.3e}, "
          f"iterations max {int(raw['iterations'].max())}, "
          f"finite {bool(torch.isfinite(raw['minimizer']).all())}, "
          f"shape {tuple(raw['minimizer'].shape)}, first call {t_main:.3f} s")
    check(conv >= 0.99, "phase 3 >= 99% converged")
    check(err <= 1e-4, "phase 3 median relative error vs truth <= 1e-4")
    check(raw["minimizer"].shape == (B_MAIN, 2), "phase 3 minimizer shape")

    print("== phase 4: kernel route varpro_lm_p1_kernel_solve on the card")
    kv.launches = 0
    t_kern, out = sync_time(run_kernel)
    main_launches = kv.launches
    conv_k = out["converged"].double().mean().item()
    d_alpha = rel(out["alpha"], raw["minimizer"][:, 1]).median().item()
    err_k = rel(out["alpha"], truth[:, 1]).median().item()
    print(f"  launches {main_launches}, converged {conv_k:.6f}, median alpha "
          f"rel diff from phase 3 {d_alpha:.3e}, median alpha rel error vs "
          f"truth {err_k:.3e}, first call {t_kern:.3f} s")
    check(main_launches > 0, "kernel launched on the kernel route")
    check(conv_k >= 0.99, "phase 4 >= 99% converged")
    check(d_alpha <= 1e-5, "phase 4 median alpha rel diff from phase 3 <= 1e-5")

    # -- phase 5: times ---------------------------------------------------
    print(f"== phase 5: times (B={B_MAIN}, m={M}, float32) on {smi}")
    reps = 5
    for label, fn in (("curve_fit_batch route", run_main),
                      ("kernel route", run_kernel),
                      ("plain reference route", run_reference)):
        fn()  # warm-up
        ts = [sync_time(fn)[0] for _ in range(reps)]
        best, med = min(ts), float(np.median(ts))
        print(f"  {label}: best {best:.6f} s, median {med:.6f} s over {reps}; "
              f"{B_MAIN / best:.1f} fits/s (best) [{smi}]")

    # One K=8 launch from the initial state at the main path's shapes.
    x = torch.tensor(xdata, dtype=torch.float32, device=dev)
    state0 = torch.tensor(kernel_state(x0_np[:, 1], RADIUS, np.float32), device=dev)
    tols = (TOLS["x_tol"], TOLS["f_tol"], TOLS["g_tol"])
    sk = kv._launch_kernel("exp_saturation", x, Y, state0.clone(), K, tols,
                           float(ITERATIONS), 8)
    sr = kv._launch_reference("exp_saturation", x, Y, state0.clone(), K, tols,
                              float(ITERATIONS), None)
    cols = [kv._ALPHA, kv._C]
    max_abs = (sk[:, cols] - sr[:, cols]).abs().max().item()
    med_rel = rel(sk[:, kv._ALPHA], sr[:, kv._ALPHA]).median().item()
    print(f"  one launch K={K} at B={B_MAIN}: alpha/c max abs diff {max_abs:.3e}, "
          f"alpha median rel diff {med_rel:.3e}")
    check(med_rel <= 1e-6, "main-shape launch median alpha rel diff <= 1e-6")

    def event_ms(launch, n=20):
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        for i in range(n):
            st = state0.clone()
            starts[i].record()
            launch("exp_saturation", x, Y, st, K, tols, float(ITERATIONS), 8)
            ends[i].record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))

    event_ms(kv._launch_kernel, 3)  # warm-up
    event_ms(kv._launch_reference, 3)
    ms_k = event_ms(kv._launch_kernel)
    ms_r = event_ms(kv._launch_reference)
    fit_iters = int((sk[:, kv._ITERS] - state0[:, kv._ITERS]).sum().item())
    bound_k, bound_by_k = varpro_bound(B_MAIN, M, fit_iters, 4)
    print(f"  one launch K={K}: kernel {ms_k:.4f} ms, plain version {ms_r:.4f} ms "
          f"(median of 20, CUDA events); bound {bound_k:.4f} ms ({bound_by_k}; "
          f"{fit_iters} fit-iterations), kernel at {bound_k / ms_k:.1%} of it; "
          f"no single library call computes it [{smi}]")

    gram_cmp = phase_gram(dev, smi)
    phase_gram_probes(dev, smi)
    gram_launches = phase_sharded_gram(dev)
    phase_single_fit(dev, smi)

    print(json.dumps({"kernels": [{
        "name": "kernel_varpro",
        "route": "cuda",
        "source": "leastsquaresoptim_jl_torch/csrc/kernel_varpro.cu",
        "replaces": "leastsquaresoptim_jl_tpu/ops/kernel_varpro.py:161",
        "launches": main_launches,
        "max_abs_err": max_abs,
        "ms": ms_k,
        "plain_ms": ms_r,
        "bound_ms": bound_k,
        "bound_by": bound_by_k,
        "library_ms": None,
    }, {
        "name": "gram",
        "route": "cuda",
        "source": "leastsquaresoptim_jl_torch/csrc/gram.cu",
        "replaces": "leastsquaresoptim_jl_tpu/ops/gram.py:71",
        "launches": gram_launches,
        **gram_cmp,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def loop_ms(fn, n=20, warmup=3):
    """Mean time of ``fn()`` in ms over ``n`` back-to-back calls between two
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W).
HBM_BYTES_PER_MS = 3.35e9
PEAK_FLOPS_PER_MS = {"tf32": 495e9, "bf16": 989e9, "fp32": 67e9}
# Operations of one p = 1 VarPro LM iteration per sample, counted from
# ops/kernel_varpro.py::_iteration_reference: two evaluations of the
# model and its projection (a multiply, exp, subtract and multiply for
# the basis; P.P, q = P / R, q.y, r = y - z q: 9 FLOPs, 1 exp, 1 division
# each), then r.r, P.dP, dP.y, the Jacobian (3), J.J, J.r and the actual
# reduction (4): 17 FLOPs. exp and division count one each; the per-fit
# scalar work (about 50 operations per fit) is left out.
VARPRO_OPS_PER_SAMPLE_ITERATION = 2 * (9 + 1 + 1) + 17


def bound_of(nbytes, flops, peak):
    """(least ms, binding term): bytes over HBM bandwidth or operations
    over the peak rate for their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_MS
    t_ops = flops / PEAK_FLOPS_PER_MS[peak]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gram_bound(m, n, dtype):
    """The Gram's bound: J and y read once and G, J'y written once (in J's
    dtype); the m n (n + 1) FLOPs of the upper triangle with its diagonal
    at the tensor-core rate for J's type."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (m * n + m + n * n + n) * size
    return bound_of(nbytes, m * n * (n + 1),
                    "bf16" if dtype == torch.bfloat16 else "tf32")


def varpro_bound(B, m, fit_iterations, size):
    """kernel_varpro's bound for one float32 launch: Y and x read once,
    the (B, 8) state read and written once; the operations of the
    fit-iterations the launch ran, at the float32 rate outside the tensor
    cores (67 TFLOP/s)."""
    nbytes = (B * m + m + 2 * B * 8) * size
    return bound_of(nbytes, fit_iterations * m * VARPRO_OPS_PER_SAMPLE_ITERATION, "fp32")


def gram_times(J, y, smi, what):
    """Phase 6's times at one shape: kernel route, plain version, library
    call; the bound and the kernel's share of it. Returns a dict for the
    kernels line."""
    from leastsquaresoptim_jl_torch.ops import gram

    m, n = J.shape
    ms_k = loop_ms(lambda: gram.gram_and_rhs(J, y, use_pallas=True))
    ms_r = loop_ms(lambda: gram._gram_reference(J, y))
    ms_l = loop_ms(lambda: (J.mT @ J, J.mT @ y))
    bound, bound_by = gram_bound(m, n, J.dtype)
    print(f"  {what}: kernel_ms {ms_k:.4f}, library_ms {ms_l:.4f} (J.mT @ J, "
          f"J.mT @ y in {J.dtype}), plain_ms {ms_r:.4f}, bound_ms {bound:.4f} "
          f"({bound_by}), kernel at {bound / ms_k:.1%} of the bound "
          f"(means of 20 back-to-back calls, CUDA events) [{smi}]")
    return dict(ms=ms_k, plain_ms=ms_r, bound_ms=bound, bound_by=bound_by,
                library_ms=ms_l)


def gram_errors(G, b, G64, b64, y64):
    """Largest |G - G64| / sqrt(G64_ii G64_jj) and |b - b64| /
    (sqrt(G64_ii) ||y||): each entry's error against the Cauchy-Schwarz
    bound of its own sum of products."""
    d = torch.sqrt(torch.diagonal(G64))
    eg = ((G.double() - G64).abs() / (d[:, None] * d[None, :])).max().item()
    eb = ((b.double() - b64).abs() / (d * torch.linalg.vector_norm(y64))).max().item()
    return eg, eb


# Phase 6 shapes: bench_gram.py's (2^20, 256) and the narrower widths the
# kernel takes, config #3's J, and the tail and all-tail cases of
# tests/test_gram.py.
GRAM_SHAPES = [
    ((1_048_576, 256), torch.float32), ((1_048_576, 128), torch.float32),
    ((1_048_576, 64), torch.float32), ((1_048_576, 32), torch.float32),
    ((8192, 1024), torch.float32), ((1300, 32), torch.float32),
    ((100, 32), torch.float32), ((1_048_576, 128), torch.bfloat16),
]
# Sound float32 sums, the kernel's and cuBLAS's, came within 1.5e-6 on
# every shape here (one NVIDIA H100 80GB HBM3, 700 W). Rounding J and y to
# TF32 adds about 4e-4 / sqrt(m) per entry: the control measured 2.1e-4 at
# (100, 32), 6.3e-5 at (1300, 32) and 2.9e-5 at (8192, 1024), but only
# 4.0e-6 to 6.8e-6 at m = 2^20, so the limit separates the two up to
# m = 8192.
GRAM_LIMIT = 1e-5
TF32_CONTROL_MAX_M = 8192
# bfloat16 results are rounded to bfloat16 (2^-8 relative at most, and
# |G_ij| <= sqrt(G_ii G_jj)), so that rounding adds to the limit there.
BF16_ROUNDING = 2.0 ** -8


def check_tf32_control(J, y, G64, b64, what):
    """One TF32 product (J and y rounded to TF32 once, then a float32 Gram
    with TF32 off) against the float64 Gram of J and y: it must exceed
    GRAM_LIMIT."""
    from leastsquaresoptim_jl_torch.ops.gram import tf32_round

    Jt, yt = tf32_round(J), tf32_round(y)
    Gt, bt = Jt.mT @ Jt, Jt.mT @ yt
    errs = gram_errors(Gt, bt, G64, b64, y.double())
    print(f"  {what}: TF32 control G err {errs[0]:.3e}, J'y err {errs[1]:.3e}")
    return errs


def phase_gram(dev, smi):
    """Phase 6: the Gram kernel and its plain version against a float64
    Gram on the card; times at every full-size shape."""
    from leastsquaresoptim_jl_torch.ops import gram

    print("== phase 6: Gram kernel vs plain version vs float64 on the card")
    rng = np.random.default_rng(6)
    main = None
    for (m, n), dt in GRAM_SHAPES:
        J = torch.tensor(rng.standard_normal((m, n), dtype=np.float32), device=dev).to(dt)
        y = torch.tensor(rng.standard_normal(m, dtype=np.float32), device=dev).to(dt)
        G64, b64 = J.double().mT @ J.double(), J.double().mT @ y.double()
        Gk, bk = gram.gram_and_rhs(J, y, use_pallas=True)
        Gr, br = gram._gram_reference(J, y)
        torch.cuda.synchronize()
        check(Gk.shape == (n, n) and bk.shape == (n,) and Gk.dtype == dt
              and bool(torch.isfinite(Gk).all() & torch.isfinite(bk).all()),
              f"({m}, {n}) {dt}: finite ({n}, {n}) and ({n},) in {dt}")
        errs_k = gram_errors(Gk, bk, G64, b64, y.double())
        errs_r = gram_errors(Gr, br, G64, b64, y.double())
        limit = GRAM_LIMIT + (BF16_ROUNDING if dt == torch.bfloat16 else 0.0)
        print(f"  ({m}, {n}) {dt}: kernel G err {errs_k[0]:.3e}, J'y err "
              f"{errs_k[1]:.3e}; plain G err {errs_r[0]:.3e}, J'y err {errs_r[1]:.3e}")
        check(max(errs_k) <= limit and max(errs_r) <= limit,
              f"({m}, {n}) {dt}: kernel and plain within {limit:.3g} of float64")
        if dt == torch.float32:
            errs_t = check_tf32_control(J, y, G64, b64, f"({m}, {n}) {dt}")
            if m <= TF32_CONTROL_MAX_M:
                check(max(errs_t) > limit,
                      f"({m}, {n}): the TF32 control exceeds the limit {limit:g}")
        if m >= 8192:
            times = gram_times(J, y, smi, f"({m}, {n}) {dt}")
            if (m, n, dt) == (1_048_576, 256, torch.float32):
                main = dict(max_abs_err=(Gk - Gr).abs().max().item(), **times)
        del J, y, G64, b64
    return main


# LSO_GRAM_PROBE values of gram.cu's measurement builds.
GRAM_PROBES = {"one accumulator per chunk": 1, "no wgmma": 2,
               "no wgmma, no split pass": 3, "no split pass": 4}


def phase_gram_probes(dev, smi):
    """Phase 6b: gram.cu's measurement builds against the kernel."""
    from leastsquaresoptim_jl_torch import _build
    from leastsquaresoptim_jl_torch.ops import gram

    print("== phase 6b: Gram kernel measurement builds (LSO_GRAM_PROBE)")
    t0 = time.perf_counter()
    libs = _build.load_variants(
        "gram.cu", {k: [f"-DLSO_GRAM_PROBE={v}"] for k, v in GRAM_PROBES.items()})
    libs = {"kernel": _build.load(), **libs}
    print(f"  {len(GRAM_PROBES)} builds in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(6)
    for (m, n), dt in GRAM_SHAPES:
        if dt != torch.float32 or m < 8192:
            continue
        J = torch.tensor(rng.standard_normal((m, n), dtype=np.float32), device=dev)
        y = torch.tensor(rng.standard_normal(m, dtype=np.float32), device=dev)
        G64, b64 = J.double().mT @ J.double(), J.double().mT @ y.double()
        rows, chunks = gram._plan(libs["kernel"], J)
        gp = torch.empty((chunks, n, n), device=dev)
        bp = torch.empty((chunks, n), device=dev)
        errs, ms = {}, {}
        for label, lib in libs.items():
            def launch(lib=lib):
                gram._enqueue(lib, J, y, rows, gp, bp)
            if label in ("kernel", "one accumulator per chunk"):
                launch()
                errs[label] = gram_errors(gp.sum(dim=0), bp.sum(dim=0), G64, b64, y.double())
            ms[label] = loop_ms(launch)
        print(f"  ({m}, {n}) float32, {chunks} chunks of {rows} rows: G err "
              f"{errs['kernel'][0]:.3e} (kernel), "
              f"{errs['one accumulator per chunk'][0]:.3e} (one accumulator per chunk)")
        check(max(errs["kernel"]) <= GRAM_LIMIT, f"({m}, {n}): kernel launch alone "
              f"within {GRAM_LIMIT:g} of float64")
        print(f"  ({m}, {n}) launch alone, ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f"; split pass alone {ms['no wgmma'] - ms['no wgmma, no split pass']:.4f}, "
              f"on the critical path {ms['kernel'] - ms['no split pass']:.4f} "
              f"(means of 20 back-to-back launches, CUDA events) [{smi}]")
        del J, y, G64, b64, gp, bp


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_sharded_gram(dev):
    """Phase 7: the row-sharded Gram on a one-rank NCCL group; returns the
    Gram kernel's launches in it."""
    import torch.distributed as dist

    from leastsquaresoptim_jl_torch import parallel
    from leastsquaresoptim_jl_torch.ops import gram
    from leastsquaresoptim_jl_torch.solver.cholesky import solve_spd_system

    m, n = 1_048_576, 256
    print(f"== phase 7: sharded_gram_and_rhs on a one-rank NCCL group ({m}, {n}) float32")
    rng = np.random.default_rng(7)
    x_true = rng.standard_normal(n)
    A = rng.standard_normal((m, n), dtype=np.float32)
    J = torch.tensor(A, device=dev)
    y = torch.tensor((A @ x_true + 0.1 * rng.standard_normal(m)).astype(np.float32),
                     device=dev)
    parallel.initialize_multihost(f"tcp://127.0.0.1:{free_port()}", 1, 0)
    try:
        print(f"  backend {dist.get_backend()}, world size {dist.get_world_size()}")
        gram.launches = 0
        G, b = parallel.sharded_gram_and_rhs(J, y, use_pallas=True)
        torch.cuda.synchronize()
        launches = gram.launches
        G1, b1 = gram.gram_and_rhs(J, y, use_pallas=True)
        check(launches > 0, f"Gram kernel launched {launches} time(s) on the sharded path")
        check(torch.equal(G, G1) and torch.equal(b, b1),
              "sharded Gram equals gram_and_rhs(use_pallas=True) bit for bit (one rank)")
        x = solve_spd_system(G, b)
        x64 = torch.linalg.lstsq(J.double(), y.double().unsqueeze(-1)).solution.squeeze(-1)
        err = (torch.linalg.vector_norm(x.double() - x64)
               / torch.linalg.vector_norm(x64)).item()
        print(f"  solve_spd_system(G, b) vs float64 lstsq: relative error {err:.3e}")
        check(err <= 1e-4, "least-squares solution within 1e-4 of float64 lstsq")
    finally:
        dist.destroy_process_group()
    return launches


def config3_problem(dev, dtype):
    """BASELINE.json config #3 as benchmarks/bench_bounded_dogleg.py:29-50
    builds it (m = 8192, n = 1024, lower bound 0.2, x0 = 0.6)."""
    from leastsquaresoptim_jl_torch import least_squares_problem

    m, n = 8192, 1024
    rng = np.random.default_rng(0)
    A = torch.tensor(rng.standard_normal((m, n)) / np.sqrt(n), dtype=dtype, device=dev)
    x_true = torch.tensor(np.abs(rng.standard_normal(n)) * 0.5, dtype=dtype, device=dev)
    y = torch.tanh(A @ x_true) + 0.01 * torch.tensor(
        rng.standard_normal(m), dtype=dtype, device=dev)

    def residual(x):
        return torch.tanh(A @ x) - y

    x0 = torch.full((n,), 0.6, dtype=dtype, device=dev)
    lower = torch.full((n,), 0.2, dtype=dtype, device=dev)
    return least_squares_problem(residual, x0, output_length=m), lower


def phase_single_fit(dev, smi):
    """Phase 8: the single-fit path (optimize / solve, Dogleg over QR and
    Cholesky, bounds) and config #3's J through the Gram kernel."""
    from leastsquaresoptim_jl_torch import Cholesky, Dogleg, Options, optimize, solve
    from leastsquaresoptim_jl_torch.ops import gram

    print("== phase 8a: Rosenbrock through optimize (Dogleg(QR()) by default), float64")
    gram.launches = 0

    def rosenbrock(x):
        return torch.stack([1.0 - x[0], 100.0 * (x[1] - x[0] ** 2)])

    r = optimize(rosenbrock, torch.zeros(2, dtype=torch.float64, device=dev))
    err = float(np.abs(r.minimizer - 1.0).max())
    print(f"  {r.optimizer}: converged {r.converged}, iterations {r.iterations}, "
          f"minimizer {r.minimizer.tolist()}, max |x - 1| {err:.3e}")
    check(r.converged and err <= 1e-6, "Rosenbrock converged within 1e-6 of [1, 1]")

    opts = Options(iterations=30, x_tol=0.0, f_tol=0.0, g_tol=0.0)
    out = {}
    for dt in (torch.float64, torch.float32):
        problem, lower = config3_problem(dev, dt)
        print(f"== phase 8b: config #3 bounded Dogleg(Cholesky()) (8192, 1024) {dt}")

        def run():
            return solve(problem, Dogleg(Cholesky()), lower=lower, options=opts)

        secs, raw = sync_time(run)
        x = raw["minimizer"]
        ssr = float(raw["ssr"])
        its = int(raw["iterations"])
        print(f"  iterations {its}, fresh linearizations {int(raw['g_calls'])}, "
              f"ssr {ssr!r}, min x {x.min().item()!r}, "
              f"{int((x <= lower).sum())} of 1024 on the bound, first call {secs:.3f} s")
        check(bool(torch.isfinite(x).all()) and x.shape == (1024,), f"{dt} finite (1024,)")
        check(bool((x >= lower).all()), f"{dt} every coordinate >= 0.2")
        out[dt] = (problem, raw, ssr, its, run)
    ssr64, ssr32 = out[torch.float64][2], out[torch.float32][2]
    rel_ssr = abs(ssr32 - ssr64) / ssr64
    print(f"  float32 ssr vs float64: relative difference {rel_ssr:.3e}")
    check(rel_ssr <= 1e-2, "float32 final ssr within 1% of float64")
    check(gram.launches == 0,
          f"the solvers' Gram stays plain: {gram.launches} Gram kernel launches in 8a-8b")

    _, _, _, its, run = out[torch.float32]
    reps = 3
    ts = [sync_time(run)[0] for _ in range(reps)]
    print(f"  Dogleg iterations/s (float32, {its} iterations): "
          f"{its / min(ts):.2f} (best of {reps}), {its / float(np.median(ts)):.2f} "
          f"(median) [{smi}]")

    print("== phase 8c: config #3's J at the final iterate through the Gram kernel")
    for dt in (torch.float32,):
        problem, raw = out[dt][0], out[dt][1]
        r, J = problem.res_jac_fn(raw["minimizer"])
        J = J.contiguous()
        G64, b64 = J.double().mT @ J.double(), J.double().mT @ r.double()
        Gk, bk = gram.gram_and_rhs(J, r, use_pallas=True)
        Gr, br = gram._gram_reference(J, r)
        ek, er = gram_errors(Gk, bk, G64, b64, r.double()), gram_errors(Gr, br, G64, b64, r.double())
        print(f"  {dt}: kernel G err {ek[0]:.3e}, J'r err {ek[1]:.3e}; plain G err "
              f"{er[0]:.3e}, J'r err {er[1]:.3e}")
        check(max(ek) <= GRAM_LIMIT and max(er) <= GRAM_LIMIT,
              f"{dt} kernel and plain within {GRAM_LIMIT:g} of float64")
        et = check_tf32_control(J, r, G64, b64, f"{dt}")
        check(max(et) > GRAM_LIMIT,
              f"{dt}: the TF32 control exceeds the limit {GRAM_LIMIT:g}")
        gram_times(J, r, smi, f"{dt} config #3's J (8192, 1024)")


if __name__ == "__main__":
    main()
