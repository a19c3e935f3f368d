"""Drive the PyTorch port's batched curve-fit path once on one NVIDIA GPU.

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
3. The main path: the bench.py workload (B = 131072 exp_saturation fits on
   a shared 64-point grid, float32, numpy default_rng(0), starts 0.7-1.4x
   the truth) through curve_fit_batch(separable=True, gridded=True,
   fused="ssr", LevenbergMarquardt(Cholesky()), min_converged_fraction=0.99).
   Limits: >= 99% converged; median relative error of the full minimizer
   against the truth <= 1e-4.
4. The kernel route: the same data through varpro_lm_p1_kernel_solve.
   Limits: kernel launched at least once in phases 3-4 (counter reset just
   before phase 3); >= 99% converged; median relative alpha difference
   from phase 3 <= 1e-5.
5. Times, after warm-up, with torch.cuda.synchronize() around each timed
   region: the routes of phases 3 and 4 and the plain reference route, and
   one K = 8 launch of the kernel against its plain version (CUDA events).

The second-to-last line is a JSON object describing each kernel; the last
is {"ok": true, "device": {...}}. The script needs one CUDA card and
imports nothing of JAX.
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
    t_kern, out = sync_time(run_kernel)
    main_launches = kv.launches
    conv_k = out["converged"].double().mean().item()
    d_alpha = rel(out["alpha"], raw["minimizer"][:, 1]).median().item()
    err_k = rel(out["alpha"], truth[:, 1]).median().item()
    print(f"  launches {main_launches}, converged {conv_k:.6f}, median alpha "
          f"rel diff from phase 3 {d_alpha:.3e}, median alpha rel error vs "
          f"truth {err_k:.3e}, first call {t_kern:.3f} s")
    check(main_launches > 0, "kernel launched on the main path")
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
    print(f"  one launch K={K}: kernel {ms_k:.4f} ms, plain version {ms_r:.4f} ms "
          f"(median of 20, CUDA events) [{smi}]")

    print(json.dumps({"kernels": [{
        "name": "kernel_varpro",
        "route": "cuda",
        "source": "leastsquaresoptim_jl_torch/csrc/kernel_varpro.cu",
        "replaces": "leastsquaresoptim_jl_tpu/ops/kernel_varpro.py:161",
        "launches": main_launches,
        "max_abs_err": max_abs,
        "ms": ms_k,
        "plain_ms": ms_r,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
