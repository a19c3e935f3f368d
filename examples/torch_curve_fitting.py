"""Curve fitting tour of the PyTorch port: basic, weighted, robust,
bounded, multistart, batched (the tour of examples/curve_fitting.py, at
its sizes, in float32 as that tour runs).

Run on one card:       python examples/torch_curve_fitting.py
Run on the CPU:        python examples/torch_curve_fitting.py --device cpu

The device is the one named: ``cuda`` (the default) fails without a card,
with no fallback to the CPU. ``main`` returns the batched sections'
converged shares and the minimizers of the single fits, so a run on the
card can be held against a run on the CPU.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import leastsquaresoptim_jl_torch as lt
from leastsquaresoptim_jl_torch.models import exp_sum_separable, gauss_sum_separable
from leastsquaresoptim_jl_torch.utils import covariance, standard_errors

F32 = torch.float32


def main(device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; pass --device cpu to run on the CPU")
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=F32, device=dev)  # noqa: E731
    out = {}
    rng = np.random.default_rng(0)
    x = torch.linspace(1.0, 80.0, 60, dtype=F32, device=dev)
    true = t([240.0, 5e-2])
    y_clean = true[0] * (1 - torch.exp(-true[1] * x))
    y = y_clean + t(rng.normal(0, 0.5, 60))

    # 1. basic fit with a named model + standard errors
    r = lt.curve_fit("exp_saturation", x, y, t([200.0, 1e-1]))
    print("basic:", r.minimizer, "+/-", standard_errors(r))
    out["basic"] = np.asarray(r.minimizer)

    # 2. robust fit shrugging off gross outliers
    y_bad = y.clone()
    y_bad[7], y_bad[33] = 5000.0, -3000.0
    r = lt.curve_fit("exp_saturation", x, y_bad, t([200.0, 1e-1]),
                     loss="soft_l1", f_scale=1.0)
    print("robust:", r.minimizer)
    out["robust"] = np.asarray(r.minimizer)

    # 3. bounded fit: scale pinned at its lower bound, rate still optimal
    # (in float32 it converges on x_tol)
    r = lt.curve_fit("exp_saturation", x, y, t([300.0, 1e-1]),
                     optimizer=lt.LevenbergMarquardt(), lower=t([260.0, 0.0]))
    print("bounded:", r.minimizer, "converged:", r.converged)
    out["bounded"] = np.asarray(r.minimizer)

    # 4. multistart for a hard basin
    starts = lt.latin_hypercube_starts(0, 32, t([1.0, 1e-3]), t([1000.0, 1.0]))
    best, _ = lt.optimize_multistart(
        lambda b, d: d[1] - b[0] * (1 - torch.exp(-b[1] * d[0])),
        starts, data=(x, y), output_length=60,
    )
    print("multistart:", best["minimizer"].cpu().numpy())
    out["multistart"] = best["minimizer"].cpu().numpy()

    # 5. 10k independent fits in one batched solve
    B = 10_000
    betas = torch.stack([torch.linspace(100.0, 400.0, B, device=dev),
                         torch.linspace(3e-2, 2e-1, B, device=dev)], dim=1)
    Y = betas[:, :1] * (1 - torch.exp(-betas[:, 1:] * x))
    raw = lt.curve_fit_batch("exp_saturation", x, Y, betas * 1.3)
    out["batched"] = raw["converged"].double().mean().item()
    print(f"batched: {B} fits, {100 * out['batched']:.1f}% converged")

    # 6. same fits with gridded transcendentals: the uniform sample grid
    # lets the exp-family models run 3 exps + power tables per evaluation
    # instead of m exps (ops/special.py)
    raw_g = lt.curve_fit_batch("exp_saturation", x, Y, betas * 1.3, gridded=True)
    # the two routes evaluate the same curve through different exp
    # formulations, so their minimizers agree to the convergence-criteria
    # band of float32, not bit for bit
    mg, mn = raw_g["minimizer"], raw["minimizer"]
    diff = ((mg - mn).abs() / mn.abs().clamp(min=1e-30)).max().item()
    out["gridded"] = raw_g["converged"].double().mean().item()
    print(f"gridded: minimizers agree to max rel diff {diff:.1e}")

    # 7. variable projection (VarPro): the amplitude is linear in the
    # model, so it is eliminated in closed form and the outer solve runs
    # on the rate alone: start the amplitude anywhere (here 1000x off)
    p0_bad = betas * t([1000.0, 1.3])
    raw_s = lt.curve_fit_batch("exp_saturation", x, Y, p0_bad, separable=True)
    out["varpro"] = raw_s["converged"].double().mean().item()
    agree_s = torch.allclose(raw_s["minimizer"], betas, rtol=1e-5)
    print(f"varpro: {100 * out['varpro']:.1f}% converged from 1000x-off amplitude "
          f"starts; minimizers match truth: {agree_s}")

    # 8. robust VarPro (IRLS around the linear-loss VarPro solve) with a
    # bound on the nonlinear rate: outliers down-weighted, amplitude still
    # closed-form, rate boxed
    y_out = y_clean.clone()
    y_out[5] += 90.0
    y_out[40] -= 60.0
    r = lt.curve_fit("exp_saturation", x, y_out, t([1.0, 1e-1]), separable=True,
                     loss="huber", f_scale=1.0, upper=t([np.inf, 1.0]))
    print("robust bounded varpro:", np.asarray(r.minimizer),
          "robust objective:", float(r.ssr))
    out["robust_varpro"] = np.asarray(r.minimizer)

    # full-parameter error bars for a VarPro fit: re-linearize the joint
    # model at the assembled minimizer (the result's own jacobian refers
    # to the reduced problem)
    rv = lt.curve_fit("exp_saturation", x, y, t([1.0, 1e-1]), separable=True)
    pj = lt.least_squares_problem(lambda b: b[0] * (1 - torch.exp(-b[1] * x)) - y,
                                  t(rv.minimizer))
    se = np.sqrt(np.diag(covariance(rv, problem=pj)))
    print("varpro full-parameter std errors:", se)

    # 8b. throughput mode for bulk fitting: the fused-ssr schedule (one
    # model evaluation per iteration; the (B, m) residual never rides the
    # loop carry, the ssr is carried as a two-float pair). Same fits; the
    # main path of bench.py.
    raw_ssr = lt.curve_fit_batch(
        "exp_saturation", x, Y, betas * 1.3,
        optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
        separable=True, gridded=True, fused="ssr", min_converged_fraction=0.99,
    )
    out["fused_ssr"] = raw_ssr["converged"].double().mean().item()
    print(f"fused-ssr throughput route: {100 * out['fused_ssr']:.1f}% converged")

    # 8c. start-free fitting: p0="auto" computes a closed-form start from
    # the data itself (models/init.py; Jacquelin's integral regression
    # recovers both exponential rates without any user input)
    xs0 = torch.linspace(0.0, 6.0, 64, dtype=F32, device=dev)
    ys0 = 2.5 * torch.exp(-0.5 * xs0) + 1.2 * torch.exp(-2.2 * xs0)
    r_a = lt.curve_fit("exp_sum_2", xs0, ys0, "auto", separable=True)
    print("auto-start exp_sum_2:", np.round(np.asarray(r_a.minimizer), 4),
          "converged:", r_a.converged)
    out["auto_exp_sum_2"] = np.asarray(r_a.minimizer)

    # 8d. start-free k-term families: exp_sum_separable(k <= 3) and
    # gauss_sum_separable(k) carry data-driven guess hooks, so p0="auto"
    # covers multi-exponential decays and multi-peak Gaussian sums too
    # (a synthetic well-posed 3-term sum: in float32 the NIST Lanczos3
    # valley is below float resolution)
    x3 = np.linspace(0.0, 6.0, 96)
    bt3 = np.array([3.0, 0.3, 2.0, 1.1, 1.0, 3.5])
    y3 = sum(bt3[2 * j] * np.exp(-bt3[2 * j + 1] * x3) for j in range(3))
    r3 = lt.curve_fit(exp_sum_separable(3), t(x3), t(y3), "auto", separable=True)
    rel3 = np.abs(np.asarray(r3.minimizer) - bt3) / np.abs(bt3)
    print(f"start-free 3-exp sum: max rel err {rel3.max():.1e}, "
          f"converged: {r3.converged}")
    out["auto_exp_sum_3"] = np.asarray(r3.minimizer)

    xg = np.linspace(0.0, 10.0, 128)
    yg = (3.0 * np.exp(-((xg - 2.5) ** 2) / (2 * 0.6**2))
          + 1.8 * np.exp(-((xg - 6.5) ** 2) / (2 * 0.9**2)))
    rg = lt.curve_fit(gauss_sum_separable(2), t(xg), t(yg), "auto", separable=True)
    print("start-free 2-peak Gaussian:", np.round(np.asarray(rg.minimizer), 3))
    out["auto_gauss_sum_2"] = np.asarray(rg.minimizer)

    # 9. geodesic acceleration: half the second-order correction added to
    # each LM step, fewer iterations on sloppy exponential sums (here a
    # 2-term sum with close rates; rates canonicalized ascending)
    xs = torch.linspace(0.0, 6.0, 48, dtype=F32, device=dev)
    ys = 2.5 * torch.exp(-0.5 * xs) + 1.2 * torch.exp(-1.1 * xs)
    p0 = t([1.0, 0.3, 1.0, 2.0])
    r_p = lt.curve_fit("exp_sum_2", xs, ys, p0, optimizer=lt.LevenbergMarquardt())
    r_g = lt.curve_fit("exp_sum_2", xs, ys, p0,
                       optimizer=lt.LevenbergMarquardt(geodesic=True))
    print(f"geodesic: {int(r_g.iterations)} iters vs plain "
          f"{int(r_p.iterations)}; converged: {r_g.converged}")
    out["geodesic"] = np.asarray(r_g.minimizer)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    main(parser.parse_args().device)
