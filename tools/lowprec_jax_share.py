"""The JAX package's converged share on the first fits of chip_smoke.py's
phase 14b data, on the CPU: the reference that 14b's bfloat16 run on the
card is held to.

    python tools/lowprec_jax_share.py [--fits 4096]

Runs the JAX package's ``curve_fit_batch(separable=True, gridded=True,
fused="ssr", LevenbergMarquardt(Cholesky()))`` with phase 14b's options
(50 iterations, radius 100, the dtype's derived tolerances, stop at 99%
done) in float32, bfloat16 and float16 on the first ``--fits`` fits of
``chip_smoke.lowprec_data(131072)`` and prints, per dtype, the converged
share and the median relative error against the truth. It imports JAX
(this tool measures the reference; chip_smoke.py does not).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import leastsquaresoptim_jl_tpu as lso  # noqa: E402
from leastsquaresoptim_jl_tpu.models import curve_fit_batch  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fits", type=int, default=4096)
    args = ap.parse_args()
    x, Y, P0, bt = chip_smoke.lowprec_data(chip_smoke.B_MAIN)
    Y, P0, bt = Y[:args.fits], P0[:args.fits], bt[:args.fits]
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16),
                     ("float16", jnp.float16)):
        r = curve_fit_batch(
            "exp_saturation", x, jnp.asarray(Y, dt), jnp.asarray(P0, dt),
            optimizer=lso.LevenbergMarquardt(lso.Cholesky()),
            options=lso.Options(iterations=chip_smoke.ITERATIONS,
                                radius=chip_smoke.RADIUS),
            min_converged_fraction=chip_smoke.FRAC, separable=True, gridded=True,
            fused="ssr")
        conv = float(np.asarray(r["converged"]).mean())
        est = np.asarray(r["minimizer"]).astype(np.float64)
        err = float(np.median(np.abs(est - bt) / bt))
        print(f"{name}: {args.fits} fits, converged {conv:.6f}, median rel error "
              f"vs truth {err:.3e}", flush=True)


if __name__ == "__main__":
    main()
