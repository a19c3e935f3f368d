"""Drive the PyTorch port on one NVIDIA GPU: the batched curve-fit path,
the Gram kernel and the row-sharded Gram, the single-fit dense path, the
matrix-free path (LSMR over Jacobian operators) at BASELINE.json config
#4's size, the reference's test problems (MINPACK, NIST StRD) with
batched Dogleg, bounded batches and multistart, the rest of curve
fitting (start-free multi-term fits, robust losses, single fits), the
structured-Jacobian path (BlockCholesky, sparse Jacobians by colored AD)
at configs #4 and #5's size, and the batched breadth (geodesic LM, LSMR
and reverse/central differences over batches), structured parameters,
checkpoints and the entry points, the low-precision axis (bfloat16
and float16 solves, the float16 instance of the fused kernel), and the
rest of the public surface (synthesize_jacobian, the examples).

    python3 chip_smoke.py

Phases (each prints its own lines, its header with the seconds since the
script started; any failure raises and exits non-zero):

1. Card and build: the card's name and power limit (nvidia-smi), and the
   time to build the CUDA kernels from leastsquaresoptim_jl_torch/csrc/
   (every nvcc at once).
2. The fused VarPro LM kernel against its plain PyTorch version on the
   card, for every basis it compiles (exp_saturation, power,
   michaelis_menten) at m = 64, 37 and 1024 (lanes_per_fit(m) lanes per
   fit), in float32 and float64: B = 4099 fits (so the last block of a
   launch holds 3 fits) from one numpy-made state, after one launch of
   K = 8 iterations, over a full solve (K = 8, stop at 99% done) and over
   a solve of one iteration per launch to 100% done (so that fits done
   before a launch share their warps with live ones). Limits: float64
   alpha and c within 1e-12 relative and iterations, flags and done equal
   on every fit; float32 median relative alpha difference <= 1e-6 and
   iterations/flags/done equal on >= 99% of fits, and on every fit of
   the last block alpha and c within 1e-6 and all equal. Then float16
   (the kernel's float16 instance) for every basis at the same m on O(1)
   data (x in [0.25, 4], coefficients ~ U(1, 3): amplitudes of 100-400
   overflow a float16 sum of squares) at float16's derived tolerances:
   every column of every fit's state, and every result of both solves,
   equal to the plain version's bit for bit.
2c. The fused p = 2 VarPro evaluation of gridded exponential sums
   (varpro_exp2_eval, ops/varpro_exp2.py) against its plain version on
   the card, at the benchmark's FLIM frame (B = 65536, m = 256) and at
   phase 11a's shape (B = 131072, m = 64): Gram, Jacobian and residual
   mode, one launch each, every output bit for bit the plain version's
   (built with -fmad=false), over batches that take every arm (QR, normal
   equations, dead) and hold non-finite rates; ptxas's 9 instances with
   no spill; the Gram-mode launch's time at the frame (mean of 20
   back-to-back launches between CUDA events), the plain version's, and
   the bound (Y read once at HBM bandwidth).
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
   one K = 8 launch of the kernel against its plain version. Every
   kernel_varpro time of the kernels line (here, 10f and 14c) is taken one
   way (``interleaved_ms``): each of the timed launches is warmed up for
   0.5 s, then all are timed in their order and in reverse (A, B, B, A),
   each a median of 20 launches between CUDA events (``launch_ms``: the
   launches queue behind about 10 ms of GPU sleep, so that the events
   time the kernel, not the host's launch path); its ms is the mean of
   its two medians.
5b. The lanes sweep: one K = 8 launch at the main path's shapes (B =
   131072, m = 64, float32) for G = 1, 2, 4, 8, 16, 32 lanes per fit:
   its time (median of 20, CUDA events, as phase 5), its agreement with
   the plain version at the same G (phase 2's float32 limits), its bound
   and share, and the registers and spills ptxas reported for that
   instance. G = 32 (a warp per fit) is the in-run baseline; the G that
   lanes_per_fit(64) picks must beat it.
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

9. The matrix-free path. No hand-written kernel lies on it (the JAX
   package has none there either): both kernels' counters are reset before
   9b and must read 0 after 9e.
   (a) LSMR alone (ops/lsmr_core.lsmr) against float64 torch.linalg.lstsq
   at (4096, 256) in float64 (atol = btol = 1e-12; x within 1e-8 relative)
   and float32 (1e-6; within 1e-4), undamped and with lam = 0.7; the
   damped system as a (residual, damp) tuple operator against the dense
   solve of (A'A + diag(damp)) x = A'b; solver/lsmr.solve_damped (btol =
   0.5, Jacobi preconditioner) against the same recurrences on the
   materialized preconditioned stack: equal iterations and istop, x within
   the dtype's limit, and a descent direction.
   (b) BASELINE.json config #4 at full size, the generator of
   benchmarks/bench_sparse_lsmr.py:40-72: n = 100000 parameters, blocks =
   10, m = 1000000 residuals, float32, LevenbergMarquardt(LSMR(maxiter=60)),
   10 iterations, tolerances 0, once with the Hutchinson column norms and
   once with the closed-form colnorms_fn; before it the closed form against
   AD column norms at blocks = 3, n = 200 (within 1e-4). Limits: finite,
   final ssr not above the start's, inner_istop in 1..7, mul_calls > 0, no
   Jacobian in the result, peak allocated memory under 1 GB. Prints outer
   LM iterations/s (host clock ending in torch.cuda.synchronize(), after a
   warm-up solve, best and median of 3), total matvecs, LSMR iterations
   ((mul_calls - 2 iterations) / 2: each outer iteration adds the
   gradient's and the predicted reduction's matvec) and LSMR iterations/s;
   then one torch.profiler pass over a solve of each: CUDA kernels, device
   ms, busy share, device-to-host copies (the host reads).
   (c) The same at blocks = 100 (m = 10000000) with colnorms_fn from the
   oscillatory start x0 + 0.1 (-1)^i, Options(iterations=100), float32
   default tolerances: converged, iterations, seconds, peak memory.
   (d) Geodesic LM on Rosenbrock, float64: converged within 1e-6 of [1, 1]
   in fewer iterations than plain LM, f_calls = 3 iterations + 1.
   (e) solve_sharded and make_sharded_operator on a one-rank NCCL group
   (m = 65536, n = 64, float32, tanh rows) against the unsharded solve of
   the same data: both converged, equal LM iterations, matvecs within one
   LSMR iteration per LM iteration, minimizers within 1e-5; and the
   Gauss-Newton LSMR step of the unsharded operator within 1e-5.

10. The reference's test problems and the batched breadth (BASELINE.json
   configs #1, #2 and #5's batch). The solves of 10a-10c and 10d's single
   fits are host-bound and independent, so they run in a pool of up to 8
   worker processes (spawned, each with its own CUDA context on card 0;
   10a-10c as one queue, longest first; every job's kernel counters must
   read 0).
   (a) The four MINPACK grids of tests/test_minpack.py in float64:
   full_suite x {Dogleg, LM} x {QR, LSMR} materialized; full_suite x
   {Dogleg(LSMR), LM(LSMR)} matrix-free; cholesky_suite x {Dogleg,
   LM}(Cholesky), converged; full_suite x {Dogleg, LM} with central
   differences, converged. Limit: every ssr <= 1e-3.
   (b) The NIST StRD scoreboard of tests/test_nist.py in float64 (16
   datasets x 2 certified starts through the x0 override, x_tol = 1e-50,
   f_tol = 1e-36, g_tol = 1e-50): Dogleg(QR) >= 30 and LM(QR) >= 31 of 32
   within 1e-3 of the certified solution, no NaN minimizer. (Until phase
   13 was added LM(Cholesky), config #2's solver, ran here too, printed
   without a limit: 40% of the pool's job seconds; its last reading was
   31 of 32.)
   (c) MGH09 and MGH10 from 64 Latin-hypercube starts over [min(s0, s1)/4,
   max(s0, s1)*4] through optimize_multistart (batched Dogleg(Cholesky())),
   float64: the best row converged within 1e-3 of the certified solution.
   (d) Batched Dogleg on phase 3's data (B = 131072, m = 64, float32):
   curve_fit_batch(separable, gridded, fused="ssr", Dogleg(Cholesky()))
   and solve_batch with no optimizer named on the two-parameter residual
   (grid shared), both stopping at 99% done: >= 99% converged, median
   relative error <= 1e-4, 0 launches of either kernel; times (best and
   median of 3 after a warm-up, host clock ending in a sync) and one
   profiler pass (kernels per lockstep iteration, device ms, busy share).
   Then the first 512 fits in float64 as one batch against the same fits
   solved one at a time by solve: equal iterations, counters and
   converged, the criteria equal where the final ssr is above 1e-20,
   minimizers within 1e-10.
   (e) The same data with a lower bound on b1 at the 30th percentile of
   the truth, curve_fit_batch(separable, gridded, fused="ssr") with
   LM(Cholesky()) and Dogleg(Cholesky()): every minimizer feasible, >= 99%
   converged, >= 99% of the fits whose true b1 is below the bound end at it
   (1e-6 relative) and >= 99% of the rest within 1e-4 of the truth; times
   and profiler pass as in (d).
   (f) power and michaelis_menten (phase 2's basis_data at B = 131072, m =
   64, float32) through curve_fit_batch(separable=True, LM(Cholesky()))
   and varpro_lm_p1_kernel_solve: 0 kernel launches on the first, >= 1 on
   the second, >= 99% converged on both, median relative alpha difference
   <= 1e-5; both routes' times; one K = 8 launch of each basis against its
   plain version (phase 2's float32 limits) with its time, bound and share
   (phase 5's method).

11. The rest of curve fitting (every route resets the three kernels'
   counters; kernel_varpro and the Gram must read 0 launches, and
   varpro_exp2_eval as many as 11a's float32 batch has lockstep
   iterations plus 2 (the seed and the final Jacobian) there and 0 on
   every other route; times, lockstep iterations, converged share and one
   profiler pass per route, as 10d):
   (a) start-free bi-exponential decays (FLIM-style; ``flim_data``, seed
   11, the truth ranges of tests/test_init.py::test_curve_fit_batch_auto,
   no noise) at B = 131072, m = 64 through curve_fit_batch("exp_sum_2",
   p0="auto", separable, gridded, fused="ssr", LM(Cholesky()), stop at 99%
   done) in float32 (>= 95% converged, median max relative error over the
   converged fits < 1e-3) and float64 (> 95%, < 1e-4); the first 1024 fits
   in float64 on the card against the CPU (minimizers within 1e-10
   relative and iterations equal on >= 99%).
   (b) start-free two-peak spectra (``peaks_data``, seed 12, m = 128)
   through curve_fit_batch("gauss_sum_2", "auto", separable, LM(Cholesky()))
   in float32: >= 95% converged, median error < 1e-3.
   (c) outlier-robust fits (phase 3's data, 1% noise, three outliers of
   +5-10 b0 per fit; ``outlier_data``, seed 13), float32: IRLS with huber
   (separable, gridded), the joint route with soft_l1, and the linear-loss
   control; each robust median error (a non-finite fit counts as infinite)
   < 0.02 and < 1/5 of the control's; the IRLS round count.
   (d) single fits in float64: Dogleg(QR)'s half of the NIST_SEPARABLE
   scoreboard of tests/test_separable.py at the first certified start (s0,
   the start of the allowed miss and of the rescue; s1 was cut when phase
   13 was added) in a spawned pool (only MGH09 s0 may miss; the MGH10 s0
   rescue must hold), start-free Lanczos3 within
   1e-3 of the certified solution, a weighted curve_fit of Misra1b and its
   covariance against numpy from the same J (1e-10), and polish of an 11a
   float32 fit within 1e-10 of the float64 fit.

12. The structured-Jacobian path, no kernel of its own (both kernels'
   counters are reset before 12a and must read 0 after 12e; float32
   unless stated; times on the host clock ending in a sync, after a
   warm-up).
   (a) The block-tridiagonal solves alone on random SPD systems (blocks as
   tests/test_block_cholesky.py makes them, numpy default_rng): nb = 50000
   at s = 2 by the SoA cyclic reduction (solve_block_tridiag_spd_soa, the
   route of config #4's Gram), nb = 4096 at s = 4 by the general cyclic
   reduction, nb = 256 at s = 3 by the blocked Cholesky ("scan"), in
   float64 and float32: relative residual ||A x - b|| / ||b|| (A applied
   blockwise in float64) below 1e-10 and 1e-4; ms per solve (CUDA events)
   and one profiler pass (CUDA kernels per solve); and at nb = 1024 the
   card's float64 answer within 1e-12 of the CPU's.
   (b) Config #4 (blocks = 10, m = 10^6, n = 10^5, closed-form column
   norms) from phase 9c's oscillatory start, default tolerances, to
   convergence by LM(BlockCholesky(2)) and by LM(LSMR(maxiter=60)):
   converged, LM iterations, matvecs, ssr, seconds (best and median of
   3), peak allocated memory, one profiler pass (CUDA kernels per LM
   iteration, busy share); the two minimizers within 1e-3.
   (c) The BlockCholesky route at blocks = 100 (m = 10^7): converged and
   finite, seconds, peak allocated memory under 4 GB.
   (d) Config #4 with a sparse J: sparse_jacobian over the residual's
   static pattern (row (b, i) touches columns i-1, i, i+1; nse about
   3*10^6), set-up and coloring seconds, 3 colors; J v against
   torch.func.jvp for 4 random v within 1e-5 relative; LM(LSMR(maxiter=60))
   for 10 iterations at tolerances 0 (iterations/s beside phase 9b's
   matrix-free route with closed-form column norms), then to convergence
   from (b)'s start: converged, within 1e-3 of (b)'s BlockCholesky
   minimizer, the result's J sparse with its pattern.
   (e) B = 2048 broyden_tridiagonal(256) fits (starts 0.8-1.2 x0),
   matrix-free, solve_batch(LM(BlockCholesky(2))): batch seconds (best and
   median of 3), fits/s, lockstep iterations, one profiler pass; every fit
   converged; the first 64 fits in float64 on the card within 1e-10 of the
   CPU's.

13. The batched breadth, checkpoints and the entry points, no kernel of
   their own (both kernels' counters are reset before 13a and must read 0
   after 13d; every route also reads 0 on its own; float32 unless stated;
   times, lockstep iterations and one profiler pass per route as 10d).
   (a) benchmarks/bench_geodesic.py:32-62's workload: B = 50000 exp_sum_2
   fits, m = 64, xd = linspace(0, 6, 64), truth [U(1,4), U(0.45,0.60),
   U(0.5,2.5), U(0.75,1.00)], starts 0.5-2x the truth (numpy
   default_rng(0)), 400 iterations, stop at 99% done, through
   curve_fit_batch with LM(Cholesky(), geodesic=False) and geodesic=True:
   converged share and median max relative error, every minimizer finite;
   the first 64 fits in float64 on the card against the CPU (equal per-fit
   iterations, minimizers within 1e-9 relative).
   (b) Phase 3's data through solve_batch(LM(LSMR()),
   materialize_jacobian=False, stop at 99% done): >= 99% converged, median
   relative error against the truth <= 1e-4, inner LSMR iterations per LM
   iteration; then 12e's B = 2048 broyden_tridiagonal(256) batch by
   LM(LSMR()) (hashed Hutchinson column norms at n = 256): every fit
   converged, minimizers within 1e-3 of LM(BlockCholesky(2))'s, and 64
   fits in float64 on the card against the CPU (equal iterations and
   mul_calls, minimizers within 1e-10).
   (c) Phase 3's joint route, solve_batch(LM(Cholesky()), stop at 99%
   done), with autodiff="forward", "reverse" and "central": each >= 99%
   converged, median relative error <= 1e-4.
   (d) float64: Misra1a from its first certified start with {"b1", "b2"}
   parameters against the flat vector (minimizer within 1e-12, counters
   equal); save_pytree after 3 Dogleg iterations, resume_x0 and finish
   (tests/test_api.py:131-160's scenario); a torch.distributed.checkpoint
   round trip of (b)'s (131072, 2) minimizer (exact); entry() on the card
   (output shapes, finite). (dryrun_multichip(1) runs in phase 15.)

14. Low precision (bfloat16, float16), both kernels' counters reset
   before 14a (which must launch neither).
   (a) tests/test_torch_lowprec.py's single fits on the card and on the
   CPU: the curve y = 2 (1 - exp(-x)) (64 points on [0.25, 4], start
   [1.5, 0.7]) by {LM, Dogleg} x {Cholesky, QR, LSMR} and Broyden's
   tridiagonal system at n = 16 and 100 by LM(QR()), LM(LSMR()) and
   Dogleg(LSMR()), each in bfloat16 and float16: converged on both,
   iterations within 2, minimizers within 4 x_tol; a bfloat16 fit
   polished in float64 within 1e-8 of the truth.
   (b) The curve-fit batch at the main path's size on O(1) data (B =
   131072, m = 64, x = linspace(0.25, 4, 64), b0 ~ U(1, 3), b1 ~ U(0.5,
   1.5), starts 0.7-1.4x, default_rng(0); 50 iterations, radius 100,
   the dtype's derived tolerances, stop at 99% done): the plain route
   (separable, gridded, fused="ssr", LM(Cholesky())) in float32,
   bfloat16 and float16, the kernel route in float32 and float16. Each
   route's counters are set to 0 before its first run and read after
   it; then best and median of 3 timed runs, fits/s, converged share,
   median relative error against the truth. Limits: float32 and float16
   >= 99% converged, bfloat16 >= BF16_JAX_SHARE (the JAX package's share
   on the CPU on the first 4096 fits, tools/lowprec_jax_share.py) less
   0.01; median error <= 1e-4 (float32), 1.6e-2 (bfloat16: 3x the JAX
   package's 5.313e-03) and 3.9e-3 (float16: 4 eps);
   the kernel route launches, the plain route does not.
   (c) One K = 8 launch at 14b's shapes in float16 against float32, both
   at float16's tolerances: float16 (csrc/kernel_varpro_f16.cuh, packed
   half, two fits to a __half2) bit for bit against its plain version;
   ms (phase 5's method, in the order float32, float16, the float16
   plain version, and back), bound (2-byte x, Y and state; operations at
   the card's peak outside the tensor cores for the type, float16 133.8
   TFLOP/s, float32 67) and share of each, the float16 bound's two terms,
   the binding one, and the operations term without contraction (each
   add and multiply its own instruction: twice the term), the float16 /
   float32 time ratio, the float16 plain version's ms, and ptxas's
   registers and spills of the float16 instances (none may spill at
   S <= 16).
   (d) Measurement only: float32 MGS QR (ops/linalg.mgs_solve_with_diag)
   against Householder (qr_solve_with_diag) at the stacked damped
   systems of fit batches (131072, 66, 2), (4096, 72, 8), (1024, 320,
   64), (64, 640, 128) and one (8192, 256): ms (one call after one
   warm-up, CUDA events) and the warm-up's error against a float64
   lstsq.
15. The rest of the public surface, no kernel of its own (both kernels'
   counters set to 0 at its start and read after 15c: both must read 0).
   First the entry point dryrun_multichip(1) on one NCCL rank, while a
   worker process makes the CPU runs of 15b and 15c (the parent only
   waits on the dryrun's process); 15a-15c run on the card after the
   worker has ended, so that its threads do not slow their timings.
   (a) problem.synthesize_jacobian in forward, reverse and central mode
   on config #3's residual (tanh(A x) - y, 8192 x 1024, phase 8b's
   problem) at x0, float64 and float32: ms per call (best and median of
   5 after a warm-up), and J on the card against J on the CPU, max
   |difference| / max |J| within JACOBIAN_LIMITS (forward and reverse
   1e-12 in float64 and 1e-5 in float32; central 2e-9 and 2e-3).
   (b) examples/torch_curve_fitting.py's main() on the card and on the
   CPU: the converged shares of its four 10000-fit batches within 1e-3
   of each other, the single fits' minimizers finite and within 1e-3
   relative.
   (c) examples/torch_distributed_solve.py's main() at world size 1, on
   the card over NCCL and on the CPU over gloo: converged on both, the
   minimizers within 1e-5 relative.

The second-to-last line is a JSON object describing each kernel (times
from phase 5 for kernel_varpro, at the lanes the rule picks, from phase
14c for its float16 instance (kernel_varpro_f16, launches from 14b's
float16 kernel route), from phase 6 at (2^20, 256) float32 for the
Gram, and from phase 2c for varpro_exp2_eval (launches from 11a's
float32 batch); bounds from this run's shapes and, for kernel_varpro, the
iterations its fits ran); the last is {"ok": true, "device": {...}}. The
script needs one CUDA card and imports nothing of JAX.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B_MAIN, M = 131_072, 64
TOLS = dict(x_tol=1e-6, f_tol=1e-6, g_tol=1e-5)
ITERATIONS, FRAC, RADIUS, K = 50, 0.99, 100.0, 8


# Per basis: the truth's alpha range (coefficients ~ U(100, 400)).
BASIS_ALPHA = {"exp_saturation": (1e-2, 6e-2), "power": (0.2, 0.8),
               "michaelis_menten": (5.0, 40.0)}
# The kernel's basis functors (csrc/kernel_varpro.cuh), by basis name.
BASIS_FUNCTOR = {"exp_saturation": "ExpSaturation", "power": "Power",
                 "michaelis_menten": "MichaelisMenten"}


def basis_data(basis, B, m, seed):
    """c phi(x, a) on a shared grid x in [1, 80]: grid, observations (f64),
    starts 0.7-1.4x the truth's alpha."""
    rng = np.random.default_rng(seed)
    x = np.linspace(1.0, 80.0, m)
    c = rng.uniform(100, 400, B)[:, None]
    a = rng.uniform(*BASIS_ALPHA[basis], B)
    if basis == "exp_saturation":
        phi = 1.0 - np.exp(-a[:, None] * x)
    elif basis == "power":
        phi = x ** a[:, None]
    else:
        phi = x / (a[:, None] + x)
    return x, c * phi, a * rng.uniform(0.7, 1.4, B)


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


_T0 = time.perf_counter()


def header(text):
    """Print a phase's header line with the seconds since the script
    started, so that each phase's share of the time limit can be read."""
    print(f"{text} (t = {time.perf_counter() - _T0:.1f} s)")


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
    header("== phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), device 0: {name}")
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({len(list(_build.SOURCE_DIR.glob('*.cu')))} nvcc started at once)")
    ptxas = ptxas_report(_build.build_log)
    varpro = {k: v for k, v in ptxas.items() if "varpro_lm_p1" in k}
    for name_, (regs, st, ld) in ptxas.items():
        if "varpro" not in name_:
            print(f"  ptxas: {name_}: {regs} registers, spill stores {st} B, loads {ld} B")
    print(f"  ptxas: {len(varpro)} kernel_varpro instances, "
          f"{sum(1 for v in varpro.values() if v[1])} with spills, registers "
          f"{min(v[0] for v in varpro.values())}-{max(v[0] for v in varpro.values())}")
    for name_, (regs, st, ld) in sorted(varpro.items()):
        if st:
            print(f"  ptxas: spills in {name_}: {regs} registers, spill stores "
                  f"{st} B, loads {ld} B")

    # -- phase 2: kernel against its plain version ------------------------
    phase_varpro_parity(dev)
    phase_varpro_parity_f16(dev)
    exp2_entry = phase_exp2(dev, smi, ptxas)

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
    header(f"== phase 3: curve_fit_batch on the card (B={B_MAIN}, m={M}, float32)")
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

    header("== phase 4: kernel route varpro_lm_p1_kernel_solve on the card")
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
    header(f"== phase 5: times (B={B_MAIN}, m={M}, float32) on {smi}")
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
    sk, sr = one_launch("exp_saturation", x, Y, state0, tols)
    cols = [kv._ALPHA, kv._C]
    max_abs = (sk[:, cols] - sr[:, cols]).abs().max().item()
    check_parity(f"one launch K={K} at B={B_MAIN}", state_parity(sk, sr),
                 torch.float32, kv.lanes_per_fit(M))
    print(f"  alpha/c max abs diff {max_abs:.3e}")

    ms, _ = interleaved_ms({
        "kernel": lambda: launch_ms(kv._launch_kernel, x, Y, state0, tols),
        "plain": lambda: launch_ms(kv._launch_reference, x, Y, state0, tols)})
    ms_k, ms_r = ms["kernel"], ms["plain"]
    fit_iters = int((sk[:, kv._ITERS] - state0[:, kv._ITERS]).sum().item())
    bound_k, bound_by_k = varpro_bound(B_MAIN, M, fit_iters, 4)
    print(f"  one launch K={K}, {kv.lanes_per_fit(M)} lanes per fit: kernel "
          f"{ms_k:.4f} ms, plain version {ms_r:.4f} ms ({INTERLEAVED}); bound "
          f"{bound_k:.4f} ms ({bound_by_k}; {fit_iters} fit-iterations), kernel at "
          f"{bound_k / ms_k:.1%} of it (at most 50% without FMA contraction); no single "
          f"library call computes it [{smi}]")
    phase_lanes_sweep(x, Y, state0, tols, ptxas, smi)

    gram_cmp = phase_gram(dev, smi)
    gram_launches = phase_sharded_gram(dev)
    phase_single_fit(dev, smi)
    phase_matrix_free(dev, smi)
    phase_reference_problems(dev, smi)
    exp2_entry["launches"] = phase_curve_fitting(dev, smi)
    phase_structured(dev, smi)
    phase_batched_breadth(dev, smi)
    f16_entry = phase_lowprec(dev, smi)
    phase_examples(dev, smi)

    print(json.dumps({"kernels": [{
        "name": "kernel_varpro",
        "route": "cuda",
        "source": "leastsquaresoptim_jl_torch/csrc/kernel_varpro.cuh",
        "replaces": "leastsquaresoptim_jl_tpu/ops/kernel_varpro.py:161",
        "launches": main_launches,
        "max_abs_err": max_abs,
        "ms": ms_k,
        "plain_ms": ms_r,
        "bound_ms": bound_k,
        "bound_by": bound_by_k,
        "library_ms": None,
    }, {
        "name": "kernel_varpro_f16",
        "route": "cuda",
        "source": "leastsquaresoptim_jl_torch/csrc/kernel_varpro_f16.cuh",
        "replaces": "leastsquaresoptim_jl_tpu/ops/kernel_varpro.py:161",
        **f16_entry,
    }, {
        "name": "gram",
        "route": "cuda",
        "source": "leastsquaresoptim_jl_torch/csrc/gram.cu",
        "replaces": "leastsquaresoptim_jl_tpu/ops/gram.py:71",
        "launches": gram_launches,
        **gram_cmp,
    }, {
        "name": "varpro_exp2_eval",
        "route": "cuda",
        "source": "leastsquaresoptim_jl_torch/csrc/varpro_exp2.cu",
        "replaces": None,
        **exp2_entry,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def one_launch(basis, x, Y, state0, tols, lanes=None):
    """One K-iteration launch of the kernel and of its plain version at
    ``lanes`` from ``state0``: (kernel state, plain state)."""
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    sk = kv._launch_kernel(basis, x, Y, state0.clone(), K, tols,
                           float(ITERATIONS), lanes=lanes)
    sr = kv._launch_reference(basis, x, Y, state0.clone(), K, tols,
                              float(ITERATIONS), lanes=lanes)
    torch.cuda.synchronize()
    return sk, sr


def rel_diff(a, b):
    """|a - b| / |b| per fit, 0 where the two are equal (NaNs included)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return torch.where(same, torch.zeros((), dtype=torch.float64, device=a.device),
                       rel(a, b))


def state_parity(sk, sr):
    """(alpha rel diffs, c rel diffs, per-fit equality of iterations, flags
    and done) of the kernel's and the plain version's (B, 8) states."""
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    same = ((sk[:, kv._ITERS] == sr[:, kv._ITERS])
            & (sk[:, kv._FLAGS] == sr[:, kv._FLAGS])
            & (sk[:, kv._DONE] == sr[:, kv._DONE]))
    return (rel_diff(sk[:, kv._ALPHA], sr[:, kv._ALPHA]),
            rel_diff(sk[:, kv._C], sr[:, kv._C]), same)


def solve_parity(ok_, or_):
    """state_parity of two solves' result dicts (every flag compared)."""
    same = ok_["iterations"] == or_["iterations"]
    for key in ("converged", "f_converged", "x_converged", "g_converged", "done"):
        same &= ok_[key] == or_[key]
    return (rel_diff(ok_["alpha"], or_["alpha"]),
            rel_diff(ok_["coefficient"], or_["coefficient"]), same)


# Kernel against its plain version. float64: alpha and c within 1e-12
# relative and every fit equal. float32: median alpha within 1e-6 and
# >= 99% of fits equal, and every fit of the launch's last block within
# 1e-6 and equal.
PARITY_LIMITS = {torch.float64: 1e-12, torch.float32: 1e-6}
F32_AGREEMENT = 0.99


def check_parity(what, parity, dt, lanes):
    """Print one comparison and hold it to PARITY_LIMITS; the last block is
    that of a launch at ``lanes`` lanes per fit and the default block."""
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    ra, rc, same = parity
    B = ra.shape[0]
    block_fits = kv._check_block_fits(None, lanes)
    tail = slice((B - 1) // block_fits * block_fits, B)
    lim = PARITY_LIMITS[dt]
    share = same.double().mean().item()
    tail_max = max(ra[tail].max().item(), rc[tail].max().item())
    print(f"  {what}: alpha rel max {ra.max().item():.3e} median "
          f"{ra.median().item():.3e}, c rel max {rc.max().item():.3e}, equal "
          f"{share:.6f}; last block ({B - tail.start} fits): alpha/c rel max "
          f"{tail_max:.3e}, equal {bool(same[tail].all())}")
    if dt == torch.float64:
        check(ra.max().item() <= lim and rc.max().item() <= lim and share == 1.0,
              f"{what}: every fit within {lim:g} and equal")
    else:
        check(ra.median().item() <= lim and share >= F32_AGREEMENT
              and tail_max <= lim and bool(same[tail].all()),
              f"{what}: median within {lim:g}, {F32_AGREEMENT} equal, the last "
              f"block within {lim:g} and equal")


def phase_varpro_parity(dev):
    """Phase 2: every basis at m = 64, 37, 1024 in float32 and float64,
    kernel against its plain version (one launch and two solves)."""
    from leastsquaresoptim_jl_torch.interop import kernel_state
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    header("== phase 2: kernel_varpro vs plain PyTorch version (B=4099)")
    tols = (TOLS["x_tol"], TOLS["f_tol"], TOLS["g_tol"])
    for basis in BASIS_ALPHA:
        for m in (64, 37, 1024):
            xd, Y_np, a0 = basis_data(basis, 4099, m, seed=1)
            lanes = kv.lanes_per_fit(m)
            for dt in PARITY_LIMITS:
                np_dt = np.float64 if dt == torch.float64 else np.float32
                x = torch.tensor(xd, dtype=dt, device=dev)
                Y = torch.tensor(Y_np, dtype=dt, device=dev)
                state0 = torch.tensor(kernel_state(a0, RADIUS, np_dt), device=dev)
                what = f"{basis} m={m} {dt} ({lanes} lanes)"
                check_parity(f"{what} one launch K={K}",
                             state_parity(*one_launch(basis, x, Y, state0, tols)),
                             dt, lanes)
                for k_iters, frac in ((K, FRAC), (1, 1.0)):
                    kw = dict(TOLS, iterations=ITERATIONS, min_converged_fraction=frac,
                              k_iters=k_iters, radius=RADIUS)
                    kv.launches = 0
                    ok_ = kv.varpro_lm_p1_kernel_solve(basis, x, Y, state0[:, kv._ALPHA], **kw)
                    n = kv.launches
                    or_ = kv.varpro_lm_p1_reference_solve(basis, x, Y, state0[:, kv._ALPHA], **kw)
                    conv = ok_["converged"].double().mean().item()
                    check_parity(f"{what} solve K={k_iters} to {frac:g} done ({n} "
                                 f"launches, converged {conv:.6f})",
                                 solve_parity(ok_, or_), dt, lanes)


# O(1) data for float16 (phases 2 and 14): x in [0.25, 4], since phase 2's
# amplitudes of 100-400 on [1, 80] overflow a float16 sum of squares. Per
# basis the truth's alpha range; coefficients ~ U(1, 3), starts 0.7-1.4x.
F16_ALPHA = {"exp_saturation": (0.5, 1.5), "power": (0.2, 0.8),
             "michaelis_menten": (0.5, 4.0)}


def lowprec_data(B, m=M, seed=0, basis="exp_saturation"):
    """c phi(x, a) on x = linspace(0.25, 4, m), c ~ U(1, 3), a ~ the basis's
    F16_ALPHA range: (x, Y, starts (B, 2), truth (B, 2)). 14b's data is
    the exp_saturation default (bench_data's recipe at O(1) scale)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.25, 4.0, m)
    bt = np.stack([rng.uniform(1, 3, B), rng.uniform(*F16_ALPHA[basis], B)], axis=1)
    a = bt[:, 1:2]
    if basis == "exp_saturation":
        phi = 1.0 - np.exp(-a * x)
    elif basis == "power":
        phi = x ** a
    else:
        phi = x / (a + x)
    return x, bt[:, :1] * phi, bt * rng.uniform(0.7, 1.4, size=(B, 2)), bt


def f16_tols():
    """The derived float16 tolerances (8, 8 and 80 eps) as a tuple."""
    from leastsquaresoptim_jl_torch import config

    return config.default_tolerances(torch.float16)


# float16: the kernel against its plain version, bit for bit: every column
# of every fit's state equal (every + - * / and sqrt is the correctly
# rounded half operation in both, exp and log are float32's expf and logf
# rounded to half in both).
def check_parity_f16(what, sk, sr):
    """Hold a float16 kernel state (or result dict) to the plain
    version's, every fit and column bit for bit (NaN equal to NaN)."""
    if isinstance(sk, dict):
        keys = ("alpha", "coefficient", "iterations", "converged", "f_converged",
                "x_converged", "g_converged", "done")
        cols = [(sk[k], sr[k]) for k in keys]
    else:
        cols = [(sk[:, j], sr[:, j]) for j in range(sk.shape[1])]
    unequal = torch.zeros_like(cols[0][0], dtype=torch.bool)
    for a, b in cols:
        same = a == b
        if a.is_floating_point():
            same |= torch.isnan(a) & torch.isnan(b)
        unequal |= ~same
    n = int(unequal.sum().item())
    print(f"  {what}: fits unequal {n} of {unequal.numel()}")
    check(n == 0, f"{what}: every fit bit for bit")


def phase_varpro_parity_f16(dev):
    """Phase 2, float16: every basis at m = 64, 37, 1024 on O(1) data,
    kernel against its plain version (one launch and two solves)."""
    from leastsquaresoptim_jl_torch.interop import kernel_state
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    tols = f16_tols()
    header(f"== phase 2 (float16): kernel_varpro vs plain version (B=4099, O(1) data, "
          f"tolerances {tols})")
    for basis in BASIS_ALPHA:
        for m in (64, 37, 1024):
            xd, Y_np, P0_np, _ = lowprec_data(4099, m, seed=1, basis=basis)
            a0 = P0_np[:, 1]
            x = torch.tensor(xd, dtype=torch.float16, device=dev)
            Y = torch.tensor(Y_np, dtype=torch.float16, device=dev)
            state0 = torch.tensor(kernel_state(a0, RADIUS, np.float16), device=dev)
            what = f"{basis} m={m} float16 ({kv.lanes_per_fit(m)} lanes)"
            check_parity_f16(f"{what} one launch K={K}", *one_launch(basis, x, Y, state0, tols))
            for k_iters, frac in ((K, FRAC), (1, 1.0)):
                kw = dict(zip(("x_tol", "f_tol", "g_tol"), tols), iterations=ITERATIONS,
                          min_converged_fraction=frac, k_iters=k_iters, radius=RADIUS)
                kv.launches = 0
                ok_ = kv.varpro_lm_p1_kernel_solve(basis, x, Y, state0[:, kv._ALPHA], **kw)
                n = kv.launches
                or_ = kv.varpro_lm_p1_reference_solve(basis, x, Y, state0[:, kv._ALPHA], **kw)
                conv = ok_["converged"].double().mean().item()
                check_parity_f16(f"{what} solve K={k_iters} to {frac:g} done ({n} launches, "
                                 f"converged {conv:.6f})", ok_, or_)


# Phase 2c's shapes: (B, m, t0, dt) of the benchmark's FLIM frame
# (flim_biexp: 65536 pixels x 256 channels over 12.5 ns) and of phase
# 11a's start-free batch (linspace(0, 6, 64)).
EXP2_SHAPES = ((65_536, 256, 0.0, 12.5 / 256), (B_MAIN, M, 0.0, 6.0 / 63))
# Rates of the six hard fits that close each phase 2c batch: near-equal
# and equal (normal equations), a basis that underflows (dead), NaN and
# infinite rates.
EXP2_HARD = [[1.0, 1.0 + 1e-7], [1.0, 1.0], [300.0, 450.0], [np.nan, 1.0],
             [np.inf, 1.0], [-np.inf, 1.0]]


def exp2_data(B, m, t0, dt, dev, seed):
    """B two-term decays on x_i = t0 + i dt (amplitudes U(100, 1000), rates
    U(0.25, 0.7) and U(1.6, 3.4)), started 0.7-1.3x their rates; the last
    six fits take EXP2_HARD's rates. Y and alpha in float32 on ``dev``."""
    rng = np.random.default_rng(seed)
    x = t0 + dt * np.arange(m)
    k = np.stack([rng.uniform(0.25, 0.7, B), rng.uniform(1.6, 3.4, B)], 1)
    amp = rng.uniform(100.0, 1000.0, (B, 2))
    Y = amp[:, :1] * np.exp(-k[:, :1] * x) + amp[:, 1:] * np.exp(-k[:, 1:] * x)
    alpha = k * rng.uniform(0.7, 1.3, (B, 2))
    alpha[-len(EXP2_HARD):] = EXP2_HARD
    return (torch.tensor(Y, dtype=torch.float32, device=dev),
            torch.tensor(alpha, dtype=torch.float32, device=dev))


def same_bits(a, b):
    """Equal bit for bit, a NaN matching any NaN."""
    same = a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32)
    return a.shape == b.shape and bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def phase_exp2(dev, smi, ptxas):
    """Phase 2c: varpro_exp2_eval against its plain version on the card,
    Gram and Jacobian mode, at EXP2_SHAPES; ptxas's registers and spills;
    the Gram-mode launch's time, the plain version's, and the bound.
    Returns the kernel's entry of the kernels line (launches filled in by
    the caller)."""
    from leastsquaresoptim_jl_torch.ops import varpro_exp2 as ve

    header("== phase 2c: varpro_exp2_eval vs its plain version on the card, float32")
    inst = {k: v for k, v in ptxas.items() if "varpro_exp2_eval" in k}
    for name_, (regs, st, ld) in sorted(inst.items()):
        print(f"  ptxas: {name_}: {regs} registers, spill stores {st} B, loads {ld} B")
    check(len(inst) == 9 and not any(v[1] or v[2] for v in inst.values()),
          "varpro_exp2_eval: 9 instances (NV 1, 2, 4 x 3 modes), none spills")
    out = None
    for B, m, t0, dt in EXP2_SHAPES:
        Y, alpha = exp2_data(B, m, t0, dt, dev, seed=m)
        ve.launches = 0
        got = (*ve.evaluate_gram(Y, alpha, t0, dt), *ve.evaluate_jacobian(Y, alpha, t0, dt),
               ve.evaluate_jacobian(Y, alpha, t0, dt, jacobian=False))
        torch.cuda.synchronize()
        n = ve.launches
        G0, b0, hi0, lo0, arm = ve._gram_plain(Y, alpha, t0, dt)
        r0, J0, arm_j = ve._jacobian_plain(Y, alpha, t0, dt)
        want = (G0, b0, hi0, lo0, r0, J0, r0)
        names = ("J'J", "J'r", "ssr_hi", "ssr_lo", "r", "J", "r (residual mode)")
        diff = [nm for nm, g, w in zip(names, got, want) if not same_bits(g, w)]
        arms = {a: int((arm == a).sum()) for a in (ve.DEAD, ve.QR, ve.NORMAL)}
        print(f"  B={B}, m={m}, layout {ve.layout(m)}: {n} launches; arms (dead, QR, normal) "
              f"{tuple(arms.values())}; outputs that differ from the plain version's bits: "
              f"{diff or 'none'}")
        check(n == 3, f"phase 2c B={B} m={m}: one launch a call")
        check(not diff and torch.equal(arm, arm_j) and min(arms.values()) > 0,
              f"phase 2c B={B} m={m}: every arm taken, every output bit for bit the plain version's")
        if out is None:
            buf = torch.empty((B, 8), dtype=torch.float32, device=dev)
            ms = loop_ms(lambda: ve._launch_kernel(Y, alpha, t0, dt, out=buf))
            plain_ms = loop_ms(lambda: ve._gram_plain(Y, alpha, t0, dt), n=5, warmup=1)
            bound = B * m * 4 / HBM_BYTES_PER_MS
            print(f"  Gram mode at B={B}, m={m}: kernel {ms:.4f} ms, plain version "
                  f"{plain_ms:.4f} ms (mean of back-to-back calls between CUDA events); "
                  f"bound {bound:.4f} ms (bytes: Y read once), kernel at {bound / ms:.1%} of "
                  f"it; no single PyTorch call computes it [{smi}]")
            out = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": "bytes", "library_ms": None}
        del Y, alpha, got, want
        torch.cuda.empty_cache()
    return out


# GPU cycles (about 10 ms) that launch_ms's launches queue behind. Without
# them the card drains its queue between launches, and a pair of events
# times the host's launch path (about 0.08 ms of Python a launch, as long
# as one float16 launch) instead of the kernel.
QUEUE_CYCLES = 20_000_000


def launch_ms(launch, x, Y, state0, tols, n=20, lanes=None, basis="exp_saturation"):
    """Median of ``n`` single K-iteration launches from ``state0``, each
    between its own CUDA events, all enqueued behind QUEUE_CYCLES of GPU
    sleep."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(QUEUE_CYCLES)
    for i in range(n):
        st = state0.clone()
        starts[i].record()
        launch(basis, x, Y, st, K, tols, float(ITERATIONS), lanes=lanes)
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


# The warm-up of each timer of ``interleaved_ms``, seconds: 20 launches of
# a kernel take about 2 ms, too little to bring a card that was idle back
# to its clocks.
WARM_UP_S = 0.5


INTERLEAVED = (f"after a {WARM_UP_S} s warm-up of each, the mean of two medians of 20 "
               f"launches queued behind a GPU sleep, CUDA events, timed in order and in "
               f"reverse")


def interleaved_ms(timers):
    """The times of kernel_varpro's launches, one method for every row of
    the kernels line: each of ``timers`` (name -> a call returning one
    ``launch_ms`` median) is warmed up for WARM_UP_S, then all are timed in
    their order and again in reverse (A, B, B, A). Returns name -> ms, the
    mean of its two medians, and name -> the two medians."""
    for fn in timers.values():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WARM_UP_S:
            fn()
    reads = {k: [] for k in timers}
    for k in [*timers, *reversed(timers)]:
        reads[k].append(timers[k]())
    return {k: float(np.mean(v)) for k, v in reads.items()}, reads


def ptxas_report(log):
    """{entry function: (registers, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v output."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            name, spills = hit.group(1), (0, 0)
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if hit:
            spills = (int(hit.group(1)), int(hit.group(2)))
            continue
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            out[name] = (int(hit.group(1)), *spills)
            name = None
    return out


def varpro_instance(ptxas, dtype, basis, lanes, m):
    """ptxas's (registers, spill stores, spill loads) of the kernel_varpro
    instance that a launch at ``lanes`` and m samples runs, and its run S."""
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    S = kv._run(m, lanes)
    kernel = {torch.float16: "varpro_lm_p1_f16_kernelI", torch.float32: "varpro_lm_p1_kernelIf",
              torch.float64: "varpro_lm_p1_kernelId"}[dtype]
    pattern = re.compile(rf"{kernel}Li{lanes}ELi{S}ENS_\d+{BASIS_FUNCTOR[basis]}E")
    hits = [v for k, v in ptxas.items() if pattern.search(k)]
    return S, (hits[0] if len(hits) == 1 else None)


def phase_lanes_sweep(x, Y, state0, tols, ptxas, smi):
    """Phase 5b: one K = 8 launch at the main path's shapes for every G."""
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    B, m = Y.shape
    header(f"== phase 5b: lanes per fit at B={B}, m={m}, float32, one K={K} launch")
    ms = {}
    for lanes in (1, 2, 4, 8, 16, 32):
        sk, sr = one_launch("exp_saturation", x, Y, state0, tols, lanes)
        check_parity(f"G={lanes} against the plain version at G={lanes}",
                     state_parity(sk, sr), torch.float32, lanes)
        launch_ms(kv._launch_kernel, x, Y, state0, tols, 3, lanes)  # warm-up
        ms[lanes] = launch_ms(kv._launch_kernel, x, Y, state0, tols, 20, lanes)
        its = sk[:, kv._ITERS] - state0[:, kv._ITERS]
        fit_iters = int(its.sum().item())
        # A warp iterates until its slowest fit is done.
        per_warp = 32 // lanes
        warp_its = torch.cat([its, its.new_zeros((-B) % per_warp)]).view(-1, per_warp)
        warp_fit_iters = int(warp_its.max(dim=1).values.sum().item()) * per_warp
        bound, bound_by = varpro_bound(B, m, fit_iters, 4)
        S, rep_ = varpro_instance(ptxas, torch.float32, "exp_saturation", lanes, m)
        regs = ("not found" if rep_ is None else
                f"{rep_[0]} registers, spill stores {rep_[1]} B, loads {rep_[2]} B")
        print(f"  G={lanes:2d} ({32 // lanes} fits per warp, {-(-m // lanes)} samples "
              f"per lane, run S={S}): {ms[lanes]:.4f} ms (median of 20, CUDA events); "
              f"{fit_iters} fit-iterations, "
              f"{warp_fit_iters} run by the warps; bound {bound:.4f} ms "
              f"({bound_by}), share {bound / ms[lanes]:.1%}; ptxas: {regs} [{smi}]")
    chosen = kv.lanes_per_fit(m)
    check(ms[chosen] < ms[32], f"the rule's G={chosen} ({ms[chosen]:.4f} ms) is faster "
          f"than a warp per fit, G=32 ({ms[32]:.4f} ms)")


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


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W);
# "fp16" is half precision outside the tensor cores, twice float32's rate
# (NVIDIA's Hopper architecture whitepaper, H100 SXM5: 133.8 TFLOP/s).
HBM_BYTES_PER_MS = 3.35e9
PEAK_FLOPS_PER_MS = {"tf32": 495e9, "bf16": 989e9, "fp32": 67e9, "fp16": 133.8e9}
# Operations of one p = 1 VarPro LM iteration per sample, counted from
# ops/kernel_varpro.py::_iteration_reference: two evaluations of the
# model and its projection (exp_saturation: a multiply, exp, subtract and
# multiply for the basis; P.P, q = P / R, q.y, r = y - z q: 9 FLOPs, 1
# exp, 1 division each), then r.r, P.dP, dP.y, the Jacobian (3), J.J, J.r
# and the actual reduction (4): 17 FLOPs. exp and division count one each;
# the per-fit scalar work (about 50 operations per fit) is left out. power
# evaluates exp(a u) and phi u (2 FLOPs and an exp, log x is taken once per
# launch); michaelis_menten 1 / (a + u), u inv and -(phi inv) (4 FLOPs and
# a division).
VARPRO_OPS_PER_SAMPLE_ITERATION = {
    "exp_saturation": 2 * (9 + 1 + 1) + 17,
    "power": 2 * (8 + 1 + 1) + 17,
    "michaelis_menten": 2 * (10 + 2) + 17,
}


def bound_of(t_bytes, t_ops):
    """(least ms, binding term) of a bytes term and an operations term,
    each in ms: whichever is larger."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gram_bound(m, n, dtype):
    """The Gram's bound: J and y read once and G, J'y written once (in J's
    dtype) over HBM bandwidth; the m n (n + 1) FLOPs of the upper triangle
    with its diagonal at the tensor-core rate for J's type."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (m * n + m + n * n + n) * size
    peak = "bf16" if dtype == torch.bfloat16 else "tf32"
    return bound_of(nbytes / HBM_BYTES_PER_MS, m * n * (n + 1) / PEAK_FLOPS_PER_MS[peak])


def varpro_terms(B, m, fit_iterations, size, basis="exp_saturation"):
    """kernel_varpro's two terms for one launch of ``size``-byte elements,
    in ms: Y and x read once and the (B, 8) state read and written once,
    over HBM bandwidth; the operations of the fit-iterations the launch
    ran, at the card's peak outside the tensor cores for the elements'
    type (float32 67, float16 133.8 TFLOP/s)."""
    nbytes = (B * m + m + 2 * B * 8) * size
    ops = fit_iterations * m * VARPRO_OPS_PER_SAMPLE_ITERATION[basis]
    return (nbytes / HBM_BYTES_PER_MS,
            ops / PEAK_FLOPS_PER_MS["fp16" if size == 2 else "fp32"])


def varpro_bound(B, m, fit_iterations, size, basis="exp_saturation"):
    """kernel_varpro's bound for one launch: (least ms, binding term) of
    ``varpro_terms``."""
    return bound_of(*varpro_terms(B, m, fit_iterations, size, basis))


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

    header("== phase 6: Gram kernel vs plain version vs float64 on the card")
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
    header(f"== phase 7: sharded_gram_and_rhs on a one-rank NCCL group ({m}, {n}) float32")
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

    header("== phase 8a: Rosenbrock through optimize (Dogleg(QR()) by default), float64")
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
        header(f"== phase 8b: config #3 bounded Dogleg(Cholesky()) (8192, 1024) {dt}")

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

    header("== phase 8c: config #3's J at the final iterate through the Gram kernel")
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


# -- phase 9: the matrix-free path ------------------------------------------

# Relative error limits of an LSMR solution against float64 lstsq, at the
# tolerances atol = btol phase 9a runs each dtype with.
LSMR_TOLS = {torch.float64: (1e-12, 1e-8), torch.float32: (1e-6, 1e-4)}


def rel_err(x, ref):
    return (torch.linalg.vector_norm(x.double() - ref)
            / torch.linalg.vector_norm(ref)).item()


def phase_lsmr(dev):
    """Phase 9a: LSMR alone against dense float64 solves."""
    from leastsquaresoptim_jl_torch import config
    from leastsquaresoptim_jl_torch.ops import operators
    from leastsquaresoptim_jl_torch.ops.lsmr_core import lsmr
    from leastsquaresoptim_jl_torch.solver import lsmr as lsmr_solver

    m, n, lam = 4096, 256, 0.7
    header(f"== phase 9a: LSMR against float64 lstsq at ({m}, {n})")
    rng = np.random.default_rng(9)
    A64 = torch.tensor(rng.standard_normal((m, n)), device=dev)
    b64 = torch.tensor(rng.standard_normal(m), device=dev)
    damp64 = torch.tensor(np.linspace(0.5, 2.0, n), device=dev)
    gram = A64.mT @ A64
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    refs = {
        "undamped": torch.linalg.lstsq(A64, b64.unsqueeze(-1)).solution.squeeze(-1),
        "lam": torch.linalg.solve(gram + lam**2 * eye, A64.mT @ b64),
        "damp": torch.linalg.solve(gram + torch.diag(damp64), A64.mT @ b64),
    }
    for dt, (tol, limit) in LSMR_TOLS.items():
        A, b, damp = A64.to(dt), b64.to(dt), damp64.to(dt)
        x0 = torch.zeros(n, dtype=dt, device=dev)
        kw = dict(maxiter=4 * n, atol=tol, btol=tol)
        for what, extra in (("undamped", {}), ("lam", dict(lam=lam))):
            x, st = lsmr(lambda v: A @ v, lambda u: A.mT @ u, b, x0, **kw, **extra)
            err = rel_err(x, refs[what])
            print(f"  {dt} {what}: {st.iterations} iterations, istop {st.istop}, "
                  f"relative error {err:.3e}")
            check(st.converged and st.mvps == 2 * st.iterations and err <= limit,
                  f"{dt} {what} LSMR converged within {limit:g} of the dense solve")
        sd = torch.sqrt(damp)
        x, st = lsmr(lambda v: (A @ v, sd * v), lambda u: A.mT @ u[0] + sd * u[1],
                     (b, torch.zeros_like(x0)), x0, **kw)
        err = rel_err(x, refs["damp"])
        print(f"  {dt} (residual, damp) tuple operator: {st.iterations} iterations, "
              f"istop {st.istop}, relative error {err:.3e}")
        check(st.converged and err <= limit,
              f"{dt} tuple-range LSMR within {limit:g} of the dense damped solve")
        # solve_damped against its own system, materialized: the stack
        # [A P; diag(sqrt(damp)) P] with P the Jacobi preconditioner.
        op = operators.from_matrix(A)
        dx, st = lsmr_solver.solve_damped(op, b, damp)
        p = 1.0 / torch.sqrt(op.colnorms2() + damp)
        stacked = torch.cat([A * p, torch.diag(sd * p)])
        xs, ss = lsmr(lambda v: stacked @ v, lambda u: stacked.mT @ u,
                      torch.cat([b, torch.zeros_like(x0)]), x0, maxiter=m + n,
                      atol=config.LSMR_ATOL, btol=config.LSMR_DAMPED_BTOL)
        err = rel_err(dx, (p * xs).double())
        cos = (torch.dot(dx.double(), refs["damp"])
               / torch.linalg.vector_norm(dx.double())
               / torch.linalg.vector_norm(refs["damp"])).item()
        print(f"  {dt} solve_damped: {st.iterations} iterations, istop {st.istop} "
              f"(stacked: {ss.iterations}, {ss.istop}), relative difference "
              f"{err:.3e}, cosine to the exact damped step {cos:.4f}")
        check((st.iterations, st.istop) == (ss.iterations, ss.istop) and err <= limit
              and cos > 0,
              f"{dt} solve_damped equals LSMR on the stacked system within {limit:g}")


def banded_problem(blocks, n, dtype, dev):
    """The banded boundary-value system of BASELINE.json configs #4 and #5
    (benchmarks/bench_sparse_lsmr.py:40-72): residual (b, i) couples
    x[i-1], x[i], x[i+1] plus a cubic source, over ``blocks`` shifted
    observation blocks. Returns (residual_fn, colnorms_fn, x0)."""
    h = 1.0 / (n + 1)
    t = torch.arange(1, n + 1, dtype=dtype, device=dev) * h
    shifts = torch.linspace(0.5, 1.5, blocks, dtype=dtype, device=dev)

    def residual_fn(x):
        zero = x.new_zeros(1)
        xm = torch.cat([zero, x[:-1]])
        xp = torch.cat([x[1:], zero])
        core = 2.0 * x - xm - xp
        src = (x[None, :] + t[None, :] * shifts[:, None] + 1.0) ** 3
        return (core[None, :] + (h * h / 2.0) * src).reshape(-1)

    def colnorms_fn(x):
        # diag(J'J) in closed form: row (b, i) has 2 + (3h^2/2)(x_i + t_i
        # s_b + 1)^2 at column i and -1 at columns i-1 and i+1.
        c = (3.0 * h * h / 2.0) * (x[None, :] + t[None, :] * shifts[:, None] + 1.0) ** 2
        diag = torch.sum((2.0 + c) ** 2, dim=0)
        nb = torch.full_like(x, 2.0 * blocks)
        nb[0] -= float(blocks)
        nb[-1] -= float(blocks)
        return diag + nb

    return residual_fn, colnorms_fn, t * (t - 1.0)


CONFIG4_N = 100_000  # parameters of configs #4 and #5


def config4_problem(blocks, dev, exact_colnorms):
    from leastsquaresoptim_jl_torch import least_squares_problem, matrix_free_problem

    n = CONFIG4_N
    residual_fn, colnorms_fn, x0 = banded_problem(blocks, n, torch.float32, dev)
    if exact_colnorms:
        problem = matrix_free_problem(residual_fn, x0, output_length=blocks * n,
                                      colnorms=colnorms_fn)
    else:
        problem = least_squares_problem(residual_fn, x0, output_length=blocks * n,
                                        materialize_jacobian=False)
    return problem, residual_fn


def profile_solve(run, what, smi):
    """One torch.profiler pass over ``run()``: CUDA kernels, device ms,
    busy share (device ms over the wall time of the profiled call) and
    device-to-host copies (each a host read). Returns the kernel count
    (None when the profiler saw no device events). It records device
    activity only: recording every CPU operator too lengthens a host-bound
    solve (by up to 46% on an H100 host), which lowers its busy share, and
    takes seconds a pass to process."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        secs, _ = sync_time(run)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"  {what}: the profiler recorded no device events: not measured")
        return None
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    dtoh = sum(1 for e in kernels if "Memcpy DtoH" in e.name)
    launches = sum(1 for e in kernels if "Memcpy" not in e.name and "Memset" not in e.name)
    print(f"  {what} (profiled solve, {secs * 1e3:.1f} ms with the profiler on): "
          f"{launches} CUDA kernels, {device_ms:.3f} ms of device time, busy share "
          f"{device_ms / (secs * 1e3):.4f}, {dtoh} device-to-host copies [{smi}]")
    return launches


def phase_config4(dev, smi):
    """Phases 9b and 9c: configs #4 (m = 1M) and #5's scale (m = 10M)."""
    from leastsquaresoptim_jl_torch import LSMR, LevenbergMarquardt, Options, solve

    header("== phase 9b: closed-form column norms against AD at blocks=3, n=200")
    residual_fn, colnorms_fn, x0 = banded_problem(3, 200, torch.float32, dev)
    J = torch.func.jacfwd(residual_fn)(x0 + 0.3)
    ad = torch.sum(J * J, dim=0)
    err = ((ad - colnorms_fn(x0 + 0.3)).abs() / ad.clamp(min=1e-30)).max().item()
    print(f"  largest relative difference {err:.3e}")
    check(err < 1e-4, "the closed-form column norms equal AD's within 1e-4")

    optimizer = LevenbergMarquardt(LSMR(maxiter=60))
    opts = Options(iterations=10, x_tol=0.0, f_tol=0.0, g_tol=0.0)
    reps = 3
    for exact in (False, True):
        label = "closed-form colnorms_fn" if exact else "Hutchinson column norms"
        problem, residual_fn = config4_problem(10, dev, exact)
        x0 = problem.x0
        header(f"== phase 9b: config #4, m={problem.m}, n={problem.n}, float32, "
              f"LM(LSMR(maxiter=60)), 10 iterations, {label}")
        ssr0 = torch.sum(residual_fn(x0) ** 2).item()

        def run(x=x0):
            return solve(problem, optimizer, options=opts, x0=x)

        run()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        timed = [sync_time(lambda i=i: run(x0 * (1.0 + 1e-6 * (i + 1))))
                 for i in range(reps)]
        peak = torch.cuda.max_memory_allocated()
        ts = [t for t, _ in timed]
        raw = timed[-1][1]
        its, mvps = int(raw["iterations"]), int(raw["mul_calls"])
        istop, ssr = int(raw["inner_istop"]), float(raw["ssr"])
        lsmr_its = (mvps - 2 * its) // 2
        best, med = min(ts), float(np.median(ts))
        print(f"  {its} LM iterations, {mvps} matvecs, {lsmr_its} LSMR iterations, "
              f"inner_istop {istop}, ssr {ssr0!r} -> {ssr!r}; peak allocated "
              f"{peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB held before) [{smi}]")
        CONFIG4_RATES[label] = its / best
        print(f"  LM iterations/s {its / best:.3f} (best of {reps}), "
              f"{its / med:.3f} (median); LSMR iterations/s {lsmr_its / best:.1f} "
              f"(best), {lsmr_its / med:.1f} (median); solve {best:.4f} s best, "
              f"{med:.4f} s median [{smi}]")
        check(bool(torch.isfinite(raw["minimizer"]).all())
              and raw["minimizer"].shape == (problem.n,) and np.isfinite(ssr),
              f"{label}: finite ({problem.n},) minimizer")
        check(ssr <= ssr0, f"{label}: final ssr not above the start's")
        check(1 <= istop <= 7 and mvps > 0, f"{label}: inner_istop in 1..7, matvecs counted")
        check(raw["jacobian"] is None, f"{label}: no Jacobian was formed")
        check(peak < 1e9, f"{label}: peak allocated memory under 1 GB")
        profile_solve(run, label, smi)

    problem, residual_fn = config4_problem(100, dev, True)
    header(f"== phase 9c: m={problem.m}, n={problem.n}, float32, closed-form "
          "colnorms_fn, to convergence from the oscillatory start")
    sign = torch.where(torch.arange(problem.n, device=dev) % 2 == 0, 1.0, -1.0)
    x0c = problem.x0 + 0.1 * sign
    conv_opts = Options(iterations=100)
    torch.cuda.reset_peak_memory_stats()
    for attempt in ("first call", "second call"):
        secs, raw = sync_time(lambda: solve(problem, optimizer, options=conv_opts, x0=x0c))
        its, mvps = int(raw["iterations"]), int(raw["mul_calls"])
        print(f"  {attempt}: converged {bool(raw['converged'])}, {its} LM iterations, "
              f"{mvps} matvecs, ssr {float(raw['ssr'])!r}, {secs:.3f} s "
              f"({(mvps - 2 * its) // 2 / secs:.1f} LSMR iterations/s), peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{smi}]")
    check(bool(raw["converged"]) and bool(torch.isfinite(raw["minimizer"]).all()),
          "m = 10M converged to a finite minimizer")
    check(raw["jacobian"] is None, "m = 10M: no Jacobian was formed")


def phase_geodesic(dev):
    """Phase 9d: geodesic LM on Rosenbrock, float64."""
    from leastsquaresoptim_jl_torch import LevenbergMarquardt, optimize

    header("== phase 9d: geodesic LM on Rosenbrock, float64")

    def rosenbrock(x):
        return torch.stack([1.0 - x[0], 100.0 * (x[1] - x[0] ** 2)])

    x0 = torch.zeros(2, dtype=torch.float64, device=dev)
    plain = optimize(rosenbrock, x0, LevenbergMarquardt())
    geo = optimize(rosenbrock, x0, LevenbergMarquardt(geodesic=True))
    err = float(np.abs(geo.minimizer - 1.0).max())
    print(f"  plain LM {plain.iterations} iterations, geodesic {geo.iterations} "
          f"({geo.f_calls} f_calls), max |x - 1| {err:.3e}")
    check(plain.converged and geo.converged and err <= 1e-6,
          "both converged, geodesic within 1e-6 of [1, 1]")
    check(geo.iterations < plain.iterations, "geodesic LM takes fewer iterations")
    check(geo.f_calls == 3 * geo.iterations + 1, "f_calls = 3 iterations + 1")


def tanh_row(x, row):
    a, y = row
    return torch.tanh(torch.dot(a, x)) - y


def phase_sharded_solve(dev):
    """Phase 9e: the row-sharded solve and LSMR operator on one rank."""
    import torch.distributed as dist

    from leastsquaresoptim_jl_torch import least_squares_problem, parallel, solve
    from leastsquaresoptim_jl_torch.ops import operators
    from leastsquaresoptim_jl_torch.solver import lsmr as lsmr_solver

    m, n = 65_536, 64
    header(f"== phase 9e: solve_sharded on a one-rank NCCL group, m={m}, n={n}, float32")
    rng = np.random.default_rng(11)
    A = torch.tensor(rng.standard_normal((m, n), dtype=np.float32) / np.sqrt(n),
                     dtype=torch.float32, device=dev)
    x_true = torch.tensor(np.abs(rng.standard_normal(n, dtype=np.float32)) * 0.5,
                          dtype=torch.float32, device=dev)
    y = torch.tanh(A @ x_true) + 0.01 * torch.tensor(
        rng.standard_normal(m, dtype=np.float32), device=dev)
    x0 = torch.full((n,), 0.6, device=dev)

    def whole(x):
        return torch.func.vmap(lambda row: tanh_row(x, row))((A, y))

    ref = solve(least_squares_problem(whole, x0, output_length=m,
                                      materialize_jacobian=False))
    op_ref = operators.from_matrix(A)
    gn_ref, st_ref = lsmr_solver.solve_gn(op_ref, y)
    parallel.initialize_multihost(f"tcp://127.0.0.1:{free_port()}", 1, 0)
    try:
        rows = parallel.shard_rows((A, y))
        raw = parallel.solve_sharded(tanh_row, rows, x0)
        gn, st = lsmr_solver.solve_gn(parallel.make_sharded_operator(rows[0]), rows[1])
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    diff = (raw["minimizer"] - ref["minimizer"]).abs().max().item()
    counts = [(int(r["iterations"]), int(r["mul_calls"]), int(r["inner_istop"]))
              for r in (raw, ref)]
    print(f"  sharded (iterations, matvecs, inner_istop) {counts[0]}, unsharded "
          f"{counts[1]}, converged {bool(raw['converged'])}, max |x - x_unsharded| "
          f"{diff:.3e}, max |x - x_true| "
          f"{(raw['minimizer'] - x_true).abs().max().item():.3e}")
    # One ulp in a float32 sum can move an inexact inner solve's stop by an
    # iteration (measured, when the two paths summed the probe estimates
    # from different layouts: 58 against 60 matvecs, x within 1.2e-7), so
    # the matvecs may differ by one LSMR iteration per LM iteration.
    check(bool(raw["converged"]) and bool(ref["converged"])
          and counts[0][0] == counts[1][0]
          and abs(counts[0][1] - counts[1][1]) <= 2 * counts[1][0] and diff <= 1e-5,
          "solve_sharded equals the unsharded solve (both converged, equal LM "
          "iterations, matvecs within one LSMR iteration each, x within 1e-5)")
    gdiff = (gn - gn_ref).abs().max().item()
    print(f"  sharded operator solve_gn: {st.iterations} iterations, istop {st.istop} "
          f"(unsharded {st_ref.iterations}, {st_ref.istop}), max difference {gdiff:.3e}")
    check(abs(st.iterations - st_ref.iterations) <= 1 and st.converged
          and gdiff <= 1e-5,
          "make_sharded_operator's Gauss-Newton step equals the unsharded "
          "operator's within 1e-5")


def phase_matrix_free(dev, smi):
    """Phase 9: LSMR, config #4 and its 10M scale point, geodesic LM and
    the row-sharded solve; no hand-written kernel may launch in it."""
    from leastsquaresoptim_jl_torch.ops import gram
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    phase_lsmr(dev)
    kv.launches = gram.launches = 0
    phase_config4(dev, smi)
    phase_geodesic(dev)
    phase_sharded_solve(dev)
    print(f"  launches on the matrix-free path (9b-9e): kernel_varpro {kv.launches}, "
          f"gram {gram.launches}")
    check(kv.launches == 0 and gram.launches == 0,
          "config #4's path launches neither hand-written kernel (none lies on it)")


# -- phase 10: the reference's test problems and the batched breadth ---------

# Solver grids of tests/test_minpack.py: (suite, optimizers, problem keywords,
# also require converged).
MINPACK_GRIDS = {
    "materialized": ("full_suite", [("Dogleg", "QR"), ("LevenbergMarquardt", "QR"),
                                    ("Dogleg", "LSMR"), ("LevenbergMarquardt", "LSMR")],
                     dict(use_jac=True), False),
    "matrix-free": ("full_suite", [("Dogleg", "LSMR"), ("LevenbergMarquardt", "LSMR")],
                    dict(materialize_jacobian=False), False),
    "cholesky": ("cholesky_suite", [("Dogleg", "Cholesky"), ("LevenbergMarquardt", "Cholesky")],
                 dict(use_jac=True), True),
    "central": ("full_suite", [("Dogleg", None), ("LevenbergMarquardt", None)],
                dict(autodiff="central"), True),
}
NIST_OPTIMIZERS = [("Dogleg", "QR"), ("LevenbergMarquardt", "QR")]
NIST_TOLS = dict(x_tol=1e-50, f_tol=1e-36, g_tol=1e-50)
NIST_MIN_SCORE = {("Dogleg", "QR"): 30, ("LevenbergMarquardt", "QR"): 31}
SINGLE_FITS = 512  # phase 10d's batch against one fit at a time


def _optimizer(name, solver):
    import leastsquaresoptim_jl_torch as lt

    return getattr(lt, name)(None if solver is None else getattr(lt, solver)())


_JOB_DEVICE = None  # set in each worker process by _worker_init


def _worker_init(device):
    global _JOB_DEVICE
    _JOB_DEVICE = torch.device(device)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False


def exp_saturation_residual(beta, data):
    x, y = data
    return y - beta[0] * (1.0 - torch.exp(-beta[1] * x))


def reference_job(job):
    """One job of phases 10a, 10b and 10d in a worker process (on the
    pool's device): a MINPACK solve, a NIST run, or a range of fits solved
    one at a time. Returns the job and what the checks read, with the
    seconds and the kernels' launches in the worker."""
    import leastsquaresoptim_jl_torch as lt
    from leastsquaresoptim_jl_torch.models import minpack, nist
    from leastsquaresoptim_jl_torch.ops import gram
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    dev = _JOB_DEVICE
    t0 = time.perf_counter()
    kind = job[0]
    if kind == "minpack":
        _, grid, opt, solver, name = job
        suite, _, kw, _ = MINPACK_GRIDS[grid]
        _, f, x0, jac = {p[0]: p for p in getattr(minpack, suite)(device=dev)}[name]
        kw = dict(kw)
        problem = lt.least_squares_problem(f, x0, g=jac if kw.pop("use_jac", False) else None,
                                           **kw)
        r = lt.optimize_problem(problem, _optimizer(opt, solver))
        out = dict(ssr=r.ssr, converged=r.converged, iterations=r.iterations)
    elif kind == "nist":
        _, opt, solver, name, i = job
        d = nist.DATASETS[name]
        x = torch.tensor(d["x"], dtype=torch.float64, device=dev)
        y = torch.tensor(d["y"], dtype=torch.float64, device=dev)
        problem = lt.least_squares_problem(
            lambda b: y - nist.MODELS[name](x, b),
            torch.tensor(d["starts"][0], dtype=torch.float64, device=dev))
        r = lt.optimize_problem(
            problem, _optimizer(opt, solver),
            x0=torch.tensor(d["starts"][i], dtype=torch.float64, device=dev), **NIST_TOLS)
        out = dict(minimizer=r.minimizer.tolist(), ssr=r.ssr, iterations=r.iterations,
                   g_calls=r.g_calls)
    elif kind == "multistart":
        _, name = job
        d = nist.DATASETS[name]
        x = torch.tensor(d["x"], dtype=torch.float64, device=dev)
        y = torch.tensor(d["y"], dtype=torch.float64, device=dev)
        s0, s1 = (np.asarray(s, np.float64) for s in d["starts"])
        starts = lt.latin_hypercube_starts(0, 64, np.minimum(s0, s1) / 4.0,
                                           np.maximum(s0, s1) * 4.0, device=dev)
        best, raw = lt.optimize_multistart(
            lambda b, data: data[1] - nist.MODELS[name](data[0], b), starts,
            data=(x, y), output_length=len(d["y"]))
        out = dict(converged=bool(best["converged"]),
                   minimizer=best["minimizer"].tolist(),
                   share=raw["converged"].double().mean().item(),
                   lockstep=int(raw["iterations"].max()))
    else:  # "single": fits lo..hi of phase 10d's float64 check
        _, lo, hi = job
        xdata, Y_np, x0_np, _ = bench_data(B_MAIN, seed=0)
        x = torch.tensor(xdata, device=dev)
        rows = []
        for i in range(lo, hi):
            yi = torch.tensor(Y_np[i], device=dev)
            raw = lt.solve(lt.least_squares_problem(
                lambda b, yi=yi: exp_saturation_residual(b, (x, yi)),
                torch.tensor(x0_np[i], device=dev)), lt.Dogleg(lt.Cholesky()))
            rows.append({k: (raw[k].tolist()) for k in SINGLE_KEYS})
        out = dict(rows=rows)
    out.update(seconds=time.perf_counter() - t0, launches=kv.launches + gram.launches)
    return job, out


SINGLE_KEYS = ("minimizer", "ssr", "iterations", "f_calls", "g_calls", "mul_calls",
               "converged", "x_converged", "f_converged", "g_converged")


def run_jobs(pool, jobs, what):
    """``jobs`` through the pool, in order; (results by job, seconds).
    Every job must report 0 kernel launches: no hand-written kernel lies
    on these paths."""
    t0 = time.perf_counter()
    out = dict(pool.imap_unordered(reference_job, jobs))
    secs = time.perf_counter() - t0
    check(all(r["launches"] == 0 for r in out.values()),
          f"{what}: no kernel launched in the workers")
    return out, secs


def reference_jobs():
    """The jobs of phases 10a-10c, longest first (NIST and the multistart
    solves run 1000 iterations each)."""
    from leastsquaresoptim_jl_torch.models import minpack, nist

    jobs = [("multistart", name) for name in ("MGH09", "MGH10")]
    jobs += [("nist", o, s, name, i) for o, s in NIST_OPTIMIZERS[::-1]
             for name in nist.DATASETS for i in (0, 1)]
    for grid, (suite, optimizers, _, _) in MINPACK_GRIDS.items():
        names = [p[0] for p in getattr(minpack, suite)(device="cpu")]
        jobs += [("minpack", grid, o, s, n) for o, s in optimizers for n in names]
    return jobs


def phase_minpack(out, smi):
    """Phase 10a: the four MINPACK grids of tests/test_minpack.py."""
    header("== phase 10a: MINPACK grids (tests/test_minpack.py), float64")
    for grid, (_, _, _, need_conv) in MINPACK_GRIDS.items():
        runs = {j: r for j, r in out.items() if j[:2] == ("minpack", grid)}
        misses = [(j[2], j[3], j[4], r["ssr"], r["converged"]) for j, r in runs.items()
                  if not (r["ssr"] <= 1e-3) or (need_conv and not r["converged"])]
        print(f"  {grid}: {len(runs)} solves, {sum(r['iterations'] for r in runs.values())} "
              f"iterations, {len(misses)} misses {misses}, job seconds "
              f"{sum(r['seconds'] for r in runs.values()):.2f} [{smi}]")
        check(not misses, f"MINPACK {grid}: every ssr <= 1e-3"
              + (" and converged" if need_conv else ""))


def phase_nist(out, smi):
    """Phase 10b: the NIST StRD scoreboard of tests/test_nist.py."""
    from leastsquaresoptim_jl_torch.models import nist

    header("== phase 10b: NIST StRD scoreboard (tests/test_nist.py), float64")
    for o, s in NIST_OPTIMIZERS:
        runs = {(j[3], j[4]): r for j, r in out.items() if j[:3] == ("nist", o, s)}
        nan = [k for k, r in runs.items() if np.isnan(np.mean(r["minimizer"]))]
        misses = sorted(k for k, r in runs.items() if np.linalg.norm(
            np.asarray(r["minimizer"]) - np.asarray(nist.DATASETS[k[0]]["solution"])) > 1e-3)
        score = len(runs) - len(misses)
        print(f"  {o}({s}): {score}/{len(runs)} within 1e-3 of the certified solution, "
              f"misses (dataset, start) {misses}, iterations "
              f"{sum(r['iterations'] for r in runs.values())}, job seconds "
              f"{sum(r['seconds'] for r in runs.values()):.2f} [{smi}]")
        check(len(runs) == 32 and not nan, f"{o}({s}): 32 runs, no NaN minimizer")
        if (o, s) in NIST_MIN_SCORE:
            check(score >= NIST_MIN_SCORE[(o, s)],
                  f"{o}({s}) scores >= {NIST_MIN_SCORE[(o, s)]} of 32")


def phase_multistart(out, smi):
    """Phase 10c: the MGH09 and MGH10 far-start escapes by multistart."""
    from leastsquaresoptim_jl_torch.models import nist

    header("== phase 10c: multistart escapes, 64 Latin-hypercube starts, float64")
    for name in ("MGH09", "MGH10"):
        r = out[("multistart", name)]
        err = float(np.linalg.norm(np.asarray(r["minimizer"])
                                   - np.asarray(nist.DATASETS[name]["solution"])))
        print(f"  {name}: best row converged {r['converged']}, |x - certified| {err:.3e}, "
              f"{r['share']:.4f} of the starts converged, lockstep iterations "
              f"{r['lockstep']}, job seconds {r['seconds']:.3f} [{smi}]")
        check(r["converged"] and err <= 1e-3,
              f"{name}: the best start converged within 1e-3 of the certified solution")


def time_batch(run, label, smi, B):
    """Best and median of 3 host-clock runs ending in a sync, after a
    warm-up; printed with fits/s."""
    run()
    ts = [sync_time(run)[0] for _ in range(3)]
    best, med = min(ts), float(np.median(ts))
    print(f"  {label}: best {best:.6f} s, median {med:.6f} s over 3; "
          f"{B / best:.1f} fits/s (best) [{smi}]")
    return best


def device_launches(run, kernel):
    """The launches of ``kernel`` in the device trace of one ``run()``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name)


def profile_batch(run, raw, label, smi):
    """One profiler pass; CUDA kernels per lockstep iteration."""
    kernels = profile_solve(run, label, smi)
    its = int(raw["iterations"].max())
    if kernels is not None:
        print(f"  {label}: {its} lockstep iterations, {kernels / max(its, 1):.1f} CUDA "
              f"kernels per iteration [{smi}]")


def phase_batched_dogleg(dev, pool, smi):
    """Phase 10d: batched Dogleg at config #5's batch (phase 3's data)."""
    import leastsquaresoptim_jl_torch as lt
    from leastsquaresoptim_jl_torch.models import curve_fit_batch
    from leastsquaresoptim_jl_torch.ops import gram
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    xdata, Y_np, x0_np, bt = bench_data(B_MAIN, seed=0)
    Y = torch.tensor(Y_np, dtype=torch.float32, device=dev)
    P0 = torch.tensor(x0_np, dtype=torch.float32, device=dev)
    x = torch.tensor(xdata, dtype=torch.float32, device=dev)
    truth = torch.tensor(bt, dtype=torch.float64, device=dev)
    opts = lt.Options(iterations=ITERATIONS, radius=RADIUS, **TOLS)
    runs = {
        "curve_fit_batch Dogleg(Cholesky()) (separable, gridded, fused='ssr')":
            lambda: curve_fit_batch(
                "exp_saturation", xdata, Y, P0, optimizer=lt.Dogleg(lt.Cholesky()),
                options=opts, min_converged_fraction=FRAC, separable=True,
                gridded=True, fused="ssr"),
        "solve_batch default optimizer (two parameters, grid shared)":
            lambda: lt.solve_batch(exp_saturation_residual, P0, (x, Y), options=opts,
                                   data_axis=(None, 0), output_length=M,
                                   min_converged_fraction=FRAC),
    }
    header(f"== phase 10d: batched Dogleg at B={B_MAIN}, m={M}, float32")
    for label, run in runs.items():
        kv.launches = gram.launches = 0
        secs, raw = sync_time(run)
        launches = (kv.launches, gram.launches)
        conv = raw["converged"].double().mean().item()
        err = rel(raw["minimizer"], truth).median().item()
        print(f"  {label}: converged {conv:.6f}, median rel error vs truth {err:.3e}, "
              f"launches (kernel_varpro, gram) {launches}, first call {secs:.3f} s")
        check(launches == (0, 0), f"{label}: no kernel launched")
        check(conv >= 0.99 and err <= 1e-4,
              f"{label}: >= 99% converged, median relative error <= 1e-4")
        time_batch(run, label, smi, B_MAIN)
        profile_batch(run, raw, label, smi)

    header(f"== phase 10d: the first {SINGLE_FITS} fits, float64: one batch against "
          "one fit at a time")
    x64 = torch.tensor(xdata, device=dev)
    Y64 = torch.tensor(Y_np[:SINGLE_FITS], device=dev)
    raw = lt.solve_batch(exp_saturation_residual, torch.tensor(x0_np[:SINGLE_FITS], device=dev),
                         (x64, Y64), data_axis=(None, 0), output_length=M)
    step = SINGLE_FITS // 8
    out, secs = run_jobs(pool, [("single", lo, lo + step)
                                for lo in range(0, SINGLE_FITS, step)], "one fit at a time")
    rows = [row for job in sorted(out) for row in out[job]["rows"]]
    batch = {k: raw[k].cpu().numpy() for k in SINGLE_KEYS}
    one = {k: np.asarray([r[k] for r in rows]) for k in SINGLE_KEYS}
    rdiff = float(np.max(np.abs(batch["minimizer"] - one["minimizer"]) / np.abs(one["minimizer"])))
    counters = all((batch[k] == one[k]).all() for k in
                   ("iterations", "f_calls", "g_calls", "mul_calls", "converged"))
    above = np.maximum(batch["ssr"], one["ssr"]) > 1e-20
    flags = all((batch[k][above] == one[k][above]).all()
                for k in ("x_converged", "f_converged", "g_converged"))
    print(f"  minimizers max rel diff {rdiff:.3e}, iterations and counters equal {counters}, "
          f"criteria equal where ssr > 1e-20 ({int(above.sum())} fits) {flags}, "
          f"converged {batch['converged'].mean():.4f}; {SINGLE_FITS} single solves in "
          f"{secs:.2f} s over the pool [{smi}]")
    check(counters and flags and rdiff <= 1e-10,
          "the batch equals one fit at a time (iterations, flags, minimizers within 1e-10)")


def phase_bounded_batches(dev, smi):
    """Phase 10e: a lower bound on b1 at the 30th percentile of the truth."""
    import leastsquaresoptim_jl_torch as lt
    from leastsquaresoptim_jl_torch.models import curve_fit_batch
    from leastsquaresoptim_jl_torch.ops import gram
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    xdata, Y_np, x0_np, bt = bench_data(B_MAIN, seed=0)
    lo = np.float32(np.quantile(bt[:, 1], 0.3))
    lower = np.array([-np.inf, lo])
    Y = torch.tensor(Y_np, dtype=torch.float32, device=dev)
    P0 = torch.tensor(np.maximum(x0_np, lower), dtype=torch.float32, device=dev)
    truth = torch.tensor(bt, dtype=torch.float64, device=dev)
    below = truth[:, 1] <= float(lo)
    opts = lt.Options(iterations=ITERATIONS, radius=RADIUS, **TOLS)
    header(f"== phase 10e: bounded batches, lower b1 = {float(lo)!r} (30th percentile of "
          f"the truth; {below.double().mean().item():.4f} of the fits below it), "
          f"B={B_MAIN}, m={M}, float32")
    for opt in (lt.LevenbergMarquardt(lt.Cholesky()), lt.Dogleg(lt.Cholesky())):
        label = f"curve_fit_batch {type(opt).__name__}(Cholesky()) bounded"

        def run(opt=opt):
            return curve_fit_batch("exp_saturation", xdata, Y, P0, optimizer=opt,
                                   options=opts, lower=lower, min_converged_fraction=FRAC,
                                   separable=True, gridded=True, fused="ssr")

        kv.launches = gram.launches = 0
        secs, raw = sync_time(run)
        launches = (kv.launches, gram.launches)
        b1 = raw["minimizer"][:, 1].double()
        conv = raw["converged"].double().mean().item()
        pinned = ((b1 - float(lo)).abs() <= 1e-6 * float(lo))[below].double().mean().item()
        free = (rel(raw["minimizer"], truth).amax(dim=1) <= 1e-4)[~below].double().mean().item()
        feasible = bool((b1 >= float(lo)).all())
        print(f"  {label}: feasible {feasible}, converged {conv:.6f}, fits below the bound "
              f"at it (1e-6) {pinned:.6f}, the rest within 1e-4 of the truth {free:.6f}, "
              f"launches {launches}, first call {secs:.3f} s")
        check(feasible and conv >= 0.99 and pinned >= 0.99 and free >= 0.99,
              f"{label}: feasible, >= 99% converged, >= 99% pinned, >= 99% of the rest "
              "within 1e-4")
        check(launches == (0, 0), f"{label}: no kernel launched")
        time_batch(run, label, smi, B_MAIN)
        profile_batch(run, raw, label, smi)


def phase_kernel_bases(dev, smi):
    """Phase 10f: power and michaelis_menten through curve_fit_batch and
    through the kernel; one K = 8 launch of each against its plain version."""
    import leastsquaresoptim_jl_torch as lt
    from leastsquaresoptim_jl_torch.interop import kernel_state
    from leastsquaresoptim_jl_torch.models import curve_fit_batch
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    opts = lt.Options(iterations=ITERATIONS, radius=RADIUS, **TOLS)
    kernel_kw = dict(TOLS, iterations=ITERATIONS, min_converged_fraction=FRAC,
                     k_iters=K, radius=RADIUS)
    tols = (TOLS["x_tol"], TOLS["f_tol"], TOLS["g_tol"])
    rows = {}
    for basis in ("power", "michaelis_menten"):
        xd, Y_np, a0 = basis_data(basis, B_MAIN, M, seed=1)
        header(f"== phase 10f: {basis} at B={B_MAIN}, m={M}, float32")
        Y = torch.tensor(Y_np, dtype=torch.float32, device=dev)
        p0 = np.stack([np.ones(B_MAIN), a0], 1)
        P0 = torch.tensor(p0, dtype=torch.float32, device=dev)
        A0 = P0[:, 1].contiguous()

        def plain(basis=basis, xd=xd, Y=Y, P0=P0):
            return curve_fit_batch(basis, xd, Y, P0, separable=True,
                                   optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
                                   options=opts, min_converged_fraction=FRAC)

        def kernel(basis=basis, xd=xd, Y=Y, A0=A0):
            return kv.varpro_lm_p1_kernel_solve(basis, xd, Y, A0, **kernel_kw)

        kv.launches = 0
        raw = plain()
        torch.cuda.synchronize()
        plain_launches = kv.launches
        kv.launches = 0
        out = kernel()
        torch.cuda.synchronize()
        rows[basis] = kv.launches
        conv_p = raw["converged"].double().mean().item()
        conv_k = out["converged"].double().mean().item()
        d = rel(out["alpha"], raw["minimizer"][:, 1]).median().item()
        print(f"  launches: plain route {plain_launches}, kernel route {rows[basis]}; "
              f"converged {conv_p:.6f} (plain), {conv_k:.6f} (kernel); median alpha rel "
              f"diff {d:.3e}")
        check(plain_launches == 0 and rows[basis] >= 1,
              f"{basis}: 0 launches on the plain route, >= 1 on the kernel route")
        check(conv_p >= 0.99 and conv_k >= 0.99 and d <= 1e-5,
              f"{basis}: both routes >= 99% converged, median alpha difference <= 1e-5")
        time_batch(plain, f"{basis} curve_fit_batch route", smi, B_MAIN)
        time_batch(kernel, f"{basis} kernel route", smi, B_MAIN)

        x = torch.tensor(xd, dtype=torch.float32, device=dev)
        state0 = torch.tensor(kernel_state(a0, RADIUS, np.float32), device=dev)
        sk = kv._launch_kernel(basis, x, Y, state0.clone(), K, tols, float(ITERATIONS))
        sr = kv._launch_reference(basis, x, Y, state0.clone(), K, tols, float(ITERATIONS))
        torch.cuda.synchronize()
        check_parity(f"{basis} one launch K={K} at B={B_MAIN}", state_parity(sk, sr),
                     torch.float32, kv.lanes_per_fit(M))
        ms, _ = interleaved_ms({
            "kernel": lambda: launch_ms(kv._launch_kernel, x, Y, state0, tols, basis=basis),
            "plain": lambda: launch_ms(kv._launch_reference, x, Y, state0, tols, basis=basis)})
        ms_k, ms_r = ms["kernel"], ms["plain"]
        fit_iters = int((sk[:, kv._ITERS] - state0[:, kv._ITERS]).sum().item())
        bound, bound_by = varpro_bound(B_MAIN, M, fit_iters, 4, basis)
        print(f"  one launch K={K}, {kv.lanes_per_fit(M)} lanes per fit: kernel "
              f"{ms_k:.4f} ms, plain version {ms_r:.4f} ms ({INTERLEAVED}); "
              f"bound {bound:.4f} ms ({bound_by}; {fit_iters} fit-iterations), kernel at "
              f"{bound / ms_k:.1%} of it [{smi}]")
    return rows


def phase_reference_problems(dev, smi):
    """Phase 10: MINPACK, NIST, multistart, batched Dogleg, bounded
    batches and the kernel's other bases. The solves of 10a-10c and 10d's
    single fits are host-bound and independent: they run in a pool of
    worker processes, each with its own CUDA context on card 0, 10a-10c
    as one queue, longest first."""
    import multiprocessing

    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, _worker_init, (str(dev),)) as pool:
        jobs = reference_jobs()
        out, secs = run_jobs(pool, jobs, "phases 10a-10c")
        header(f"== phases 10a-10c: {len(jobs)} solves over {workers} worker processes "
              f"on {dev} in {secs:.2f} s (job seconds are taken with the other "
              f"workers running) [{smi}]")
        phase_minpack(out, smi)
        phase_nist(out, smi)
        phase_multistart(out, smi)
        phase_batched_dogleg(dev, pool, smi)
        pool.close()
        pool.join()
    phase_bounded_batches(dev, smi)
    phase_kernel_bases(dev, smi)
    header(f"== phase 10 took {time.perf_counter() - t0:.2f} s")


# -- phase 11: the rest of curve fitting ----------------------------------------

# f_scale of phase 11c's robust fits: the noise is 1% of each fit's
# amplitude (b0 ~ U(100, 400), so sigma ~ U(1, 4)); f_scale sits at the
# median sigma, where the robust losses leave the noise quadratic.
ROBUST_F_SCALE = 2.5
CPU_FITS = 1024  # phase 11a's device-independence check


def flim_data(B, seed):
    """Bi-exponential decays on linspace(0, 6, 64), no noise, with the truth
    ranges of tests/test_init.py::test_curve_fit_batch_auto (amps U(1, 4),
    U(0.5, 2); rates U(0.2, 0.8), U(1.5, 3.5))."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 6.0, 64)
    bt = np.stack([rng.uniform(1, 4, B), rng.uniform(0.2, 0.8, B),
                   rng.uniform(0.5, 2, B), rng.uniform(1.5, 3.5, B)], axis=1)
    Y = bt[:, :1] * np.exp(-bt[:, 1:2] * x) + bt[:, 2:3] * np.exp(-bt[:, 3:4] * x)
    return x, Y, bt


def peaks_data(B, seed):
    """Two Gaussian peaks on linspace(0, 10, 128), no noise, with the truth
    ranges of tests/test_init.py::test_gauss_sum_guess_noise_robust (amps
    U(1, 4), centers U(1.5, 3.5) and U(5.5, 8.5), widths U(0.3, 1))."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 10.0, 128)
    bt = np.stack([rng.uniform(1, 4, B), rng.uniform(1.5, 3.5, B), rng.uniform(0.3, 1.0, B),
                   rng.uniform(1, 4, B), rng.uniform(5.5, 8.5, B), rng.uniform(0.3, 1.0, B)],
                  axis=1)
    Y = sum(bt[:, 3 * j:3 * j + 1] * np.exp(-((x - bt[:, 3 * j + 1:3 * j + 2]) ** 2)
                                             / (2 * bt[:, 3 * j + 2:3 * j + 3] ** 2))
            for j in range(2))
    return x, Y, bt


def outlier_data(B, seed):
    """Phase 3's bench_data with 1% Gaussian noise (of each fit's
    amplitude b0) and three gross outliers per fit, at per-fit random
    sample indices, each + U(5, 10) b0."""
    xdata, Y, x0s, bt = bench_data(B, seed)
    rng = np.random.default_rng(seed + 1)
    Y = Y + 0.01 * bt[:, :1] * rng.standard_normal(Y.shape)
    idx = np.argsort(rng.random((B, M)), axis=1)[:, :3]
    np.put_along_axis(Y, idx, np.take_along_axis(Y, idx, 1)
                      + rng.uniform(5, 10, (B, 3)) * bt[:, :1], 1)
    return xdata, Y, x0s, bt


def max_rel(minimizer, truth):
    """Each fit's largest relative parameter error (float64); a fit that
    ended non-finite counts as an infinite error."""
    return torch.nan_to_num(rel(minimizer, truth).amax(dim=1), nan=float("inf"))


def run_route(label, run, smi, B, exp2=False):
    """One route of 11a-11c: reset the kernels' counters, solve, require 0
    launches of kernel_varpro and the Gram, and of varpro_exp2_eval one a
    lockstep iteration, one for the seed and one for the final Jacobian
    where ``exp2`` (else none), then times and one profiler pass. Returns
    the result and varpro_exp2_eval's launches. The host counts the first
    two; varpro_exp2_eval is counted in the device trace of a second call,
    since a lockstep iteration replayed from the batch driver's CUDA graph
    launches on the card and not from the host."""
    from leastsquaresoptim_jl_torch.ops import gram
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    kv.launches = gram.launches = 0
    secs, raw = sync_time(run)
    launches = (kv.launches, gram.launches, device_launches(run, "varpro_exp2_eval"))
    its = int(raw['iterations'].max())
    print(f"  {label}: launches (kernel_varpro, gram, varpro_exp2_eval) {launches}, lockstep "
          f"iterations {its}, converged {raw['converged'].double().mean().item():.6f}, "
          f"first call {secs:.3f} s")
    check(launches == (0, 0, its + 2 if exp2 else 0),
          f"{label}: " + (f"varpro_exp2_eval launched {its} + 2 times, no other kernel"
                          if exp2 else "no kernel launched"))
    time_batch(run, label, smi, B)
    profile_batch(run, raw, label, smi)
    return raw, launches[2]


def phase_start_free(dev, smi):
    """Phases 11a and 11b: start-free exp_sum_2 and gauss_sum_2 batches."""
    import leastsquaresoptim_jl_torch as lt
    from leastsquaresoptim_jl_torch.models import curve_fit_batch

    x, Y_np, bt = flim_data(B_MAIN, seed=11)
    kw = dict(separable=True, gridded=True, fused="ssr",
              optimizer=lt.LevenbergMarquardt(lt.Cholesky()), min_converged_fraction=FRAC)
    out = {}
    for dtype, conv_min, err_max in ((torch.float32, 0.95, 1e-3), (torch.float64, 0.95, 1e-4)):
        header(f"== phase 11a: start-free exp_sum_2 (p0='auto', separable, gridded, "
              f"fused='ssr', LM(Cholesky())), B={B_MAIN}, m=64, {dtype}")
        Y = torch.tensor(Y_np, dtype=dtype, device=dev)
        truth = torch.tensor(bt, dtype=torch.float64, device=dev)

        def run(Y=Y):
            return curve_fit_batch("exp_sum_2", x, Y, "auto", **kw)

        raw, n = run_route(f"exp_sum_2 {dtype}", run, smi, B_MAIN,
                           exp2=dtype == torch.float32)
        if dtype == torch.float32:
            exp2_launches = n
        conv = raw["converged"]
        share = conv.double().mean().item()
        err = max_rel(raw["minimizer"], truth)[conv].median().item()
        print(f"  converged {share:.6f}, median max relative error over the converged fits "
              f"{err:.3e}, finite {bool(torch.isfinite(raw['minimizer']).all())}")
        check(share >= conv_min if dtype == torch.float32 else share > conv_min,
              f"11a {dtype}: converged share {'>=' if dtype == torch.float32 else '>'} {conv_min}")
        check(err < err_max, f"11a {dtype}: median max relative error < {err_max:g}")
        out[dtype] = raw

    header(f"== phase 11a: the first {CPU_FITS} fits in float64, on the card and on the CPU")
    Y64 = torch.tensor(Y_np[:CPU_FITS], dtype=torch.float64)
    on_card = curve_fit_batch("exp_sum_2", x, Y64.to(dev), "auto", **kw)
    t0 = time.perf_counter()
    on_cpu = curve_fit_batch("exp_sum_2", x, Y64, "auto", **kw)
    cpu_s = time.perf_counter() - t0
    d = rel(on_card["minimizer"].cpu(), on_cpu["minimizer"]).amax(dim=1)
    same_its = (on_card["iterations"].cpu() == on_cpu["iterations"]).double().mean().item()
    within = (d <= 1e-10).double().mean().item()
    print(f"  minimizers within 1e-10 relative on {within:.6f} of the fits (max "
          f"{d.max().item():.3e}), iterations equal on {same_its:.6f}; the CPU took "
          f"{cpu_s:.2f} s")
    check(within >= 0.99 and same_its >= 0.99,
          "11a: card and CPU agree (minimizers 1e-10, iterations) on >= 99% of the fits")

    x2, Y2_np, bt2 = peaks_data(B_MAIN, seed=12)
    header(f"== phase 11b: start-free gauss_sum_2 (p0='auto', separable, LM(Cholesky())), "
          f"B={B_MAIN}, m=128, float32")
    Y2 = torch.tensor(Y2_np, dtype=torch.float32, device=dev)
    truth2 = torch.tensor(bt2, dtype=torch.float64, device=dev)

    def run2():
        return curve_fit_batch("gauss_sum_2", x2, Y2, "auto", separable=True,
                               optimizer=lt.LevenbergMarquardt(lt.Cholesky()),
                               min_converged_fraction=FRAC)

    raw, _ = run_route("gauss_sum_2 float32", run2, smi, B_MAIN)
    conv = raw["converged"]
    share = conv.double().mean().item()
    err = max_rel(raw["minimizer"], truth2)[conv].median().item()
    print(f"  converged {share:.6f}, median max relative error over the converged fits {err:.3e}")
    check(share >= 0.95 and err < 1e-3,
          "11b: >= 95% converged, median max relative error < 1e-3")
    return x, Y_np, out[torch.float32], out[torch.float64], exp2_launches


def phase_robust(dev, smi):
    """Phase 11c: outlier-robust bulk fits, IRLS and robustify against the
    linear-loss control."""
    import leastsquaresoptim_jl_torch as lt
    from leastsquaresoptim_jl_torch.models import curve_fit_batch

    xdata, Y_np, x0_np, bt = outlier_data(B_MAIN, seed=13)
    Y = torch.tensor(Y_np, dtype=torch.float32, device=dev)
    P0 = torch.tensor(x0_np, dtype=torch.float32, device=dev)
    truth = torch.tensor(bt, dtype=torch.float64, device=dev)
    lm = lt.LevenbergMarquardt(lt.Cholesky())
    common = dict(optimizer=lm, options=lt.Options(iterations=ITERATIONS, radius=RADIUS, **TOLS),
                  min_converged_fraction=FRAC)
    routes = {
        "IRLS huber (separable, gridded)": lambda: curve_fit_batch(
            "exp_saturation", xdata, Y, P0, separable=True, gridded=True, loss="huber",
            f_scale=ROBUST_F_SCALE, **common),
        "joint soft_l1 (robustify)": lambda: curve_fit_batch(
            "exp_saturation", xdata, Y, P0, loss="soft_l1", f_scale=ROBUST_F_SCALE, **common),
        "linear-loss control (separable, gridded)": lambda: curve_fit_batch(
            "exp_saturation", xdata, Y, P0, separable=True, gridded=True, **common),
    }
    header(f"== phase 11c: outlier-robust fits, B={B_MAIN}, m={M}, float32, 1% noise and 3 "
          f"outliers of +5-10 b0 per fit, f_scale {ROBUST_F_SCALE}")
    errs = {}
    for label, run in routes.items():
        raw, _ = run_route(label, run, smi, B_MAIN)
        errs[label] = max_rel(raw["minimizer"], truth).median().item()
        rounds = raw.get("irls_rounds")
        bad = int((~torch.isfinite(raw["minimizer"]).all(dim=1)).sum())
        print(f"  {label}: median max relative error vs truth {errs[label]:.3e}, "
              f"{bad} fits non-finite" + (f", IRLS rounds {rounds}" if rounds is not None else ""))
    control = errs["linear-loss control (separable, gridded)"]
    for label in list(routes)[:2]:
        check(errs[label] < 0.02 and errs[label] < control / 5,
              f"11c {label}: median error < 0.02 and < 1/5 of the control's ({control:.3e})")


def varpro_job(job):
    """One run of phase 11d's NIST_SEPARABLE scoreboard in a worker (the
    protocol of tests/test_separable.py::test_nist_varpro_scoreboard)."""
    import leastsquaresoptim_jl_torch as lt
    from leastsquaresoptim_jl_torch.models import nist
    from leastsquaresoptim_jl_torch.ops import gram
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    dev = _JOB_DEVICE
    t0 = time.perf_counter()
    _, opt, name, i = job
    d = nist.DATASETS[name]
    x = torch.tensor(d["x"], dtype=torch.float64, device=dev)
    y = torch.tensor(d["y"], dtype=torch.float64, device=dev)
    try:
        r = lt.curve_fit(nist.NIST_SEPARABLE[name], x, y,
                         torch.tensor(d["starts"][i], dtype=torch.float64, device=dev),
                         separable=True, optimizer=_optimizer(opt, "QR"), iterations=3000,
                         **NIST_TOLS)
        out = dict(minimizer=r.minimizer.tolist(), iterations=r.iterations)
    except lt.IsFiniteError:
        out = dict(minimizer=[float("nan")] * len(d["solution"]), iterations=-1)
    out.update(seconds=time.perf_counter() - t0, launches=kv.launches + gram.launches)
    return job, out


# Allowed misses of tests/test_separable.py::test_nist_varpro_scoreboard, by
# optimizer (over QR). One fit costs milliseconds an iteration on the card
# and every run goes to the 3000-iteration cap, so the card runs Dogleg's
# half (the one with the MGH10 s0 rescue); tests/test_torch_nist_varpro.py
# holds LM's allowed miss against the JAX package on the CPU.
VARPRO_ALLOWED_MISSES = {"Dogleg": {("MGH09", 0)}}
# The certified starts it runs: s0 only, the start of the allowed miss and
# of the MGH10 rescue (s1 was cut to make room for phase 13).
VARPRO_STARTS = (0,)


def phase_single_fits(dev, smi, x, Y_np, raw32, raw64):
    """Phase 11d: single fits in float64 (the NIST_SEPARABLE scoreboard in
    a pool of workers, start-free Lanczos3, a weighted NIST curve_fit, its
    covariance, and polish of an 11a float32 fit)."""
    import multiprocessing

    import leastsquaresoptim_jl_torch as lt
    from leastsquaresoptim_jl_torch.models import exp_sum_separable, nist
    from leastsquaresoptim_jl_torch.utils import covariance

    workers = min(8, os.cpu_count() or 1)
    jobs = [("varpro", o, name, i) for o in VARPRO_ALLOWED_MISSES
            for name in nist.NIST_SEPARABLE for i in VARPRO_STARTS]
    header(f"== phase 11d: NIST_SEPARABLE scoreboard, {len(jobs)} float64 runs (3000 "
          f"iterations, x_tol 1e-50) over {workers} workers on {dev}")
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ctx.Pool(workers, _worker_init, (str(dev),)) as pool:
        out = dict(pool.imap_unordered(varpro_job, jobs))
        pool.close()
        pool.join()
    secs = time.perf_counter() - t0
    check(all(r["launches"] == 0 for r in out.values()), "11d: no kernel launched in the workers")
    for o, allowed in VARPRO_ALLOWED_MISSES.items():
        runs = {(j[2], j[3]): r for j, r in out.items() if j[1] == o}
        misses = sorted(k for k, r in runs.items() if not np.linalg.norm(
            np.asarray(r["minimizer"]) - np.asarray(nist.DATASETS[k[0]]["solution"])) <= 1e-3)
        print(f"  {o}(QR): {len(runs) - len(misses)}/{len(runs)} within 1e-3 of the certified "
              f"solution, misses {misses}, job seconds "
              f"{sum(r['seconds'] for r in runs.values()):.2f} [{smi}]")
        check(len(runs) == len(nist.NIST_SEPARABLE) * len(VARPRO_STARTS)
              and set(misses) <= allowed,
              f"11d {o}(QR): misses within the allowed {sorted(allowed)}")
        if o == "Dogleg":
            check(("MGH10", 0) not in misses, "11d Dogleg(QR): the MGH10 s0 rescue holds")
    print(f"  scoreboard: {secs:.2f} s wall [{smi}]")

    d = nist.DATASETS["Lanczos3"]
    sol = np.asarray(d["solution"])
    xl = torch.tensor(d["x"], dtype=torch.float64, device=dev)
    yl = torch.tensor(d["y"], dtype=torch.float64, device=dev)
    r = lt.curve_fit(exp_sum_separable(3), xl, yl, "auto", separable=True)
    err = float(np.abs(r.minimizer - sol).max())
    header(f"== phase 11d: start-free Lanczos3: converged {r.converged}, iterations "
          f"{r.iterations}, max |x - certified| {err:.3e}")
    check(r.converged and err <= 1e-3, "11d: start-free Lanczos3 within 1e-3 of the certified solution")

    d = nist.DATASETS["Misra1b"]
    xm = torch.tensor(d["x"], dtype=torch.float64, device=dev)
    ym = torch.tensor(d["y"], dtype=torch.float64, device=dev)
    w = 1.0 / torch.sqrt(ym)
    r = lt.curve_fit("Misra1b", xm, ym, d["starts"][1], weights=w,
                     optimizer=lt.LevenbergMarquardt(lt.QR()))
    cov = covariance(r)
    J = r.jacobian.astype(np.float64)
    ref = r.ssr / (J.shape[0] - J.shape[1]) * np.linalg.inv(J.T @ J)
    cov_err = float(np.abs(cov - ref).max() / np.abs(ref).max())
    header(f"== phase 11d: weighted curve_fit('Misra1b'): converged {r.converged}, minimizer "
          f"{r.minimizer.tolist()}, covariance against numpy float64 from the same J: max "
          f"relative difference {cov_err:.3e}")
    check(r.converged and cov_err <= 1e-10, "11d: weighted NIST fit converged, covariance within 1e-10")

    both = (raw32["converged"] & raw64["converged"]).nonzero()[:, 0]
    i = int(both[0])
    x64 = torch.tensor(x, device=dev)
    y64 = torch.tensor(Y_np[i], device=dev)

    def f64(b):
        return y64 - (b[0] * torch.exp(-b[1] * x64) + b[2] * torch.exp(-b[3] * x64))

    rp = lt.polish(f64, raw32["minimizer"][i])
    target = raw64["minimizer"][i].double().cpu().numpy()
    d_pol = float(np.max(np.abs(rp.minimizer - target) / np.abs(target)))
    header(f"== phase 11d: polish of 11a's float32 fit {i} to float64: converged {rp.converged}, "
          f"iterations {rp.iterations}, max relative difference from the float64 fit {d_pol:.3e}")
    check(rp.converged and d_pol <= 1e-10, "11d: polished fit within 1e-10 of the float64 fit")


def phase_curve_fitting(dev, smi):
    """Phase 11: start-free batches, robust fits and single fits. Returns
    varpro_exp2_eval's launches in 11a's float32 batch."""
    t0 = time.perf_counter()
    x, Y_np, raw32, raw64, exp2_launches = phase_start_free(dev, smi)
    phase_robust(dev, smi)
    phase_single_fits(dev, smi, x, Y_np, raw32, raw64)
    header(f"== phase 11 took {time.perf_counter() - t0:.2f} s")
    return exp2_launches


# -- phase 12: the structured-Jacobian path ----------------------------------

CONFIG4_RATES = {}  # phase 9b's LM iterations/s (best of 3) by column-norm route
# 12a: (blocks, block size, route). "soa" is solve_block_tridiag_spd_soa,
# the route BlockCholesky(2) takes at config #4's Gram (nb = 50000).
BLOCK_ROUTES = [(50_000, 2, "soa"), (4096, 4, "cr"), (256, 3, "scan")]
BLOCK_LIMITS = {torch.float64: 1e-10, torch.float32: 1e-4}
BATCH_BC, N_BC = 2048, 256  # 12e


def block_system(nb, s, seed):
    """A random SPD block-tridiagonal system in float64 numpy, blocks made
    as tests/test_block_cholesky.py makes them: Q Q' + 3 s I on the
    diagonal, 0.3 N(0, 1) couplings. Returns (D, L, rhs)."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((nb, s, s))
    D = Q @ Q.transpose(0, 2, 1) + 3.0 * s * np.eye(s)
    L = 0.3 * rng.standard_normal((nb - 1, s, s))
    return D, L, rng.standard_normal(nb * s)


def block_apply(D, L, x):
    """A x for the block-tridiagonal (D, L), blockwise in float64."""
    D, L = D.double(), L.double()
    nb, s = D.shape[0], D.shape[-1]
    xb = x.double().reshape(nb, s, 1)
    y = D @ xb
    y[1:] += L @ xb[:-1]
    y[:-1] += L.mT @ xb[1:]
    return y.reshape(-1)


def block_solve(route, D, L, rhs):
    from leastsquaresoptim_jl_torch.ops import block_tridiag as bt

    if route == "soa":
        nb, s = D.shape[0], D.shape[-1]
        comp = lambda M: [[M[:, i, j].contiguous() for j in range(s)]  # noqa: E731
                          for i in range(s)]
        return bt.solve_block_tridiag_spd_soa(comp(D), comp(L), rhs, nb, s)
    return bt.solve_block_tridiag_spd(D, L, rhs, method=route)


def phase_block_solves(dev, smi):
    """12a: the three block solves alone."""
    header("== phase 12a: block-tridiagonal solves on random SPD systems")
    for nb, s, route in BLOCK_ROUTES:
        D_np, L_np, r_np = block_system(nb, s, seed=nb + s)
        for dt in (torch.float64, torch.float32):
            D, L, rhs = (torch.tensor(a, dtype=dt, device=dev) for a in (D_np, L_np, r_np))
            x = block_solve(route, D, L, rhs)
            res = (torch.linalg.vector_norm(block_apply(D, L, x) - rhs.double())
                   / torch.linalg.vector_norm(rhs.double())).item()
            ms = loop_ms(lambda: block_solve(route, D, L, rhs), n=10, warmup=2)
            print(f"  nb={nb}, s={s}, {route}, {dt}: relative residual {res:.3e}, "
                  f"{ms:.3f} ms per solve (mean of 10, CUDA events) [{smi}]")
            check(res < BLOCK_LIMITS[dt] and bool(torch.isfinite(x).all()),
                  f"12a {route} nb={nb} {dt}: relative residual below {BLOCK_LIMITS[dt]:g}")
            if dt == torch.float32:
                kernels = profile_solve(lambda: block_solve(route, D, L, rhs),
                                        f"12a {route} nb={nb} float32 solve", smi)
                print(f"  12a {route} nb={nb}: {kernels} CUDA kernels per solve")
        D_np, L_np, r_np = block_system(1024, s, seed=7 + s)
        xs = [block_solve(route, *(torch.tensor(a, dtype=torch.float64, device=d)
                                   for a in (D_np, L_np, r_np))).cpu()
              for d in (dev, torch.device("cpu"))]
        diff = ((xs[0] - xs[1]).abs().max() / xs[1].abs().max()).item()
        print(f"  nb=1024, s={s}, {route}, float64: card against CPU {diff:.3e} (max "
              "difference over max |x|)")
        check(diff <= 1e-12, f"12a {route}: the card equals the CPU within 1e-12 at nb=1024")


def converge(problem, optimizer, x0, label, smi, reps=3):
    """Solve ``problem`` to convergence from ``x0`` (default tolerances):
    times after a warm-up (best and median of ``reps``), peak allocated
    memory, and one profiler pass. Returns the last raw result."""
    from leastsquaresoptim_jl_torch import Options, solve

    opts = Options(iterations=100)

    def run():
        return solve(problem, optimizer, options=opts, x0=x0)

    run()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    timed = [sync_time(run) for _ in range(reps)]
    peak = torch.cuda.max_memory_allocated()
    ts = [t for t, _ in timed]
    raw = timed[-1][1]
    its, mvps = int(raw["iterations"]), int(raw["mul_calls"])
    print(f"  {label}: converged {bool(raw['converged'])}, {its} LM iterations, "
          f"{mvps} matvecs, ssr {float(raw['ssr'])!r}, {min(ts):.4f} s best, "
          f"{float(np.median(ts)):.4f} s median of {reps}; peak allocated "
          f"{peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB held before) [{smi}]")
    kernels = profile_solve(run, label, smi)
    if kernels is not None:
        print(f"  {label}: {kernels / max(its, 1):.1f} CUDA kernels per LM iteration")
    check(bool(raw["converged"]) and bool(torch.isfinite(raw["minimizer"]).all()),
          f"{label}: converged to a finite minimizer")
    return raw, peak


def oscillatory_start(problem, dev):
    """Phase 9c's start: x0 + 0.1 (-1)^i."""
    sign = torch.where(torch.arange(problem.n, device=dev) % 2 == 0, 1.0, -1.0)
    return problem.x0 + 0.1 * sign


def phase_config4_block_cholesky(dev, smi):
    """12b and 12c: config #4 by BlockCholesky(2) against LSMR, and m = 10^7."""
    from leastsquaresoptim_jl_torch import LSMR, BlockCholesky, LevenbergMarquardt

    problem, _ = config4_problem(10, dev, True)
    x0 = oscillatory_start(problem, dev)
    header(f"== phase 12b: config #4, m={problem.m}, n={problem.n}, float32, closed-form "
          "colnorms_fn, to convergence from phase 9c's start")
    raw_bc, _ = converge(problem, LevenbergMarquardt(BlockCholesky(2)), x0,
                         "12b LM(BlockCholesky(2))", smi)
    raw_ls, _ = converge(problem, LevenbergMarquardt(LSMR(maxiter=60)), x0,
                         "12b LM(LSMR(maxiter=60))", smi)
    diff = (raw_bc["minimizer"] - raw_ls["minimizer"]).abs().max().item()
    print(f"  minimizers differ by {diff:.3e} at most")
    check(diff <= 1e-3, "12b: BlockCholesky's and LSMR's minimizers agree within 1e-3")

    problem10, _ = config4_problem(100, dev, True)
    header(f"== phase 12c: m={problem10.m}, n={problem10.n}, float32, LM(BlockCholesky(2)) "
          "to convergence from the oscillatory start")
    _, peak = converge(problem10, LevenbergMarquardt(BlockCholesky(2)),
                       oscillatory_start(problem10, dev), "12c LM(BlockCholesky(2))",
                       smi, reps=1)
    check(peak < 4e9, "12c: peak allocated memory under 4 GB")
    return raw_bc["minimizer"]


def banded_pattern(blocks, n):
    """config #4's static pattern: row (b, i) touches columns i-1, i, i+1."""
    i = np.arange(n)
    parts = []
    for d in (-1, 0, 1):
        j = i + d
        ok = (j >= 0) & (j < n)
        for b in range(blocks):
            parts.append(np.stack([b * n + i[ok], j[ok]], axis=1))
    return np.concatenate(parts)


def phase_config4_sparse(dev, smi, x_bc):
    """12d: config #4 with a sparse J by colored AD, LM(LSMR)."""
    from leastsquaresoptim_jl_torch import (
        LSMR, LevenbergMarquardt, Options, least_squares_problem, solve, sparse_jacobian)
    from leastsquaresoptim_jl_torch.ops.sparse import color_columns

    blocks, n = 10, CONFIG4_N
    residual_fn, _, x0 = banded_problem(blocks, n, torch.float32, dev)
    m = blocks * n
    header(f"== phase 12d: config #4 with a sparse J (colored AD), m={m}, n={n}, float32")
    t0 = time.perf_counter()
    pattern = banded_pattern(blocks, n)
    t1 = time.perf_counter()
    colors = color_columns(pattern, n)
    t2 = time.perf_counter()
    jac = sparse_jacobian(residual_fn, pattern, m, n)
    problem = least_squares_problem(residual_fn, x0, output_length=m, g=jac)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"  pattern {t1 - t0:.3f} s, coloring alone {t2 - t1:.3f} s, sparse_jacobian "
          f"and the problem (coloring again, one J at x0) {t3 - t2:.3f} s; nse "
          f"{len(pattern)}, ncolors {jac.ncolors}, colors 0..{int(colors.max())}")
    check(jac.ncolors == 3 and problem.jacobian_is_sparse, "12d: 3 colors, a sparse problem")
    xs = oscillatory_start(problem, dev)
    J = jac(xs)
    rng = np.random.default_rng(12)
    worst = 0.0
    for _ in range(4):
        v = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
        ref = torch.func.jvp(residual_fn, (xs,), (v,))[1]
        worst = max(worst, (torch.linalg.vector_norm(torch.mv(J, v) - ref)
                            / torch.linalg.vector_norm(ref)).item())
    print(f"  J v against torch.func.jvp, 4 random v: largest relative difference {worst:.3e}")
    check(worst <= 1e-5, "12d: J v equals the JVP within 1e-5 relative")

    optimizer = LevenbergMarquardt(LSMR(maxiter=60))
    opts = Options(iterations=10, x_tol=0.0, f_tol=0.0, g_tol=0.0)

    def run10():
        return solve(problem, optimizer, options=opts)

    run10()  # warm-up
    ts = [sync_time(run10)[0] for _ in range(3)]
    rate = CONFIG4_RATES.get("closed-form colnorms_fn")
    print(f"  10 LM(LSMR(maxiter=60)) iterations: {10 / min(ts):.3f} LM iterations/s "
          f"(best of 3), {10 / float(np.median(ts)):.3f} (median); phase 9b's "
          f"matrix-free route with closed-form column norms in this run: "
          f"{'not run' if rate is None else f'{rate:.3f}'} [{smi}]")
    raw, peak = converge(problem, optimizer, xs, "12d sparse LM(LSMR(maxiter=60))", smi)
    diff = (raw["minimizer"] - x_bc).abs().max().item()
    print(f"  the sparse route's minimizer differs from 12b's BlockCholesky by {diff:.3e}")
    check(diff <= 1e-3, "12d: minimizer within 1e-3 of 12b's")
    check(raw["jacobian"].layout == torch.sparse_coo
          and raw["jacobian"]._nnz() == len(pattern), "12d: the result's J keeps its pattern")


def phase_batched_block_cholesky(dev, smi):
    """12e: B = 2048 matrix-free broyden_tridiagonal fits by solve_batch."""
    from leastsquaresoptim_jl_torch import BlockCholesky, LevenbergMarquardt, solve_batch
    from leastsquaresoptim_jl_torch.models.minpack import broyden_tridiagonal

    B, n = BATCH_BC, N_BC
    header(f"== phase 12e: solve_batch, B={B} broyden_tridiagonal({n}) fits, matrix-free, "
          "LM(BlockCholesky(2)), float32")
    scale = np.linspace(0.8, 1.2, B)[:, None]

    def run(dt, device, count=B):
        _, f, x0, _ = broyden_tridiagonal(n, dtype=dt, device=device)
        xb = x0[None, :] * torch.tensor(scale[:count], dtype=dt, device=device)
        return solve_batch(f, xb, None, LevenbergMarquardt(BlockCholesky(2)),
                           output_length=n, materialize_jacobian=False)

    run(torch.float32, dev)  # warm-up
    timed = [sync_time(lambda: run(torch.float32, dev)) for _ in range(3)]
    ts = [t for t, _ in timed]
    raw = timed[-1][1]
    conv = raw["converged"].double().mean().item()
    print(f"  batch {min(ts):.4f} s best, {float(np.median(ts)):.4f} s median of 3, "
          f"{B / min(ts):.1f} fits/s (best), lockstep iterations "
          f"{int(raw['iterations'].max())}, converged {conv:.6f}, ssr max "
          f"{raw['ssr'].max().item():.3e} [{smi}]")
    kernels = profile_solve(lambda: run(torch.float32, dev), "12e batch", smi)
    if kernels is not None:
        print(f"  12e: {kernels / int(raw['iterations'].max()):.1f} CUDA kernels per "
              "lockstep iteration")
    check(conv == 1.0, "12e: every fit converged")
    card = run(torch.float64, dev, 64)
    cpu = run(torch.float64, torch.device("cpu"), 64)
    diff = (card["minimizer"].cpu() - cpu["minimizer"]).abs().max().item()
    same = bool((card["iterations"].cpu() == cpu["iterations"]).all())
    print(f"  first 64 fits in float64: card against CPU {diff:.3e}, iterations equal "
          f"{same}")
    check(diff <= 1e-10, "12e: the card equals the CPU within 1e-10 on 64 float64 fits")


def phase_structured(dev, smi):
    """Phase 12: BlockCholesky, sparse J and the batched matrix-free solve;
    no hand-written kernel may launch in it."""
    from leastsquaresoptim_jl_torch.ops import gram
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    t0 = time.perf_counter()
    kv.launches = gram.launches = 0
    phase_block_solves(dev, smi)
    x_bc = phase_config4_block_cholesky(dev, smi)
    phase_config4_sparse(dev, smi, x_bc)
    phase_batched_block_cholesky(dev, smi)
    print(f"  launches on the structured-Jacobian path (12a-12e): kernel_varpro "
          f"{kv.launches}, gram {gram.launches}")
    check(kv.launches == 0 and gram.launches == 0,
          "phase 12 launches neither hand-written kernel (none lies on it)")
    header(f"== phase 12 took {time.perf_counter() - t0:.2f} s")



# -- phase 13: the batched breadth, checkpoints and the entry points ----------

GEO_B, GEO_M, GEO_ITERATIONS = 50_000, 64, 400  # benchmarks/bench_geodesic.py:32-62
CARD_CPU_FITS = 64  # 13a, 13b: the card against the CPU in float64


def geodesic_data(B, seed=0):
    """benchmarks/bench_geodesic.py:38-62: exp_sum_2 decays with close
    rates (a sloppy valley), starts 0.5-2x the truth."""
    rng = np.random.default_rng(seed)
    xd = np.linspace(0.0, 6.0, GEO_M)
    bt = np.stack([rng.uniform(1.0, 4.0, B), rng.uniform(0.45, 0.60, B),
                   rng.uniform(0.5, 2.5, B), rng.uniform(0.75, 1.00, B)], 1)
    Y = (bt[:, :1] * np.exp(-bt[:, 1:2] * xd[None, :])
         + bt[:, 2:3] * np.exp(-bt[:, 3:4] * xd[None, :])).astype(np.float32)
    p0 = (bt * rng.uniform(0.5, 2.0, bt.shape)).astype(np.float32)
    return xd, Y, p0, bt


def card_against_cpu(label, run, dev, counters=("iterations",), rtol=1e-9):
    """``run(device)`` on the card and on the CPU in float64: equal
    per-fit counters, minimizers within ``rtol`` relative."""
    card, cpu = run(dev), run(torch.device("cpu"))
    d = rel(card["minimizer"].cpu(), cpu["minimizer"]).max().item()
    same = {k: bool((card[k].cpu() == cpu[k]).all()) for k in counters}
    print(f"  {label}: the first {CARD_CPU_FITS} fits in float64, card against CPU: "
          f"minimizers max rel diff {d:.3e}, equal {same}")
    check(all(same.values()) and d <= rtol,
          f"{label}: the card equals the CPU ({', '.join(counters)} equal, minimizers "
          f"within {rtol:g})")


def phase_batched_geodesic(dev, smi):
    """13a: curve_fit_batch over exp_sum_2 with plain and geodesic LM."""
    import leastsquaresoptim_jl_torch as lt
    from leastsquaresoptim_jl_torch.models import curve_fit_batch

    xd, Y_np, p0_np, bt = geodesic_data(GEO_B)
    truth = torch.tensor(bt, dtype=torch.float64, device=dev)
    opts = lt.Options(iterations=GEO_ITERATIONS)
    for geo in (False, True):
        opt = lt.LevenbergMarquardt(lt.Cholesky(), geodesic=geo)
        label = f"13a exp_sum_2 LM(Cholesky(), geodesic={geo})"
        header(f"== phase {label}, B={GEO_B}, m={GEO_M}, float32, {GEO_ITERATIONS} "
              "iterations, stop at 99% done")

        def run(device=dev, dtype=torch.float32, count=GEO_B, opt=opt):
            return curve_fit_batch(
                "exp_sum_2", xd, torch.tensor(Y_np[:count], dtype=dtype, device=device),
                torch.tensor(p0_np[:count], dtype=dtype, device=device), optimizer=opt,
                options=opts, min_converged_fraction=FRAC)

        raw, _ = run_route(label, run, smi, GEO_B)
        conv = raw["converged"].double().mean().item()
        err = max_rel(raw["minimizer"], truth).median().item()
        finite = bool(torch.isfinite(raw["minimizer"]).all())
        print(f"  converged {conv:.6f}, median max relative error vs truth {err:.3e}, "
              f"every minimizer finite {finite}")
        check(finite, f"{label}: every minimizer finite")
        card_against_cpu(label, lambda device, run=run: run(device, torch.float64,
                                                            CARD_CPU_FITS), dev)


def saturation_residual_problem(dev):
    """Phase 3's data as tensors on ``dev``: grid, observations, starts and
    truth, and phase 3's options."""
    import leastsquaresoptim_jl_torch as lt

    xdata, Y_np, x0_np, bt = bench_data(B_MAIN, seed=0)
    x = torch.tensor(xdata, dtype=torch.float32, device=dev)
    Y = torch.tensor(Y_np, dtype=torch.float32, device=dev)
    P0 = torch.tensor(x0_np, dtype=torch.float32, device=dev)
    truth = torch.tensor(bt, dtype=torch.float64, device=dev)
    return x, Y, P0, truth, lt.Options(iterations=ITERATIONS, radius=RADIUS, **TOLS)


def phase_batched_lsmr(dev, smi):
    """13b: matrix-free LM(LSMR()) on phase 3's data and on 12e's
    broyden_tridiagonal batch. Returns 13b-1's raw result."""
    import leastsquaresoptim_jl_torch as lt
    from leastsquaresoptim_jl_torch.models.minpack import broyden_tridiagonal

    x, Y, P0, truth, opts = saturation_residual_problem(dev)
    label = "13b LM(LSMR()) matrix-free exp_saturation"
    header(f"== phase {label}, B={B_MAIN}, m={M}, float32, stop at 99% done")

    def run():
        return lt.solve_batch(exp_saturation_residual, P0, (x, Y),
                              lt.LevenbergMarquardt(lt.LSMR()), options=opts,
                              output_length=M, materialize_jacobian=False,
                              min_converged_fraction=FRAC, data_axis=(None, 0))

    raw, _ = run_route(label, run, smi, B_MAIN)
    conv = raw["converged"].double().mean().item()
    err = rel(raw["minimizer"], truth).median().item()
    its = raw["iterations"].double()
    inner = ((raw["mul_calls"].double() - 2.0 * its) / 2.0).sum().item() / its.sum().item()
    print(f"  converged {conv:.6f}, median rel error vs truth {err:.3e}, inner LSMR "
          f"iterations per LM iteration {inner:.3f} (mean over the fit-iterations)")
    check(conv >= 0.99 and err <= 1e-4,
          f"{label}: >= 99% converged, median relative error <= 1e-4")

    B, n = BATCH_BC, N_BC
    scale = np.linspace(0.8, 1.2, B)[:, None]

    def broyden(optimizer, dt=torch.float32, device=dev, count=B):
        _, f, x0, _ = broyden_tridiagonal(n, dtype=dt, device=device)
        xb = x0[None, :] * torch.tensor(scale[:count], dtype=dt, device=device)
        return lt.solve_batch(f, xb, None, optimizer, output_length=n,
                              materialize_jacobian=False)

    label = f"13b LM(LSMR()) matrix-free broyden_tridiagonal({n})"
    header(f"== phase {label}, B={B}, float32 (hashed Hutchinson column norms)")
    raw_bt, _ = run_route(label, lambda: broyden(lt.LevenbergMarquardt(lt.LSMR())), smi, B)
    its = raw_bt["iterations"].double()
    inner = ((raw_bt["mul_calls"].double() - 2.0 * its) / 2.0).sum().item() / its.sum().item()
    ref = broyden(lt.LevenbergMarquardt(lt.BlockCholesky(2)))
    d = (raw_bt["minimizer"] - ref["minimizer"]).abs().max().item()
    conv = raw_bt["converged"].double().mean().item()
    print(f"  converged {conv:.6f}, inner LSMR iterations per LM iteration {inner:.3f}, "
          f"minimizers against 12e's LM(BlockCholesky(2)) max abs diff {d:.3e}")
    check(conv == 1.0 and d <= 1e-3,
          f"{label}: every fit converged, within 1e-3 of LM(BlockCholesky(2))")
    card_against_cpu(label, lambda device: broyden(lt.LevenbergMarquardt(lt.LSMR()),
                                                   torch.float64, device, CARD_CPU_FITS),
                     dev, counters=("iterations", "mul_calls"), rtol=1e-10)
    return raw


def phase_batched_autodiff(dev, smi):
    """13c: phase 3's joint route with reverse mode and central
    differences, beside forward mode."""
    import leastsquaresoptim_jl_torch as lt

    x, Y, P0, truth, opts = saturation_residual_problem(dev)
    for autodiff in ("forward", "reverse", "central"):
        label = f"13c solve_batch LM(Cholesky()) autodiff={autodiff!r}"
        header(f"== phase {label}, B={B_MAIN}, m={M}, float32, stop at 99% done")

        def run(autodiff=autodiff):
            return lt.solve_batch(exp_saturation_residual, P0, (x, Y),
                                  lt.LevenbergMarquardt(lt.Cholesky()), options=opts,
                                  output_length=M, autodiff=autodiff,
                                  min_converged_fraction=FRAC, data_axis=(None, 0))

        raw, _ = run_route(label, run, smi, B_MAIN)
        conv = raw["converged"].double().mean().item()
        err = rel(raw["minimizer"], truth).median().item()
        print(f"  converged {conv:.6f}, median rel error vs truth {err:.3e}")
        check(conv >= 0.99 and err <= 1e-4,
              f"{label}: >= 99% converged, median relative error <= 1e-4")


def phase_structured_entry(dev, smi, minimizer):
    """13d: pytree parameters, checkpoints, entry() and the dry run on the
    card. ``minimizer`` is 13b's (131072, 2) result."""
    import tempfile

    import leastsquaresoptim_jl_torch as lt
    from leastsquaresoptim_jl_torch.entry import entry
    from leastsquaresoptim_jl_torch.models import nist
    from leastsquaresoptim_jl_torch.utils import checkpoint

    d = nist.DATASETS["misra1a"]
    xm = torch.tensor(d["x"], dtype=torch.float64, device=dev)
    ym = torch.tensor(d["y"], dtype=torch.float64, device=dev)
    start = torch.tensor(d["starts"][0], dtype=torch.float64, device=dev)
    flat = lt.optimize(lambda b: ym - nist.MODELS["misra1a"](xm, b), start)
    tree = lt.optimize(
        lambda p: ym - nist.MODELS["misra1a"](xm, torch.stack([p["b1"], p["b2"]])),
        {"b1": start[0], "b2": start[1]})
    got = np.array([tree.minimizer["b1"], tree.minimizer["b2"]])
    diff = float(np.max(np.abs(got - flat.minimizer) / np.abs(flat.minimizer)))
    same = all(getattr(tree, k) == getattr(flat, k)
               for k in ("iterations", "f_calls", "g_calls", "mul_calls", "converged"))
    header(f"== phase 13d: Misra1a from start 1 with {{'b1', 'b2'}} parameters against the flat "
          f"vector: minimizer max rel diff {diff:.3e}, counters equal {same}, iterations "
          f"{tree.iterations}, converged {tree.converged}")
    check(diff <= 1e-12 and same, "13d: the dict fit equals the flat fit (1e-12, counters)")

    def f(z):
        return torch.stack([1 - z[0], 2.0 * (z[1] - z[0] ** 2)])

    with tempfile.TemporaryDirectory() as tmp:
        p = lt.least_squares_problem(f, torch.zeros(2, dtype=torch.float64, device=dev))
        r1 = lt.optimize_problem(p, lt.Dogleg(), iterations=3)
        path = os.path.join(tmp, "ckpt")
        checkpoint.save_pytree(path, {"minimizer": r1.minimizer})
        r2 = lt.optimize_problem(p, lt.Dogleg(), x0=checkpoint.resume_x0(path))
        print(f"  save_pytree after 3 iterations (converged {r1.converged}), resume_x0, "
              f"finish: converged {r2.converged}, ssr {r2.ssr:.3e}, minimizer "
              f"{r2.minimizer.tolist()}")
        check(not r1.converged and r2.converged and r2.ssr <= 1e-10,
              "13d: a solve saved, resumed and finished")

        dcp = os.path.join(tmp, "dcp")
        t0 = time.perf_counter()
        checkpoint.save_pytree_distributed(dcp, {"minimizer": minimizer})
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = checkpoint.load_pytree_distributed(
            dcp, {"minimizer": torch.zeros_like(minimizer)})
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        equal = bool(torch.equal(back["minimizer"], minimizer))
        print(f"  torch.distributed.checkpoint round trip of a {tuple(minimizer.shape)} "
              f"{minimizer.dtype} minimizer on {back['minimizer'].device}: equal {equal}, "
              f"save {t_save:.3f} s, load {t_load:.3f} s [{smi}]")
        check(equal, "13d: the distributed checkpoint round trip is exact")

    fn, args = entry() if dev.type == "cuda" else entry(device=dev)
    out = fn(*args)
    torch.cuda.synchronize()
    shapes = [tuple(o.shape) for o in out]
    print(f"  entry() on {out[0].device}: output shapes {shapes}, finite "
          f"{bool(torch.isfinite(out[0]).all())}, iterations max {int(out[2].max())}")
    check(shapes == [(32, 2), (32,), (32,)] and out[0].device.type == dev.type
          and bool(torch.isfinite(out[0]).all()), "13d: entry() runs on the card")


def phase_batched_breadth(dev, smi):
    """Phase 13: geodesic, LSMR and reverse/central batches, pytrees,
    checkpoints and the entry points; no hand-written kernel may launch."""
    from leastsquaresoptim_jl_torch.ops import gram
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    t0 = time.perf_counter()
    kv.launches = gram.launches = 0
    phase_batched_geodesic(dev, smi)
    minimizer = phase_batched_lsmr(dev, smi)["minimizer"]
    phase_batched_autodiff(dev, smi)
    phase_structured_entry(dev, smi, minimizer)
    print(f"  launches on the batched breadth (13a-13d): kernel_varpro {kv.launches}, "
          f"gram {gram.launches}")
    check(kv.launches == 0 and gram.launches == 0,
          "phase 13 launches neither hand-written kernel (none lies on it)")
    header(f"== phase 13 took {time.perf_counter() - t0:.2f} s")


# -- phase 14: low precision ------------------------------------------------

# The converged share of the JAX package's bfloat16 separable route on the
# first 4096 fits of 14b's data, on the CPU (tools/lowprec_jax_share.py):
# 14b's bfloat16 run must reach it, less one point.
BF16_JAX_SHARE = 0.992188
LOWPREC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}
# 14b's median relative error limits: 1e-4 in float32; 3x the JAX package's
# bfloat16 error on the first 4096 fits (5.313e-03, tools/lowprec_jax_share.py)
# and 4 eps in float16.
LOWPREC_ERR_LIMITS = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2,
                      torch.float16: 3.9e-3}
# 14d: stacked damped systems of fit batches (B, m + n, n), and one system.
MGS_SHAPES = [(131072, 66, 2), (4096, 72, 8), (1024, 320, 64), (64, 640, 128),
              (1, 8192, 256)]


def lowprec_curve(dtype, dev):
    """tests/test_lowprec.py's curve: y = 2 (1 - exp(-x)), 64 points on
    [0.25, 4], start [1.5, 0.7]; (f, x0) in ``dtype`` on ``dev``."""
    x = torch.linspace(0.25, 4.0, 64, dtype=torch.float64).to(dtype=dtype, device=dev)
    y = 2.0 * (1.0 - torch.exp(-x))
    return (lambda b: y - b[0] * (1.0 - torch.exp(-b[1] * x)),
            torch.tensor([1.5, 0.7], dtype=dtype, device=dev))


def lowprec_broyden(n, dtype, dev):
    """Broyden's tridiagonal system, padded in the data's dtype."""
    def f(x):
        z = torch.zeros((1,), dtype=dtype, device=dev)
        return ((3.0 - 2.0 * x) * x - torch.cat([z, x[:-1]])
                - 2.0 * torch.cat([x[1:], z]) + 1.0)
    return f, -torch.ones(n, dtype=dtype, device=dev)


def phase_lowprec_single(dev, smi):
    """14a: tests/test_torch_lowprec.py's single fits on the card against
    the CPU, and the bfloat16 -> float64 polish."""
    import leastsquaresoptim_jl_torch as lt

    cpu = torch.device("cpu")
    grid = []
    for dname in ("bfloat16", "float16"):
        dt = LOWPREC_DTYPES[dname]
        for oname, opt in (("LM", lt.LevenbergMarquardt), ("Dogleg", lt.Dogleg)):
            for sname, solver in (("Cholesky", lt.Cholesky), ("QR", lt.QR), ("LSMR", lt.LSMR)):
                grid.append((f"curve {dname} {oname}({sname}())", opt(solver()),
                             lambda d, dt=dt: lowprec_curve(dt, d)))
        for n in (16, 100):
            for oname, opt, solver in (("LM", lt.LevenbergMarquardt, lt.QR),
                                       ("LM", lt.LevenbergMarquardt, lt.LSMR),
                                       ("Dogleg", lt.Dogleg, lt.LSMR)):
                grid.append((f"broyden({n}) {dname} {oname}({solver.__name__}())",
                             opt(solver()), lambda d, n=n, dt=dt: lowprec_broyden(n, dt, d)))
    header(f"== phase 14a: {len(grid)} low-precision single fits on the card against the CPU")
    t0 = time.perf_counter()
    for label, opt, problem in grid:
        rd = lt.optimize(*problem(dev), opt)
        rc = lt.optimize(*problem(cpu), opt)
        xd = np.asarray(rd.minimizer, np.float64)
        diff = float(np.max(np.abs(xd - np.asarray(rc.minimizer, np.float64))))
        print(f"  {label}: card {rd.iterations} its (converged {rd.converged}), CPU "
              f"{rc.iterations} its (converged {rc.converged}), minimizers max diff "
              f"{diff:.3e} (4 x_tol {4 * rd.x_tol:.3e})")
        check(rd.converged and rc.converged and abs(rd.iterations - rc.iterations) <= 2
              and diff <= 4 * rd.x_tol,
              f"14a {label}: converged on both, iterations within 2, minimizers within 4 x_tol")
    print(f"  14a single fits: {time.perf_counter() - t0:.2f} s [{smi}]")
    r16 = lt.optimize(*lowprec_curve(torch.bfloat16, dev), lt.LevenbergMarquardt(lt.Cholesky()))
    x64 = torch.linspace(0.25, 4.0, 64, dtype=torch.float64, device=dev)
    y64 = 2.0 * (1.0 - torch.exp(-x64))
    rp = lt.polish(lambda b: y64 - b[0] * (1.0 - torch.exp(-b[1] * x64)),
                   torch.tensor(np.asarray(r16.minimizer, np.float64), device=dev))
    err = float(np.max(np.abs(rp.minimizer - np.array([2.0, 1.0])) / np.array([2.0, 1.0])))
    print(f"  bfloat16 fit {r16.minimizer.tolist()} ({r16.iterations} its), float64 polish "
          f"{rp.minimizer.tolist()} ({rp.iterations} its), max rel error {err:.3e}")
    check(r16.converged and rp.converged and err <= 1e-8,
          "14a: bfloat16 -> float64 polish within 1e-8 of the truth")


def phase_lowprec_batch(dev, smi):
    """14b: the curve-fit batch at the main path's size on O(1) data, the
    plain route in float32, bfloat16 and float16 and the kernel route in
    float32 and float16. Each route's counters are set to 0 just before
    its first run and read just after it; then three timed runs. Returns
    the float16 kernel route's launches."""
    from leastsquaresoptim_jl_torch import Cholesky, LevenbergMarquardt, Options, config
    from leastsquaresoptim_jl_torch.models import curve_fit_batch
    from leastsquaresoptim_jl_torch.ops import gram
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    xdata, Y_np, P0_np, bt = lowprec_data(B_MAIN)
    truth = torch.tensor(bt, dtype=torch.float64, device=dev)
    header(f"== phase 14b: curve-fit batch in low precision (B={B_MAIN}, m={M}, O(1) data; "
          f"bfloat16 limit: the JAX package's share {BF16_JAX_SHARE} less 0.01)")
    f16_launches = None
    for dname, dt in LOWPREC_DTYPES.items():
        Y = torch.tensor(Y_np, device=dev).to(dt)
        P0 = torch.tensor(P0_np, device=dev).to(dt)
        err_limit = LOWPREC_ERR_LIMITS[dt]
        conv_limit = BF16_JAX_SHARE - 0.01 if dt == torch.bfloat16 else 0.99
        tols = config.default_tolerances(dt)
        routes = [("plain", lambda Y=Y, P0=P0: curve_fit_batch(
            "exp_saturation", xdata, Y, P0, optimizer=LevenbergMarquardt(Cholesky()),
            options=Options(iterations=ITERATIONS, radius=RADIUS),
            min_converged_fraction=FRAC, separable=True, gridded=True, fused="ssr"))]
        if dt != torch.bfloat16:
            routes.append(("kernel", lambda Y=Y, P0=P0, tols=tols: kv.varpro_lm_p1_kernel_solve(
                "exp_saturation", xdata, Y, P0[:, 1], x_tol=tols[0], f_tol=tols[1],
                g_tol=tols[2], iterations=ITERATIONS, min_converged_fraction=FRAC,
                k_iters=K, radius=RADIUS)))
        for route, run in routes:
            kv.launches = gram.launches = 0
            out = run()
            torch.cuda.synchronize()
            launches, g_launches = kv.launches, gram.launches
            ts = [sync_time(run)[0] for _ in range(3)]
            if route == "plain":
                est = out["minimizer"]
            else:
                est = torch.stack([out["coefficient"], out["alpha"]], dim=-1)
            conv = out["converged"].double().mean().item()
            err = rel(est, truth).median().item()
            best, med = min(ts), float(np.median(ts))
            print(f"  {route} route, {dname}: best {best:.6f} s, median {med:.6f} s of 3; "
                  f"{B_MAIN / best:.1f} fits/s (best); converged {conv:.6f}; median rel "
                  f"error vs truth {err:.3e}; launches kernel_varpro {launches}, gram "
                  f"{g_launches} [{smi}]")
            check(conv >= conv_limit and err <= err_limit,
                  f"14b {route} {dname}: converged >= {conv_limit:.4f}, median rel error "
                  f"<= {err_limit:.3e}")
            if route == "plain":
                check(launches == 0 and g_launches == 0,
                      f"14b plain {dname} launches neither kernel")
            else:
                check(launches > 0, f"14b kernel {dname} launches kernel_varpro")
                if dt == torch.float16:
                    f16_launches = launches
    return f16_launches


def phase_lowprec_launch(dev, smi):
    """14c: one K = 8 launch of the float16 kernel against the float32 one
    on 14b's data, and against its plain version, timed by
    ``interleaved_ms`` in the order float32, float16, float16 plain version
    and back; returns the float16 entry of the kernels line (launches
    filled in by the caller)."""
    from leastsquaresoptim_jl_torch.interop import kernel_state
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    xdata, Y_np, P0_np, _ = lowprec_data(B_MAIN)
    tols = f16_tols()
    header(f"== phase 14c: one K={K} launch, float16 against float32 (B={B_MAIN}, m={M}, "
          f"{kv.lanes_per_fit(M)} lanes; both at float16's tolerances {tols})")
    runs = {}
    for dt, np_dt in ((torch.float32, np.float32), (torch.float16, np.float16)):
        x = torch.tensor(xdata, device=dev).to(dt)
        Y = torch.tensor(Y_np, device=dev).to(dt)
        state0 = torch.tensor(kernel_state(P0_np[:, 1], RADIUS, np_dt), device=dev)
        sk, sr = one_launch("exp_saturation", x, Y, state0, tols)
        if dt == torch.float16:
            check_parity_f16("14c float16 launch against its plain version", sk, sr)
        runs[dt] = (x, Y, state0, sk, sr)
    timers = {dt: lambda dt=dt: launch_ms(kv._launch_kernel, *runs[dt][:3], tols)
              for dt in runs}
    timers["plain"] = lambda: launch_ms(kv._launch_reference, *runs[torch.float16][:3], tols)
    ms, reads = interleaved_ms(timers)
    entry = None
    for dt, (x, Y, state0, sk, sr) in runs.items():
        size = Y.element_size()
        fit_iters = int((sk[:, kv._ITERS] - state0[:, kv._ITERS]).float().sum().item())
        t_bytes, t_ops = varpro_terms(B_MAIN, M, fit_iters, size)
        bound, bound_by = bound_of(t_bytes, t_ops)
        print(f"  {dt}: {ms[dt]:.4f} ms (medians {reads[dt][0]:.4f} and {reads[dt][1]:.4f}; "
              f"{INTERLEAVED}), {fit_iters} fit-iterations; bound {bound:.4f} ms ({bound_by}; "
              f"{size}-byte x, Y and state, operations at the type's peak outside the tensor "
              f"cores), share {bound / ms[dt]:.1%} [{smi}]")
        if dt == torch.float16:
            print(f"  float16 at the card's float16 rate (133.8 TFLOP/s outside the tensor "
                  f"cores, an FMA as two operations): bytes {t_bytes:.4f} ms, operations "
                  f"{t_ops:.4f} ms, binding term {bound_by}; share {bound / ms[dt]:.1%}. "
                  f"Without contraction (each add and multiply one instruction, as the "
                  f"bit-for-bit gate needs) the operations take {2 * t_ops:.4f} ms, share "
                  f"{max(t_bytes, 2 * t_ops) / ms[dt]:.1%}")
            cols = [kv._ALPHA, kv._C]
            entry = dict(max_abs_err=(sk[:, cols].float() - sr[:, cols].float()).abs().max().item(),
                         ms=ms[dt], plain_ms=ms["plain"], bound_ms=bound, bound_by=bound_by,
                         library_ms=None)
            print(f"  float16 plain version {ms['plain']:.4f} ms; float16 / float32 kernel "
                  f"time {ms[torch.float16] / ms[torch.float32]:.3f}")
    f16_ptxas(kv.lanes_per_fit(M), M)
    return entry


def f16_ptxas(lanes, m):
    """Print ptxas's registers and spills of the float16 instance a launch
    at ``lanes`` and m samples runs, and of every float16 instance."""
    from leastsquaresoptim_jl_torch import _build

    ptxas = ptxas_report(_build.build_log)
    S, rep_ = varpro_instance(ptxas, torch.float16, "exp_saturation", lanes, m)
    regs = ("not found" if rep_ is None else
            f"{rep_[0]} registers, spill stores {rep_[1]} B, loads {rep_[2]} B")
    print(f"  ptxas, float16 exp_saturation G={lanes} S={S}: {regs}")
    f16 = {k: v for k, v in ptxas.items() if "varpro_lm_p1_f16_kernel" in k}
    spilling = sorted(k for k, v in f16.items() if v[1] or v[2])
    regs = [v[0] for v in f16.values()] or ["none"]
    print(f"  ptxas, float16: {len(f16)} instances, registers {min(regs)}-{max(regs)}, "
          f"{len(spilling)} with spills {spilling}")
    check(not any(re.search(r"ELi(1|2|4|8|16)ENS_", k) for k in spilling),
          "no float16 instance with runs of S <= 16 spills")


def phase_mgs_timing(dev, smi):
    """14d, a measurement (no gate): float32 MGS QR (the JAX package's
    routing by n) against Householder QR on the card, one timed call of
    each after one warm-up."""
    from leastsquaresoptim_jl_torch.ops import linalg

    header("== phase 14d: float32 MGS against Householder QR (measurement only)")
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, m, n in MGS_SHAPES:
        A = torch.randn(B, m, n, generator=gen, device=dev)
        b = torch.randn(B, m, generator=gen, device=dev)
        ref = torch.linalg.lstsq(A.double(), b.double().unsqueeze(-1)).solution.squeeze(-1)
        line = []
        for label, fn in (("MGS", linalg.mgs_solve_with_diag),
                          ("Householder", linalg.qr_solve_with_diag)):
            x = fn(A, b)[0].double()  # the warm-up, whose answer is held to lstsq
            ms = loop_ms(lambda: fn(A, b), n=1, warmup=0)
            err = (torch.linalg.vector_norm(x - ref, dim=-1)
                   / torch.linalg.vector_norm(ref, dim=-1))
            line.append(f"{label} {ms:.3f} ms (one call), rel error median {err.median().item():.2e} "
                        f"max {err.max().item():.2e}")
        print(f"  ({B}, {m}, {n}): {'; '.join(line)} [{smi}]")
        del A, b, ref


def phase_lowprec(dev, smi):
    """Phase 14: low precision on the card. Returns the float16 entry of
    the kernels line."""
    from leastsquaresoptim_jl_torch.ops import gram
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    t0 = time.perf_counter()
    kv.launches = gram.launches = 0
    phase_lowprec_single(dev, smi)
    check(kv.launches == 0 and gram.launches == 0, "14a launches neither kernel")
    launches = phase_lowprec_batch(dev, smi)
    entry = phase_lowprec_launch(dev, smi)
    phase_mgs_timing(dev, smi)
    header(f"== phase 14 took {time.perf_counter() - t0:.2f} s")
    return {"launches": launches, **entry}


# -- phase 15: the rest of the public surface ---------------------------------

# 15a: limits on max |J_card - J_cpu| / max |J_cpu|, per mode and dtype.
# Forward and reverse mode are exact derivatives; card and CPU differ by the
# rounding of A x (sqrt(n) eps |A| |x|) through tanh'. Central differences
# divide that rounding by 2h = 2 cbrt(eps): their limits are about 9x the
# card-against-CPU difference that this check read on an H100 (2.318e-10 in
# float64, 2.297e-04 in float32; PERF.md section 5).
JACOBIAN_LIMITS = {
    ("forward", torch.float64): 1e-12, ("forward", torch.float32): 1e-5,
    ("reverse", torch.float64): 1e-12, ("reverse", torch.float32): 1e-5,
    ("central", torch.float64): 2e-9, ("central", torch.float32): 2e-3,
}
# 15b: the batched sections' converged shares (10000 fits each) on the card
# and on the CPU may differ by at most 10 fits; the single fits' minimizers
# (float32) by at most 1e-3 relative.
EXAMPLE_SHARE_SLACK = 1e-3
EXAMPLE_MINIMIZER_RTOL = 1e-3
# 15c: the card's minimizer against the CPU's (float32, one process).
DISTRIBUTED_RTOL = 1e-5


def load_example(name):
    """A file of examples/ as a module (the directory is no package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def examples_on_the_cpu():
    """15b and 15c's CPU runs, in a worker process beside the dryrun and
    the card's runs: the curve-fitting tour's main() and the distributed
    solve at world size 1 over gloo, on 4 threads (the dryrun's processes
    keep the other cores). Their printing is dropped."""
    import contextlib
    import io

    torch.set_num_threads(4)
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        tour = load_example("torch_curve_fitting").main("cpu")
        t1 = time.perf_counter()
        raw = load_example("torch_distributed_solve").main("cpu")
        t2 = time.perf_counter()
    return tour, raw["minimizer"].numpy(), bool(raw["converged"]), (t1 - t0, t2 - t1)


def phase_synthesize(dev, smi):
    """15a: synthesize_jacobian in its three modes on config #3's residual
    at x0 (8192 x 1024), float64 and float32: J on the card against J on
    the CPU, and ms per call on the card (after the CPU worker has
    ended)."""
    from leastsquaresoptim_jl_torch.problem import synthesize_jacobian

    cpu = torch.device("cpu")
    header("== phase 15a: synthesize_jacobian on config #3's residual (8192, 1024) at x0")
    for dt in (torch.float64, torch.float32):
        p_dev, p_cpu = config3_problem(dev, dt)[0], config3_problem(cpu, dt)[0]
        exact = synthesize_jacobian(p_cpu.residual_fn, "forward")(p_cpu.x0).double()
        for mode in ("forward", "reverse", "central"):
            jac = synthesize_jacobian(p_dev.residual_fn, mode)
            J = jac(p_dev.x0)  # warm-up
            ts = [sync_time(lambda: jac(p_dev.x0))[0] for _ in range(5)]
            J_cpu = synthesize_jacobian(p_cpu.residual_fn, mode)(p_cpu.x0)
            scale = J_cpu.abs().max().item()
            err = (J.cpu() - J_cpu).abs().max().item() / scale
            err_exact = (J.cpu().double() - exact).abs().max().item() / scale
            limit = JACOBIAN_LIMITS[(mode, dt)]
            print(f"  {mode} {dt}: {1e3 * min(ts):.3f} ms best, "
                  f"{1e3 * float(np.median(ts)):.3f} ms median of 5; card vs CPU "
                  f"{err:.3e} of max |J|, vs the exact J {err_exact:.3e} [{smi}]")
            check(J.shape == (8192, 1024) and J.dtype == dt and J.device == dev
                  and bool(torch.isfinite(J).all()), f"15a {mode} {dt}: finite (8192, 1024) on the card")
            check(err <= limit, f"15a {mode} {dt}: card within {limit:g} of the CPU")


def phase_examples(dev, smi):
    """Phase 15: synthesize_jacobian (15a), the curve-fitting tour (15b)
    and the distributed solve at world size 1 (15c) on the card, each
    held against the CPU; neither hand-written kernel lies on them. First
    the entry point dryrun_multichip(1): the parent only waits on its
    process while the worker makes 15b-15c's CPU runs. 15a-15c run on the
    card once the worker has ended."""
    import multiprocessing

    from leastsquaresoptim_jl_torch.entry import dryrun_multichip
    from leastsquaresoptim_jl_torch.ops import gram
    from leastsquaresoptim_jl_torch.ops import kernel_varpro as kv

    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    kv.launches = gram.launches = 0
    with ctx.Pool(1) as pool:
        cpu_job = pool.apply_async(examples_on_the_cpu)
        header("== phase 15: dryrun_multichip(1), one NCCL rank, beside the CPU worker")
        t1 = time.perf_counter()
        dryrun_multichip(1, device=dev.type)
        print(f"  dryrun_multichip(1) on one rank in {time.perf_counter() - t1:.2f} s")
        t1 = time.perf_counter()
        tour_cpu, x_cpu, conv_cpu, (t_tour_cpu, t_dist_cpu) = cpu_job.get(timeout=300)
        print(f"  waited {time.perf_counter() - t1:.2f} s more for the CPU worker")
    # The card's runs are timed once the worker has ended: their times are
    # bound by host dispatch, which the worker's threads would slow.
    phase_synthesize(dev, smi)
    header("== phase 15b: examples/torch_curve_fitting.py main() on the card")
    t1 = time.perf_counter()
    tour = load_example("torch_curve_fitting").main(str(dev))
    t_tour = time.perf_counter() - t1
    header("== phase 15c: examples/torch_distributed_solve.py main() on the card, one process")
    t1 = time.perf_counter()
    raw = load_example("torch_distributed_solve").main(str(dev))
    t_dist = time.perf_counter() - t1
    launches = (kv.launches, gram.launches)
    print(f"  launches on phase 15: kernel_varpro {launches[0]}, gram {launches[1]}")
    check(launches == (0, 0), "phase 15 launches neither hand-written kernel (none lies on it)")

    print(f"  15b: the tour took {t_tour:.2f} s on the card, {t_tour_cpu:.2f} s on the CPU "
          f"(in a worker on 4 threads beside the dryrun) [{smi}]")
    for key, want in tour_cpu.items():
        got = tour[key]
        if isinstance(want, float):
            print(f"  15b {key}: converged {got:.6f} on the card, {want:.6f} on the CPU")
            check(abs(got - want) <= EXAMPLE_SHARE_SLACK,
                  f"15b {key}: converged shares within {EXAMPLE_SHARE_SLACK:g}")
        else:
            d = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
            print(f"  15b {key}: minimizer {got.tolist()}, max rel diff from the CPU {d:.3e}")
            check(bool(np.all(np.isfinite(got))) and d <= EXAMPLE_MINIMIZER_RTOL,
                  f"15b {key}: finite and within {EXAMPLE_MINIMIZER_RTOL:g} of the CPU")

    x = raw["minimizer"].cpu().numpy()
    d = float(np.max(np.abs(x - x_cpu) / np.abs(x_cpu)))
    print(f"  15c: {t_dist:.2f} s on the card, {t_dist_cpu:.2f} s on the CPU; minimizer "
          f"{x.tolist()} (CPU {x_cpu.tolist()}), max rel diff {d:.3e} [{smi}]")
    check(bool(raw["converged"]) and conv_cpu, "15c converged on the card and on the CPU")
    check(d <= DISTRIBUTED_RTOL, f"15c minimizer within {DISTRIBUTED_RTOL:g} of the CPU's")
    header(f"== phase 15 took {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
