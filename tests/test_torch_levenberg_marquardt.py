"""The LM loop of the PyTorch port (optimizer/levenberg_marquardt.py) on
ONE fit, against the JAX package's optimize_loop: an exp_saturation fit
(n = 2) in float64 under the unfused, fused and fused-"ssr" schedules.
Minimizer to 1e-10 relative, iterations, flags and work counters equal,
and the stored trace (iteration, ssr, maxabs_gr) to 1e-8 relative or
1e-12 absolute (near the optimum ssr and the gradient are tiny sums of
O(1) terms, so reduction order shows at ~1e-15 absolute)."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

from leastsquaresoptim_jl_torch import Cholesky as TChol
from leastsquaresoptim_jl_torch import Options as TOpts
from leastsquaresoptim_jl_torch import least_squares_problem as t_problem
from leastsquaresoptim_jl_torch.optimizer import levenberg_marquardt as tlm
from leastsquaresoptim_jl_tpu import Cholesky as JChol
from leastsquaresoptim_jl_tpu import Options as JOpts
from leastsquaresoptim_jl_tpu.optimizer import levenberg_marquardt as jlm
from leastsquaresoptim_jl_tpu.problem import least_squares_problem as j_problem

X = np.linspace(1.0, 20.0, 12)
Y = 3.0 * (1.0 - np.exp(-0.3 * X))
X0 = np.array([1.5, 0.9])


@pytest.mark.parametrize("fused", [False, True, "ssr"])
def test_single_fit_matches_jax(fused):
    xt, yt = torch.tensor(X), torch.tensor(Y)
    xj, yj = jnp.asarray(X), jnp.asarray(Y)
    pt = t_problem(lambda b: yt - b[0] * (1.0 - torch.exp(-b[1] * xt)),
                   torch.tensor(X0))
    pj = j_problem(lambda b: yj - b[0] * (1.0 - jnp.exp(-b[1] * xj)),
                   jnp.asarray(X0))
    rt = tlm.optimize_loop(pt, TChol(), TOpts(iterations=40, store_trace=True),
                           fused=fused)
    rj = jlm.optimize_loop(pj, JChol(), JOpts(iterations=40, store_trace=True),
                           batched=True, fused=fused)
    np.testing.assert_allclose(rt["minimizer"].numpy(), np.asarray(rj["minimizer"]),
                               rtol=1e-10)
    for key in ("iterations", "converged", "x_converged", "f_converged",
                "g_converged", "f_calls", "g_calls", "mul_calls", "status"):
        assert int(rt[key]) == int(rj[key]), key
    assert bool(rt["converged"])
    np.testing.assert_allclose(rt["trace"].numpy(), np.asarray(rj["trace"]),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(rt["jacobian"].numpy(), np.asarray(rj["jacobian"]),
                               rtol=1e-10)


def test_show_trace_prints_each_iteration(capsys):
    xt, yt = torch.tensor(X), torch.tensor(Y)
    pt = t_problem(lambda b: yt - b[0] * (1.0 - torch.exp(-b[1] * xt)),
                   torch.tensor(X0))
    r = tlm.optimize_loop(pt, TChol(), TOpts(iterations=40, show_trace=True))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == int(r["iterations"]) + 1
