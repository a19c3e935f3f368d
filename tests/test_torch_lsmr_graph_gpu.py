"""One fit's LSMR replayed from a CUDA graph against its eager loop, on the
card (marker ``gpu``; skips without a CUDA GPU).

Every inner solve of a solve runs twice, through ``ops/lsmr_core.lsmr`` as
the solver calls it (``graph=True``: the iteration captured once and
replayed) and with ``graph=False`` (the eager loop), and the two must agree
bit for bit: the solution, ``istop``, ``iterations``, ``mvps`` and both norm
estimates, and so the whole solve. The cases: a banded boundary-value
system solved matrix-free by ``LM(LSMR(maxiter=60))`` (the benchmark's
``bvp1m`` at a fifth of its rows), a dense materialized Jacobian,
``Dogleg(LSMR())``, LM with bounds (the box refinement's solve), and user
closures that read back to the host, whose capture falls back. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_lsmr_graph_gpu.py
"""

import pytest

torch = pytest.importorskip("torch")

import leastsquaresoptim_jl_torch as lt  # noqa: E402
from leastsquaresoptim_jl_torch import tracing  # noqa: E402
from leastsquaresoptim_jl_torch.solver import lsmr as solver_lsmr  # noqa: E402

TOLS = dict(x_tol=1e-6, f_tol=1e-6, g_tol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs are captured on the card only")
    return torch.device("cuda", 0)


def _banded(device, n=20000, blocks=10):
    """The benchmark's banded system (perfbench/routes/solve.py) at n
    parameters, matrix-free with its closed-form column norms."""
    dt = torch.float32
    h = 1.0 / (n + 1)
    t = torch.arange(1, n + 1, dtype=dt, device=device) * h
    s = torch.linspace(0.5, 1.5, blocks, dtype=dt, device=device)

    def residual(x):
        zero = x.new_zeros(1)
        core = 2.0 * x - torch.cat([zero, x[:-1]]) - torch.cat([x[1:], zero])
        src = (x[None, :] + t[None, :] * s[:, None] + 1.0) ** 3
        return (core[None, :] + (h * h / 2.0) * src).reshape(-1)

    def norms(x):
        c = (3.0 * h * h / 2.0) * (x[None, :] + t[None, :] * s[:, None] + 1.0) ** 2
        nb = torch.full_like(x, 2.0 * blocks)
        nb[0] -= float(blocks)
        nb[-1] -= float(blocks)
        return torch.sum((2.0 + c) ** 2, dim=0) + nb

    sign = 1.0 - 2.0 * (torch.arange(n, device=device) % 2).to(dt)
    x0 = t * (t - 1.0) + 0.1 * sign
    problem = lt.matrix_free_problem(residual, x0, output_length=blocks * n, colnorms=norms)
    options = lt.Options(iterations=100, radius=10.0, **TOLS)
    return problem, options, residual, norms, x0


def _dense(device):
    """A dense materialized problem, n = 48 (the matmul form of the products)."""
    g = torch.Generator(device=device).manual_seed(11)
    m, n = 4096, 48
    A = torch.randn(m, n, device=device, generator=g, dtype=torch.float64) / m ** 0.5
    truth = torch.randn(n, device=device, generator=g, dtype=torch.float64)
    y = torch.sin(A @ truth)

    def residual(x):
        return torch.sin(A @ x) - y + 0.05 * x.sum() ** 2

    x0 = truth + 0.3 * torch.randn(n, device=device, generator=g, dtype=torch.float64)
    return lt.least_squares_problem(residual, x0, output_length=m), x0


def _run(solve, monkeypatch, graph):
    """``solve()`` under tracing with every inner LSMR solve run with
    ``graph`` as given (True: as the solver passes it): (result, [(x,
    stats)] of the inner solves, Recorder)."""
    real = solver_lsmr.lsmr
    calls = []

    def spy(*args, **kw):
        if not graph:
            kw["graph"] = False
        x, stats = real(*args, **kw)
        calls.append((x, stats))
        return x, stats

    with monkeypatch.context() as mp:
        mp.setattr(solver_lsmr, "lsmr", spy)
        with tracing.record() as rec:
            out = solve()
        torch.cuda.synchronize()
    return out, calls, rec


def _assert_same(graphed, eager):
    (out_g, calls_g, _), (out_e, calls_e, _) = graphed, eager
    assert len(calls_g) == len(calls_e) > 0
    for (xg, sg), (xe, se) in zip(calls_g, calls_e):
        assert (sg.istop, sg.iterations, sg.mvps) == (se.istop, se.iterations, se.mvps)
        assert torch.equal(xg, xe)
        assert torch.equal(sg.normr, se.normr) and torch.equal(sg.normar, se.normar)
    for key in ("minimizer", "ssr", "iterations", "mul_calls", "inner_istop", "converged"):
        assert torch.equal(torch.as_tensor(out_g[key]), torch.as_tensor(out_e[key])), key


def _graphed_share(rec):
    return rec.count("lso/lsmr/replay") / rec.count("lso/host_read", "lsmr.rules")


def _pair(solve, monkeypatch):
    solve()  # warm: the first solve loads the libraries and fills the caches
    graphed = _run(solve, monkeypatch, True)
    eager = _run(solve, monkeypatch, False)
    _assert_same(graphed, eager)
    return graphed[2], eager[2]


@pytest.mark.gpu
def test_bvp_lm_lsmr_graph_matches_eager(cuda_device, monkeypatch):
    problem, options, *_ = _banded(cuda_device)
    rec, eager = _pair(lambda: lt.solve(problem, lt.LevenbergMarquardt(lt.LSMR(maxiter=60)),
                                        options=options), monkeypatch)
    captures = rec.named("lso/lsmr/capture")
    assert captures and {s.site for s in captures} == {"graph"}
    assert _graphed_share(rec) >= 0.8
    assert eager.count("lso/lsmr/capture") == eager.count("lso/lsmr/replay") == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dense_lm", "dogleg", "lm_bounds"])
def test_graph_matches_eager(cuda_device, monkeypatch, case):
    if case == "dense_lm":
        problem, _ = _dense(cuda_device)
        optimizer, bounds = lt.LevenbergMarquardt(lt.LSMR()), {}
        options = lt.Options(iterations=50)
    else:
        problem, options, _, _, x0 = _banded(cuda_device, n=4000)
        if case == "dogleg":
            optimizer, bounds = lt.Dogleg(lt.LSMR()), {}
        else:
            # A box 0.01 below the start, which the smooth solution
            # leaves on the start's low points: the box refinement's damped
            # solve runs too.
            optimizer = lt.LevenbergMarquardt(lt.LSMR(maxiter=60))
            bounds = dict(lower=x0 - 0.01)
    rec, _ = _pair(lambda: lt.solve(problem, optimizer, options=options, **bounds),
                   monkeypatch)
    assert {s.site for s in rec.named("lso/lsmr/capture")} == {"graph"}
    assert rec.count("lso/lsmr/replay") > 0


@pytest.mark.gpu
def test_host_reading_closure_falls_back(cuda_device, monkeypatch):
    """User products that read a value back to the host cannot be
    captured: every capture falls back and the answers are the eager ones."""
    _, options, residual, norms, x0 = _banded(cuda_device, n=4000)
    reads = []

    def jvp(x, v):
        reads.append(float(v.abs().max()))  # a host read inside the product
        return torch.func.jvp(residual, (x,), (v,))[1]

    def vjp(x, u):
        return torch.func.vjp(residual, x)[1](u)[0]

    problem = lt.matrix_free_problem(residual, x0, output_length=residual(x0).numel(),
                                     jvp=jvp, vjp=vjp, colnorms=norms)
    rec, _ = _pair(lambda: lt.solve(problem, lt.LevenbergMarquardt(lt.LSMR(maxiter=60)),
                                    options=options), monkeypatch)
    captures = rec.named("lso/lsmr/capture")
    assert captures and {s.site for s in captures} == {"fallback"}
    assert rec.count("lso/lsmr/replay") == 0
    _assert_still_captures(cuda_device)


def _assert_still_captures(device):
    """A later solve captures again: the fallback left the graph pool
    usable."""
    problem, options, *_ = _banded(device, n=4000)
    with tracing.record() as rec:
        lt.solve(problem, lt.LevenbergMarquardt(lt.LSMR(maxiter=60)), options=options)
    assert {s.site for s in rec.named("lso/lsmr/capture")} == {"graph"}


@pytest.mark.gpu
def test_default_stream_falls_back(cuda_device):
    """``lsmr`` called on the default stream (not through ``solve``, which
    holds a stream of its own) cannot capture: it falls back, with the
    eager loop's answer."""
    problem, _ = _dense(cuda_device)
    op = lt.ops.operators.from_matrix(problem.jac_fn(problem.x0))
    y = problem.residual_fn(problem.x0)
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    with tracing.record() as rec:
        dx, st = solver_lsmr.solve_gn(op, y)
    assert st.iterations > 1
    assert {s.site for s in rec.named("lso/lsmr/capture")} == {"fallback"}
    real = solver_lsmr.lsmr
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solver_lsmr, "lsmr", lambda *a, **kw: real(*a, **{**kw, "graph": False}))
        dx_e, st_e = solver_lsmr.solve_gn(op, y)
    assert (st.istop, st.iterations) == (st_e.istop, st_e.iterations)
    assert torch.equal(dx, dx_e)
    _assert_still_captures(cuda_device)


@pytest.mark.gpu
def test_graph_memory(cuda_device, monkeypatch):
    """Twenty solves in a row reserve no more memory than the first, and a
    solve's peak allocation is within 3% of the eager loop's."""
    problem, options, *_ = _banded(cuda_device)
    optimizer = lt.LevenbergMarquardt(lt.LSMR(maxiter=60))

    def peak(graph):
        real = solver_lsmr.lsmr
        with monkeypatch.context() as mp:
            if not graph:
                mp.setattr(solver_lsmr, "lsmr", lambda *a, **kw: real(*a, **{**kw, "graph": False}))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            lt.solve(problem, optimizer, options=options)
            torch.cuda.synchronize()
            return torch.cuda.max_memory_allocated()

    reserved = []
    for _ in range(20):
        lt.solve(problem, optimizer, options=options)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert max(reserved) == reserved[0], reserved
    eager, graphed = peak(False), peak(True)
    assert graphed <= 1.03 * eager, (graphed, eager)
