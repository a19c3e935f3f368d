"""The fused p = 2 VarPro evaluation of gridded exponential sums
(``ops/varpro_exp2.py``) on the CPU, where its plain version runs.

- The plain version against the path it replaces: the vmapped
  ``reduced_residual`` with ``jacfwd``, ``gram_and_rhs`` and
  ``sumabs2_dd``, on the gridded basis (the power ladder) and on the plain
  ``exp`` basis, in float64 and float32.
- The arm of every kind of fit (QR, normal equations, dead, non-finite
  rates), chosen as ``models/separable._coefficients_and_residual``
  chooses it.
- The routing of ``curve_fit_batch``: with the device test patched so
  that the CPU counts as the card and the launch counted around the plain
  version (as a rehearsal of the kernel route), only a linear-loss,
  unweighted, float32 gridded ``exp_sum_2`` batch launches; the span
  ``lso/eval/gram`` names where each evaluation ran.
- A 2,048-pixel FLIM frame through the route and through the eager path
  under LM and Dogleg.
- ``sat131k``'s p = 1 path bit for bit as the code before the route gave
  it.
- The benchmark's two readers of the route: ``exp2_eval_share.flim`` and
  ``exp2_eval_roofline.flim``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import leastsquaresoptim_jl_torch as lt  # noqa: E402
from leastsquaresoptim_jl_torch import tracing  # noqa: E402
from leastsquaresoptim_jl_torch.models import separable as sp  # noqa: E402
from leastsquaresoptim_jl_torch.ops import varpro_exp2 as ve  # noqa: E402
from leastsquaresoptim_jl_torch.ops.gram import gram_and_rhs  # noqa: E402
from leastsquaresoptim_jl_torch.ops.linalg import sumabs2_dd  # noqa: E402

PERIOD = 12.5


def _decays(B, m, dtype, seed, t0=0.0, spread=0.3):
    """B FLIM-like decays on x_i = t0 + i 12.5 / m and rates perturbed by
    up to ``spread`` of the truth (separated: the QR arm)."""
    rng = np.random.default_rng(seed)
    dt = PERIOD / m
    x = t0 + dt * np.arange(m)
    k = np.stack([rng.uniform(0.3, 0.6, B), rng.uniform(1 / 0.6, 1 / 0.3, B)], 1)
    amp = rng.uniform(100.0, 1000.0, (B, 2))
    Y = amp[:, :1] * np.exp(-k[:, :1] * x) + amp[:, 1:] * np.exp(-k[:, 1:] * x)
    alpha = k * rng.uniform(1 - spread, 1 + spread, (B, 2))
    return (torch.as_tensor(Y, dtype=dtype), torch.as_tensor(alpha, dtype=dtype), t0, dt)


def _eager(Y, alpha, t0, dt, gridded):
    """What the vmapped path gives: r, J (jacfwd), J'J, J'r, the dd SSR."""
    m = Y.shape[-1]
    sep = sp.gridded_separable("exp_sum_2", t0, dt, m) if gridded else sp.SEPARABLE["exp_sum_2"]
    x = torch.as_tensor(t0 + dt * np.arange(m), dtype=Y.dtype)
    f = sp.reduced_residual(sep, weighted=False)
    r = torch.func.vmap(f, in_dims=(0, (None, 0)))(alpha, (x, Y))
    J = torch.func.vmap(torch.func.jacfwd(f), in_dims=(0, (None, 0)))(alpha, (x, Y))
    G, b = gram_and_rhs(J, r)
    return r, J, G, b, sumabs2_dd(r)


def _eager_arm(Y, alpha, t0, dt):
    """The arm ``_coefficients_and_residual`` takes on the plain-exp basis:
    its dead test, then ``_qr_route`` on the detached basis."""
    m = Y.shape[-1]
    x = torch.as_tensor(t0 + dt * np.arange(m), dtype=Y.dtype)
    P = torch.stack([torch.exp(-alpha[:, :1] * x), torch.exp(-alpha[:, 1:] * x)], dim=-1)
    eps, tiny = torch.finfo(Y.dtype).eps, torch.finfo(Y.dtype).tiny
    alive = torch.mean(torch.sum(P * P, dim=-2), dim=-1) > sp._dead_norm2(Y.dtype)
    P = torch.where(alive[:, None, None], P, torch.eye(m, 2, dtype=Y.dtype))
    G = P.mT @ P
    scale2 = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / 2
    ok, _, _ = sp._qr_route(P, Y, (eps * scale2 + tiny) * eps)
    return torch.where(alive, torch.where(ok, ve.QR, ve.NORMAL), ve.DEAD)


# The plain version against the vmapped path, per fit:
# - float64: both exact to rounding; measured at most 2.7e-13 (the
#   residual, on its largest entry) over 36 batches;
# - float32: expf against the power ladder (a few ulps either way) and
#   sums of m terms in two orders (up to m eps = 3.1e-5 of the largest
#   term at m = 256). The residual and J'r are differences of terms of
#   the observations' size, so r is held on max |y| and J'r on |J_k| |r|
#   (Cauchy-Schwarz); J and J'J on their largest entry; the SSR, a sum of
#   such squares, relative. Measured at most 5.0e-5 over 36 batches; held
#   to 8 m eps at m = 256.
RTOL = {torch.float64: 1e-10, torch.float32: 2.5e-4}


@pytest.mark.parametrize("gridded", [True, False], ids=["ladder", "exp"])
@pytest.mark.parametrize("m", [256, 37, 300])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_plain_version_matches_the_vmapped_path(dtype, m, gridded):
    Y, alpha, t0, dt = _decays(48, m, dtype, seed=m)
    G, b, hi, lo, arm = ve._gram_plain(Y, alpha, t0, dt)
    r, J, _ = ve._jacobian_plain(Y, alpha, t0, dt)
    assert bool((arm == ve.QR).all())
    r0, J0, G0, b0, (hi0, lo0) = _eager(Y, alpha, t0, dt, gridded)
    tol = RTOL[dtype]
    assert ((r - r0).abs().amax(-1) / Y.abs().amax(-1)).max() <= tol
    assert ((J - J0).abs().amax((-2, -1)) / J0.abs().amax((-2, -1))).max() <= tol
    assert ((G - G0).abs().amax((-2, -1)) / G0.abs().amax((-2, -1))).max() <= tol
    scale = J0.norm(dim=-2) * r0.norm(dim=-1, keepdim=True)
    assert ((b - b0).abs() / scale).max() <= tol
    assert (((hi + lo) - (hi0 + lo0)).abs() / hi0).max() <= tol
    # The modes agree with each other, and with the public wrappers.
    assert torch.equal(torch.stack([J[..., 0], J[..., 1]], -1), J)
    for got, want in zip(ve.evaluate_gram(Y, alpha, t0, dt), (G, b, hi, lo)):
        assert torch.equal(got, want)
    r2, J2 = ve.evaluate_jacobian(Y, alpha, t0, dt)
    assert torch.equal(r2, r) and torch.equal(J2, J)
    assert torch.equal(ve.evaluate_jacobian(Y, alpha, t0, dt, jacobian=False), r)


# One fit of each kind on x_i = 0.5 + i 12.5 / 256: separated rates (QR),
# near-equal and equal rates (normal equations: the second column does
# not survive orthogonalisation), rates whose basis underflows (dead:
# 300 in float32, 1000 in float64), a NaN rate (dead: the norm test is
# False on NaN), an infinite rate (its column is zero: normal equations)
# and a negative infinite one (an infinite column: normal equations,
# non-finite results).
def _hard_cases(dtype):
    big = 300.0 if dtype == torch.float32 else 1000.0
    near = 1e-7 if dtype == torch.float32 else 1e-15
    return np.array([[0.5, 2.0], [1.0, 1.0 + near], [1.0, 1.0], [big, 1.5 * big],
                     [np.nan, 1.0], [np.inf, 1.0], [-np.inf, 1.0]])


ARMS = [ve.QR, ve.NORMAL, ve.NORMAL, ve.DEAD, ve.DEAD, ve.NORMAL, ve.NORMAL]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_each_arm_as_the_eager_path_chooses_it(dtype):
    m, t0 = 256, 0.5
    alpha = torch.as_tensor(_hard_cases(dtype), dtype=dtype)
    Y, _, _, dt = _decays(len(alpha), m, dtype, seed=3, t0=t0)
    G, b, hi, lo, arm = ve._gram_plain(Y, alpha, t0, dt)
    r, J, _ = ve._jacobian_plain(Y, alpha, t0, dt)
    assert arm.tolist() == ARMS
    assert torch.equal(arm, _eager_arm(Y, alpha, t0, dt))
    r0, J0, G0, b0, (hi0, lo0) = _eager(Y, alpha, t0, dt, gridded=False)
    tol = RTOL[dtype]
    ys = Y.abs().amax(-1)
    # QR: everything (fit 0).
    assert (r[0] - r0[0]).abs().max() / ys[0] <= tol
    assert (J[0] - J0[0]).abs().max() / J0[0].abs().max() <= tol
    # Normal equations on (numerically) one column: the residual and the
    # SSR are determined; how the coefficients split between the two
    # columns, and so J, is rounding in either path.
    for i in (1, 2, 5):
        assert (r[i] - r0[i]).abs().max() / ys[i] <= tol
        assert abs(float(hi[i] + lo[i]) - float(hi0[i] + lo0[i])) / float(hi0[i]) <= tol
    # Dead: r = y, J = 0, J'J = 0, J'r = 0, SSR = sum y^2, as in the
    # eager path.
    for i in (3, 4):
        assert torch.equal(r[i], Y[i]) and torch.equal(r0[i], Y[i])
        assert not J[i].any() and not J0[i].any()
        assert not G[i].any() and not b[i].any()
        assert abs(float(hi[i] + lo[i]) - float(hi0[i] + lo0[i])) <= tol * float(hi0[i])
    # The negative infinite rate: non-finite in both paths.
    assert not bool(torch.isfinite(r[6]).all()) and not bool(torch.isfinite(r0[6]).all())


def test_wrappers_check_their_inputs():
    Y, alpha, t0, dt = _decays(4, 64, torch.float32, seed=1)
    with pytest.raises(ValueError, match="alpha"):
        ve.evaluate_gram(Y, alpha[:, :1], t0, dt)
    with pytest.raises(ValueError, match="m <= 512"):
        ve.evaluate_gram(torch.zeros(2, 513), torch.ones(2, 2), t0, dt)
    with pytest.raises(ValueError, match="no exp2 evaluation"):
        ve.evaluate_gram(Y.to("meta"), alpha.to("meta"), t0, dt)
    assert ve.layout(37) == (32, 1) and ve.layout(256) == (32, 2) and ve.layout(512) == (32, 4)


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernel route rehearsed on the CPU: every tensor counts as the
    card's and each launch runs the plain version, counted."""

    def launch(*args, **kwargs):
        ve.launches += 1
        ve._launch_reference(*args, **kwargs)

    monkeypatch.setattr(ve, "on_card", lambda t: True)
    monkeypatch.setattr(ve, "_launch_kernel", launch)
    monkeypatch.setattr(ve, "launches", 0)


def _flim(B, m=256, dtype=torch.float32, seed=5):
    """B noise-free FLIM decays as the benchmark draws them: (x, Y)."""
    rng = np.random.default_rng(seed)
    x = np.arange(m) * (PERIOD / m)
    peak, fast = rng.uniform(200, 2000, B), rng.uniform(0.5, 0.85, B)
    tf, ts = rng.uniform(0.3, 0.6, B), rng.uniform(1.5, 3.5, B)
    Y = (((1 - fast) * peak)[:, None] * np.exp(-x / ts[:, None])
         + (fast * peak)[:, None] * np.exp(-x / tf[:, None]))
    return torch.as_tensor(x, dtype=dtype), torch.as_tensor(Y, dtype=dtype)


OPTIONS = dict(iterations=50, radius=10.0, x_tol=1e-6, f_tol=1e-6, g_tol=1e-5)


def _fit(x, Y, model="exp_sum_2", p0="auto", optimizer=None, options=None, **kw):
    args = dict(separable=True, gridded=True, fused="ssr", min_converged_fraction=0.99,
                optimizer=optimizer or lt.LevenbergMarquardt(lt.Cholesky()),
                options=options or lt.Options(**OPTIONS))
    args.update(kw)
    return lt.curve_fit_batch(model, x, Y, p0, **args)


def test_the_route_launches_once_an_evaluation(kernel_route):
    x, Y = _flim(32)
    with tracing.record() as rec:
        r = _fit(x, Y)
    iters = int(r["iterations"].max())
    # The lockstep evaluations, the seed and the final Jacobian.
    assert ve.launches == iters + 2
    assert rec.count("lso/eval/gram", "kernel") == iters + 1
    assert rec.count("lso/eval/gram", "eager") == 0
    assert r["jacobian"].shape == (32, 256, 2)
    # A SeparableModel that describes its grid routes without gridded=True.
    ve.launches = 0
    dt = PERIOD / 256
    r = _fit(x, Y, model=sp.exp_sum_separable(2, t0=0.0, dt=dt, m=256), gridded=False)
    assert ve.launches == int(r["iterations"].max()) + 2


def _p1(x, Y):
    p0 = torch.tensor([1000.0, 0.5]).expand(Y.shape[0], 2)
    return _fit(x, Y, model="exp_saturation", p0=p0)


OTHERS = {
    "exp_saturation": _p1,
    "float64": lambda x, Y: _fit(x.double(), Y.double()),
    "bfloat16": lambda x, Y: _fit(x, Y.to(torch.bfloat16), options=lt.Options(iterations=3)),
    "weighted": lambda x, Y: _fit(x, Y, weights=torch.ones_like(Y)),
    "soft_l1": lambda x, Y: _fit(x, Y, loss="soft_l1", irls_iterations=2),
    "exp_sum_3": lambda x, Y: _fit(x, Y, model="exp_sum_3", options=lt.Options(iterations=3)),
    "geodesic": lambda x, Y: _fit(x, Y, fused=False, options=lt.Options(iterations=3),
                                  optimizer=lt.LevenbergMarquardt(lt.Cholesky(), geodesic=True)),
    "m_513": lambda x, Y: _fit(torch.arange(513.0) * 0.01, torch.cat([Y, Y, Y[:, :1]], -1),
                               options=lt.Options(iterations=3)),
}


@pytest.mark.parametrize("case", sorted(OTHERS))
def test_other_inputs_keep_the_vmapped_path(kernel_route, case):
    x, Y = _flim(16)
    with tracing.record() as rec:
        OTHERS[case](x, Y)
    assert ve.launches == 0
    assert rec.count("lso/eval/gram", "kernel") == 0


@pytest.mark.parametrize("name, fused", [("LM", "ssr"), ("Dogleg", "ssr"),
                                         ("LM", True), ("Dogleg", None)])
def test_flim_frame_against_the_eager_path(kernel_route, name, fused):
    """2,048 pixels (512 under the other schedules) through the route and
    through the vmapped path on the same basis arithmetic (``exp``, as the kernel's ``expf``; the gridded
    power ladder's own rounding makes Dogleg take 29 lockstep iterations
    on this frame against 3), under each schedule (the unfused one takes
    r and J from Jacobian mode and the trial residual from residual
    mode): the same iterations to one, and the minimizers of the pixels
    both converge within the float32 port's tolerance
    (tests/test_torch_flim_biexp.py: 2e-5)."""
    x, Y = _flim(2048 if fused == "ssr" else 512)
    optimizer = (lt.LevenbergMarquardt if name == "LM" else lt.Dogleg)(lt.Cholesky())
    k = _fit(x, Y, optimizer=optimizer, fused=fused)
    iters = int(k["iterations"].max())
    assert ve.launches == (iters + 2 if fused else 2 * iters + 2)
    e = _fit(x, Y, model=sp.SEPARABLE["exp_sum_2"], gridded=False, optimizer=optimizer,
             fused=fused)
    assert abs(int(k["iterations"].max()) - int(e["iterations"].max())) <= 1
    assert float(k["converged"].double().mean()) >= 0.99
    assert float(e["converged"].double().mean()) >= 0.99
    both = k["converged"] & e["converged"]
    rel = ((k["minimizer"] - e["minimizer"]).abs() / e["minimizer"].abs()).amax(-1)
    assert float(rel[both].max()) <= 2e-5


def _reader(monkeypatch, name):
    """``read(run)`` of the benchmark's metric ``name``
    (``perfbench/metrics/<name>.py``)."""
    import importlib.util
    from pathlib import Path

    bench = Path(__file__).resolve().parents[1] / "perfbench"
    monkeypatch.syspath_prepend(str(bench))
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), bench / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("route", ["kernel", "eager"])
def test_share_reader(monkeypatch, request, route):
    """``exp2_eval_share.flim`` over the spans of real calls: 100 on the
    kernel route (rehearsed), 0 on the vmapped path; None where the
    program records no such span, as the parent commit's."""
    import types

    if route == "kernel":
        request.getfixturevalue("kernel_route")
    x, Y = _flim(16)
    with tracing.record() as rec:
        _fit(x, Y)
    read = _reader(monkeypatch, "exp2_eval_share.flim")
    cell = types.SimpleNamespace(chips=1)
    assert read(types.SimpleNamespace(spans=rec, cell=cell)) == (
        100.0 if route == "kernel" else 0.0)
    assert read(types.SimpleNamespace(spans=tracing.Recorder(), cell=cell)) is None


def test_roofline_reader(monkeypatch):
    """``exp2_eval_roofline.flim`` on a hand-made device trace: the
    launches' bound, Y read once at the HBM peak, over their device time;
    another kernel's time is not the kernel's; None without a launch."""
    import types

    read = _reader(monkeypatch, "exp2_eval_roofline.flim")
    from harness import trace

    name = "void lso_exp2::varpro_exp2_eval<2, 0>(float const*, float const*, int, int)"
    events = [(name, 0, 200_000), ("elementwise_kernel", 200_000, 900_000),
              (name, 1_000_000, 1_200_000)]
    config = {"batch": 65536, "points": 256, "dtype": "float32"}

    def run(ev):
        return types.SimpleNamespace(trace=trace.Trace(ev, 1.0),
                                     cell=types.SimpleNamespace(config=config))

    bound_ms = 65536 * 256 * 4 / 3.35e9  # 0.0200 ms a launch
    assert read(run(events)) == pytest.approx(100.0 * bound_ms / 0.2)
    assert read(run(events[1:2])) is None
    assert read(types.SimpleNamespace(trace=None)) is None


# sat131k's p = 1 path (exp_saturation, gridded, fused="ssr", LM(Cholesky))
# on 16 fits of 64 samples: the float32 bits of the minimizer, the SSR and
# the gradient, as the code before the kernel route gave them.
GOLDEN = {
    "minimizer": [
        1124693622, 1066964441, 1118910591, 1054492597, 1112907591, 1047585534,
        1123471693, 1067565149, 1124591373, 1052816276, 1123941799, 1049909062,
        1122583374, 1052092075, 1112501293, 1053131369, 1112075809, 1060873537,
        1125313538, 1067906085, 1124653426, 1062551412, 1123364371, 1067811326,
        1115891008, 1057350454, 1117075061, 1047155205, 1115103616, 1066347518,
        1124075586, 1049213163],
    "ssr": [
        839226368, 820695040, 811372352, 826953728, 827251968, 825905408, 834664576,
        808115456, 813503488, 832391168, 839823360, 825315328, 821361152, 810669056,
        806195200, 834997760],
    "maxabs_gr": [
        1012794369, 993465923, 982086998, 991729471, 1010702729, 971091677,
        1011543989, 978221601, 992489152, 1001873180, 1000488913, 987429642,
        975887386, 952738077, 961402143, 1006722232],
}


def _sat_golden_case():
    rng = np.random.default_rng(20261018)
    B, m = 16, 64
    x = np.linspace(0.0, 5.0, m)
    b0, b1 = rng.uniform(50.0, 150.0, B), rng.uniform(0.2, 1.5, B)
    Y = b0[:, None] * (1.0 - np.exp(-b1[:, None] * x))
    P0 = np.stack([b0 * rng.uniform(0.7, 1.3, B), b1 * rng.uniform(0.6, 1.4, B)], 1)
    return (torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(Y, dtype=torch.float32),
            torch.as_tensor(P0, dtype=torch.float32))


def test_p1_path_keeps_its_bits(kernel_route):
    x, Y, P0 = _sat_golden_case()
    with tracing.record() as rec:
        r = lt.curve_fit_batch(
            "exp_saturation", x, Y, P0, separable=True, gridded=True, fused="ssr",
            optimizer=lt.LevenbergMarquardt(lt.Cholesky()), options=lt.Options(iterations=50),
            min_converged_fraction=0.99)
    for key, bits in GOLDEN.items():
        assert r[key].contiguous().view(torch.int32).flatten().tolist() == bits, key
    assert ve.launches == 0
    assert rec.count("lso/eval/gram", "eager") == int(r["iterations"].max()) + 1
