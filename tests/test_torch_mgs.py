"""The modified-Gram-Schmidt QR family of the PyTorch port
(ops/linalg.py: ``unrolled_mgs_solve``, ``blocked_mgs_solve``,
``panel_mgs_solve``) against the JAX package's own, and the
half-precision QR route of ``solver/qr.py`` that takes them.

Shapes: n in {3, 8} (unrolled), {20, 64} (column-blocked), {100, 256}
(panel-blocked; 100 has a ragged last panel of 4), m = 2n + 8, one system
and a leading batch axis of 3, Gaussian data made with numpy.

Limits: against the JAX package, x and |diag(R)| within 1e-12 (float64)
and 1e-5 (float32) relative, x in the 2-norm and |diag(R)| entry by entry
(the same algorithm; only the order of the sums differs). bfloat16 and
float16, which the JAX package's functions also take but whose fused
XLA arithmetic rounds elsewhere than torch's eager ops, are held to a
float64 ``lstsq`` of the rounded data: x within 2 eps cond(A) and
|diag(R)| within 2 eps of the float64 QR's (measured at most 0.76 eps
cond(A) and 0.76 eps on these shapes).
"""

import pytest

from _torch_cpu import torch

import jax
import jax.numpy as jnp
import numpy as np

from leastsquaresoptim_jl_torch.ops import linalg as tl
from leastsquaresoptim_jl_torch.solver import qr as tqr
from leastsquaresoptim_jl_tpu.ops import linalg as jl
from leastsquaresoptim_jl_tpu.solver import qr as jqr

ROUTES = [("unrolled_mgs_solve", 3), ("unrolled_mgs_solve", 8),
          ("blocked_mgs_solve", 20), ("blocked_mgs_solve", 64),
          ("panel_mgs_solve", 100), ("panel_mgs_solve", 256)]
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _system(n, batch, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    m = 2 * n + 8
    return rng.standard_normal(batch + (m, n)), rng.standard_normal(batch + (m,))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name,n", ROUTES)
def test_mgs_matches_jax(name, n, dtype):
    """The port on the batch of 3 and on its first system alone, against
    the JAX package on the batch (jitted, as its solvers call it)."""
    A, b = _system(n, (3,))
    xj, rj = jax.jit(getattr(jl, name))(jnp.asarray(A, dtype), jnp.asarray(b, dtype))
    xj, rj = np.asarray(xj, np.float64), np.asarray(rj, np.float64)
    At, bt = torch.tensor(A.astype(dtype)), torch.tensor(b.astype(dtype))
    for sl in (slice(None), 0):
        xt, rt = getattr(tl, name)(At[sl], bt[sl])
        assert xt.dtype == At.dtype and xt.shape == At[sl].shape[:-2] + (n,)
        err = (np.linalg.norm(xt.double().numpy() - xj[sl], axis=-1)
               / np.linalg.norm(xj[sl], axis=-1))
        assert np.all(err <= RTOL[dtype]), err
        np.testing.assert_allclose(rt.double().numpy(), rj[sl], rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("name,n", ROUTES)
def test_mgs_half_precision_against_lstsq(name, n, dtype):
    A, b = _system(n, (3,))
    At, bt = torch.tensor(A).to(dtype), torch.tensor(b).to(dtype)
    x, rdiag = getattr(tl, name)(At, bt)
    assert x.dtype == dtype and rdiag.dtype == dtype
    eps = torch.finfo(dtype).eps
    A64, b64 = At.double().numpy(), bt.double().numpy()
    for i in range(A.shape[0]):
        ref = np.linalg.lstsq(A64[i], b64[i], rcond=None)[0]
        bound = 2.0 * eps * np.linalg.cond(A64[i])
        err = np.linalg.norm(x[i].double().numpy() - ref) / np.linalg.norm(ref)
        assert err <= bound, (i, err, bound)
        r_ref = np.abs(np.diag(np.linalg.qr(A64[i])[1]))
        np.testing.assert_allclose(rdiag[i].double().numpy(), r_ref, rtol=2.0 * eps)


def test_mgs_route_by_n_and_its_end(monkeypatch):
    """mgs_solve_with_diag takes the JAX package's routing by n and
    refuses n > 256 (where the JAX package's Householder QR refuses half
    precision)."""
    called = []
    for name in ("unrolled_mgs_solve", "blocked_mgs_solve", "panel_mgs_solve"):
        monkeypatch.setattr(tl, name, lambda A, b, name=name: called.append(name))
    for n, name in ((8, "unrolled_mgs_solve"), (9, "blocked_mgs_solve"),
                    (64, "blocked_mgs_solve"), (65, "panel_mgs_solve"),
                    (256, "panel_mgs_solve")):
        tl.mgs_solve_with_diag(torch.zeros(n + 8, n, dtype=torch.float16),
                               torch.zeros(n + 8, dtype=torch.float16))
        assert called.pop() == name
    with pytest.raises(ValueError, match=r"n = 257.*torch.float16"):
        tl.mgs_solve_with_diag(torch.zeros(300, 257, dtype=torch.float16),
                               torch.zeros(300, dtype=torch.float16))


def test_float32_and_float64_keep_householder():
    """solver/qr.py routes float32 and float64 to Householder QR as
    before: the damped solve equals qr_solve_with_diag bit for bit."""
    A, b = _system(20, ())
    for dt in (torch.float32, torch.float64):
        J, y = torch.tensor(A[:40]).to(dt), torch.tensor(b[:40]).to(dt)
        damp = torch.full((20,), 0.1, dtype=dt)
        dx, _ = tqr.solve_damped(J, y, damp)
        stacked = torch.cat([J, torch.diag_embed(torch.sqrt(damp))], dim=-2)
        ref, _ = tl.qr_solve_with_diag(stacked, torch.cat([y, torch.zeros_like(damp)]))
        assert torch.equal(dx, ref)


@pytest.mark.parametrize("n", [4, 20])
def test_damped_overflow_gives_nan_in_half_precision(n):
    """The JAX package's float32 overflow case (tests/test_factor.py:138):
    a column norm that overflows gives R_jj = inf and q_j = 0, a silently
    finite zero step, which the damped MGS route turns into NaN. The
    port's MGS route (float16, bfloat16) does the same: in float16 the
    squared column norm overflows above 256, in bfloat16 (float32's
    range) at the JAX test's 1e20. The port's float32 stays on
    Householder QR, whose scaled column norms do not overflow: it returns
    the finite step 1e20 / (1e40 + 1), where the JAX package's float32
    MGS returns NaN."""
    y = torch.ones(n, dtype=torch.float16)
    damp = torch.ones(n, dtype=torch.float16)
    J = torch.eye(n, dtype=torch.float16) * 300.0  # 300^2 > 65504
    dx, _ = tqr.solve_damped(J, y, damp)
    assert not torch.isfinite(dx).any()
    Jb = torch.eye(n, dtype=torch.bfloat16) * 1e20  # 1e40 > bf16's max
    dx, _ = tqr.solve_damped(Jb, y.to(torch.bfloat16), damp.to(torch.bfloat16))
    assert not torch.isfinite(dx).any()
    # The JAX package's own case, float32, in both packages.
    dxj, _ = jqr.solve_damped(jnp.eye(4, dtype=jnp.float32) * jnp.float32(1e20),
                              jnp.ones(4, jnp.float32), jnp.ones(4, jnp.float32))
    assert not np.isfinite(np.asarray(dxj)).any()
    dxt, _ = tqr.solve_damped(torch.eye(4) * 1e20, torch.ones(4), torch.ones(4))
    np.testing.assert_allclose(dxt.numpy(), 1e-20, rtol=1e-6)
    # Below the overflow the half-precision step is finite and right.
    J = torch.eye(n, dtype=torch.float16) * 200.0
    dx, _ = tqr.solve_damped(J, y, damp)
    np.testing.assert_allclose(dx.double().numpy(), 200.0 / (200.0**2 + 1.0), rtol=2e-3)
