"""Checkpoint and resume in the PyTorch port (utils/checkpoint.py), against
the JAX package's files where they meet, in float64 on the CPU.

tests/test_api.py:131-160 ported: stop a solve early, save the iterate,
resume from it and finish; a structure mismatch with an equal leaf count
is a ValueError. The distributed checkpoint (``torch.distributed
.checkpoint``) round trip stands in for test_api.py:218-231's Orbax one.
Across packages: ``resume_x0`` reads either package's file (both write
``key_minimizer``), and ``load_pytree`` refuses a JAX-written file by
name.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

import leastsquaresoptim_jl_torch as lt
from leastsquaresoptim_jl_torch.utils import checkpoint
from leastsquaresoptim_jl_tpu.utils import checkpoint as jax_checkpoint

F64 = torch.float64


def _f(x):
    return torch.stack([1 - x[0], 2.0 * (x[1] - x[0] ** 2)])


def test_resume_from_x0_and_checkpoint(tmp_path):
    p = lt.least_squares_problem(_f, torch.zeros(2, dtype=F64))
    r1 = lt.optimize_problem(p, lt.Dogleg(), iterations=3)
    assert not r1.converged
    path = str(tmp_path / "ckpt")
    checkpoint.save_pytree(path, {"minimizer": r1.minimizer})
    x_resume = checkpoint.resume_x0(path)
    np.testing.assert_array_equal(x_resume, r1.minimizer)
    r2 = lt.optimize_problem(p, lt.Dogleg(), x0=x_resume)
    assert r2.converged and r2.ssr <= 1e-10
    np.testing.assert_allclose(r2.minimizer, [1.0, 1.0], atol=1e-6)
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load_pytree(path, {"renamed": r1.minimizer})


def test_raw_result_round_trip(tmp_path):
    """A whole raw result (tensors, a None Jacobian, the trace) saved and
    loaded in its structure; the aliases hold the resume fields."""
    raw = lt.solve(lt.least_squares_problem(_f, torch.zeros(2, dtype=F64),
                                            materialize_jacobian=False),
                   lt.LevenbergMarquardt(lt.LSMR()), options=lt.Options(store_trace=True))
    raw = dict(raw, nested=[raw["ssr"], (raw["iterations"],)])
    path = str(tmp_path / "raw.npz")
    checkpoint.save_pytree(path, raw)
    back = checkpoint.load_pytree(path, raw)
    assert sorted(back) == sorted(raw) and back["jacobian"] is None
    for k, v in raw.items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(back[k], v.numpy())
    assert isinstance(back["nested"], list) and isinstance(back["nested"][1], tuple)
    data = np.load(path)
    np.testing.assert_array_equal(data["key_minimizer"], raw["minimizer"].numpy())
    assert int(data["key_iterations"]) == int(raw["iterations"])
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load_pytree(path, dict(raw, nested=[raw["ssr"], raw["iterations"]]))


def test_distributed_checkpoint_round_trip(tmp_path):
    """torch.distributed.checkpoint in one process: the tree comes back in
    its structure, dtypes and values; another structure is a ValueError."""
    tree = {"minimizer": torch.arange(4.0, dtype=F64), "ssr": torch.tensor(1.5),
            "rows": [torch.ones(2, 3), (torch.tensor([7], dtype=torch.int32),)]}
    p = str(tmp_path / "dcp")
    checkpoint.save_pytree_distributed(p, tree)
    like = {"minimizer": torch.zeros(4, dtype=F64), "ssr": torch.tensor(0.0),
            "rows": [torch.zeros(2, 3), (torch.zeros(1, dtype=torch.int32),)]}
    back = checkpoint.load_pytree_distributed(p, like)
    torch.testing.assert_close(back["minimizer"], tree["minimizer"])
    assert float(back["ssr"]) == 1.5 and int(back["rows"][1][0]) == 7
    assert isinstance(back["rows"][1], tuple)
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load_pytree_distributed(p, {"minimizer": torch.zeros(4, dtype=F64)})


def test_resume_x0_reads_both_packages(tmp_path):
    """A file written by the JAX package's save_pytree resumes a port solve,
    and the reverse: both write the ``key_minimizer`` alias."""
    x = np.array([0.25, -0.5])
    jax_path = str(tmp_path / "from_jax")
    jax_checkpoint.save_pytree(jax_path, {"minimizer": jnp.asarray(x), "ssr": jnp.asarray(2.0)})
    np.testing.assert_array_equal(checkpoint.resume_x0(jax_path), x)
    r = lt.optimize(_f, torch.tensor(checkpoint.resume_x0(jax_path)))
    assert r.converged
    port_path = str(tmp_path / "from_port")
    checkpoint.save_pytree(port_path, {"minimizer": torch.tensor(x), "ssr": torch.tensor(2.0)})
    np.testing.assert_array_equal(jax_checkpoint.resume_x0(port_path), x)
    np.testing.assert_array_equal(checkpoint.resume_x0(port_path + ".npz"), x)


def test_load_pytree_refuses_a_jax_written_file(tmp_path):
    path = str(tmp_path / "from_jax")
    jax_checkpoint.save_pytree(path, {"minimizer": jnp.zeros(2)})
    with pytest.raises(ValueError, match="written by the JAX package"):
        checkpoint.load_pytree(path, {"minimizer": np.zeros(2)})


def test_resume_x0_without_a_minimizer_says_so(tmp_path):
    path = str(tmp_path / "bare")
    checkpoint.save_pytree(path, [torch.zeros(2)])
    with pytest.raises(KeyError, match="minimizer"):
        checkpoint.resume_x0(path)
