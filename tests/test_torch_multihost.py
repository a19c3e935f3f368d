"""Four processes and a sharded checkpoint mid-solve (the counterpart of
tests/test_multihost.py::test_four_process_checkpoint_resume).

Four gloo processes each hold a row block of the same exp_saturation
problem (m = 64), run four iterations of LM(LSMR()) through
``parallel.solve_sharded``, and save the iterate beside the residual at it
with ``utils.checkpoint.save_pytree_distributed``. The residual is a
genuinely row-sharded leaf: a ``DTensor`` sharded over the rows, each
process writing its own block. ``load_pytree_distributed`` restores both,
and the solve resumes from the restored iterate.

The asserts are the JAX test's: a world size of 4, converged, the resume
from the restored iterate equal bit for bit to the resume from the
in-memory one, each process's shard round-tripped exactly, one identical
result on all ranks, and b0 within 10% of 200. The JAX test's processes
run without x64, so its data and start are float32; so are the port's
here (in float64 the solve walks the flat valley to the truth, b0 = 240).
The workers also print the iterate after the first four iterations. The
parent runs the same float32 problem through the JAX package's
``solve_sharded`` on a 4-device CPU mesh and holds both stages of the port
against it: the minimizer to 1e-5 relative, the iteration count and the
converged flag exactly.
Each process gets 120 s; the whole test takes about 11 s on 8 cores, the
JAX reference about 3 s of it.
The workers import no JAX.
"""

import pytest

torch = pytest.importorskip("torch")

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np

WORLD = 4
TIMEOUT_S = 120
# float32 agreement with the JAX package, relative, on each coordinate
RTOL = 1e-5

_WORKER = textwrap.dedent(
    """
    import sys
    proc, nproc, port, ckdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    sys.path.insert(0, "__REPO__")
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    import leastsquaresoptim_jl_torch as lt
    from leastsquaresoptim_jl_torch.parallel import (
        initialize_multihost, shard_rows, solve_sharded,
    )
    from leastsquaresoptim_jl_torch.utils.checkpoint import (
        load_pytree_distributed, save_pytree_distributed,
    )

    torch.set_num_threads(1)
    initialize_multihost(f"tcp://127.0.0.1:{port}", nproc, proc)
    m = 64
    xh = torch.linspace(1.0, 80.0, m, dtype=torch.float64).float()
    yh = (240.0 * (1 - torch.exp(-5e-4 * xh.double()))).float()
    data = shard_rows((xh, yh))
    resid = lambda b, row: row[1] - b[0] * (1 - torch.exp(-b[1] * row[0]))
    x0 = torch.tensor([200.0, 1e-3])
    opt = lt.LevenbergMarquardt(lt.LSMR())

    # Stage 1: a partial solve gives a genuine mid-solve state.
    raw1 = solve_sharded(resid, data, x0, opt, options=lt.Options(iterations=4))
    x_mid = raw1["minimizer"]
    xm = np.asarray(x_mid)
    print(
        f"MID {proc} {xm[0]:.10e} {xm[1]:.10e} "
        f"{int(raw1['iterations'])} {int(raw1['converged'])}"
    )
    # A genuinely row-sharded checkpoint leaf: the residual at the iterate,
    # this process's rows as its block of one DTensor.
    r_local = torch.func.vmap(lambda row: resid(x_mid, row))(data)
    mesh = init_device_mesh("cpu", (dist.get_world_size(),))
    r_sharded = DTensor.from_local(r_local, mesh, [Shard(0)])
    state = {"x": x_mid, "r": r_sharded}
    save_pytree_distributed(ckdir, state)
    restored = load_pytree_distributed(ckdir, state)

    # Per-process shard fidelity: this process's block round-trips.
    ok_shard = int(isinstance(restored["r"], DTensor)
                   and tuple(restored["r"].shape) == (m,)
                   and torch.equal(restored["r"].to_local(), r_local))

    # Stage 2: the resume from the restored iterate equals the resume from
    # the in-memory iterate bit for bit (the same trajectory).
    raw_resume = solve_sharded(resid, data, restored["x"], opt)
    raw_direct = solve_sharded(resid, data, x_mid, opt)
    mr = np.asarray(raw_resume["minimizer"])
    md = np.asarray(raw_direct["minimizer"])
    same = int(np.array_equal(mr, md) and mr.dtype == np.float32)
    print(
        f"RESULT {proc} {dist.get_world_size()} "
        f"{mr[0]:.10e} {mr[1]:.10e} "
        f"{int(raw_resume['converged'])} {same} {ok_shard} "
        f"{int(raw_resume['iterations'])}"
    )
    dist.destroy_process_group()
    """
)


def _jax_reference():
    """(x_mid, iterations, converged) after four iterations and after the
    resume, from the JAX package's solve_sharded on 4 CPU devices."""
    import jax
    import jax.numpy as jnp

    import leastsquaresoptim_jl_tpu as lso
    from leastsquaresoptim_jl_tpu.parallel import (
        make_mesh, shard_rows, solve_sharded,
    )

    mesh = make_mesh((WORLD,), ("rows",), devices=jax.devices()[:WORLD])
    m = 64
    xh = np.linspace(1.0, 80.0, m).astype(np.float32)
    yh = (240.0 * (1 - np.exp(-5e-4 * xh.astype(np.float64)))).astype(
        np.float32
    )
    data = shard_rows((jnp.asarray(xh), jnp.asarray(yh)), mesh)
    resid = lambda b, row: row[1] - b[0] * (1 - jnp.exp(-b[1] * row[0]))
    x0 = jnp.array([200.0, 1e-3], dtype=jnp.float32)
    opt = lso.LevenbergMarquardt(lso.LSMR())

    def summary(raw):
        x = np.asarray(raw["minimizer"])
        assert x.dtype == np.float32
        return x, int(raw["iterations"]), int(raw["converged"])

    raw1 = solve_sharded(
        resid, data, x0, mesh, opt, options=lso.Options(iterations=4)
    )
    raw2 = solve_sharded(resid, data, raw1["minimizer"], mesh, opt)
    return summary(raw1), summary(raw2)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_four_process_checkpoint_resume(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker4.py"
    script.write_text(_WORKER.replace("__REPO__", repo))
    port = _free_port()
    ckdir = str(tmp_path / "ckpt")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(WORLD), str(port), ckdir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(WORLD)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    rows, mids = {}, {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("MID"):
                _, pid, b0, b1, iters, conv = line.split()
                mids[int(pid)] = (float(b0), float(b1), int(iters), int(conv))
            if line.startswith("RESULT"):
                _, pid, ndev, b0, b1, conv, same, ok_shard, iters = line.split()
                rows[int(pid)] = (
                    int(ndev), float(b0), float(b1), int(conv),
                    int(same), int(ok_shard), int(iters),
                )
    assert set(rows) == set(range(WORLD)), rows
    assert set(mids) == set(range(WORLD)), mids
    for pid, (ndev, b0, b1, conv, same, ok_shard, _) in rows.items():
        assert ndev == WORLD  # a genuinely global 4-process group
        assert conv == 1
        assert same == 1  # restored-iterate resume == in-memory resume
        assert ok_shard == 1  # local shards round-tripped exactly
    # all processes report the identical replicated result
    assert len({r[1:3] for r in rows.values()}) == 1
    assert len(set(mids.values())) == 1
    assert np.isclose(rows[0][1], 200.0, rtol=0.1)

    # The port against the JAX package: the same float32 problem through
    # the JAX solve_sharded on a 4-device CPU mesh, four iterations, then
    # the resume. Both stages must agree to float32 accuracy, with the same
    # iteration counts and converged flags.
    ref_mid, ref_final = _jax_reference()
    b0, b1, iters, conv = mids[0]
    np.testing.assert_allclose([b0, b1], ref_mid[0], rtol=RTOL)
    assert (iters, conv) == ref_mid[1:]
    _, b0, b1, conv, _, _, iters = rows[0]
    np.testing.assert_allclose([b0, b1], ref_final[0], rtol=RTOL)
    assert (iters, conv) == ref_final[1:]
