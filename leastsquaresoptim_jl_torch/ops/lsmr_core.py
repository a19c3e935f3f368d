"""LSMR core: Golub-Kahan bidiagonalization for min ||Ax - b||^2 + lam^2||x||^2.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/lsmr_core.py``
(reference: src/utils/lsmr.jl:53-238, itself a port of the Stanford SOL
MATLAB code, Fong & Saunders 2011): the same recurrences and the same seven
stopping rules in the same priority. Per iteration there are exactly two
operator applications (matvec / rmatvec) and two norms.

The JAX package runs the iteration as one ``lax.while_loop``; here it is a
Python loop whose scalars are tensors on the data's device, in the data's
dtype. One fit (x0 of shape (n,)) carries 0-d scalars: the stop test reads
the six rule flags back to the host once per iteration (one device-to-host
read), plus one read of ``||A'b||`` before the loop.

A batch of fits (x0 of shape (B, n), every u-space leaf (B, m)) is what
the JAX package runs under ``jax.vmap``: every recurrence scalar is a (B,)
tensor, each fit takes the strongest of the seven rules on its own, and a
fit freezes at its own ``istop`` while the others go on (``torch.where``
over the carry). Each iteration reads one flag back to the host: whether
any fit still runs. ``iterations``, ``istop`` and the norm estimates are
(B,) tensors. ``live`` (B,) marks the fits to solve: the rest start
frozen at x0 with ``istop`` 0, which changes no live fit's result (the
JAX package runs them too and its caller discards them).

The operator's *range* space ("u-space") may be a tensor or a tuple of
tensors. The damped LM system [J; diag(d)] x = [y; 0] is then an operator
returning a ``(residual_part, damp_part)`` tuple, never a materialized
stack (reference: the DampenedMatrix / DampenedVector wrappers,
src/solver/iterative_lsmr.jl:61-109). The squared norm of a u-space vector
goes through the ``normsq`` hook, so that a row-sharded operator can
complete it across processes (parallel/sharded.py).

"converged" means istop not in {3, 6, 7} (reference: lsmr.jl:234).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import config


def _leaves(x):
    return x if isinstance(x, tuple) else (x,)


def _t_map(fn, *xs):
    """``fn`` leafwise over tensors or equal-length tuples of tensors."""
    if isinstance(xs[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*xs))
    return fn(*xs)


def _t_normsq(x):
    """Squared 2-norm of a u-space vector per fit (local sum over the last
    axis of every leaf)."""
    total = None
    for leaf in _leaves(x):
        s = torch.sum(leaf * leaf, dim=-1)
        total = s if total is None else total + s
    return total


def _col(s):
    """A per-fit scalar ((), or (B,)) against a per-fit vector."""
    return s.unsqueeze(-1)


class LSMRStats(NamedTuple):
    """Counterpart of the reference ConvergenceHistory (lsmr.jl:9-14). For
    one fit the loop runs on the host, so the counters are Python values;
    for a batch they are (B,) tensors. The two norm estimates are tensors
    on the data's device."""

    converged: Any         # istop not in (3, 6, 7)
    istop: Any             # stopping rule index (0 = never entered loop)
    iterations: Any
    mvps: Any              # = 2 * iterations (lsmr.jl:236)
    normr: torch.Tensor    # final ||r|| estimate
    normar: torch.Tensor   # final ||A'r|| estimate


def lsmr(
    matvec: Callable[[torch.Tensor], Any],
    rmatvec: Callable[[Any], torch.Tensor],
    b: Any,
    x0: torch.Tensor,
    *,
    maxiter: int,
    atol: float = 1e-6,
    btol: float = 1e-6,
    conlim: float = 1e8,
    lam: float = 0.0,
    normsq: Optional[Callable[[Any], torch.Tensor]] = None,
    live: Optional[torch.Tensor] = None,
):
    """Solve min ||A x - b||^2 + lam^2 ||x||^2 iteratively.

    ``matvec(v)`` maps a flat (n,) vector into u-space (a tensor or a tuple
    of tensors); ``rmatvec(u)`` maps u-space back to a flat (n,) vector.
    ``normsq(u)`` is the squared norm of a u-space vector (default: the
    local sum of squares over every leaf). With x0 of shape (B, n) every
    vector carries the batch axis in front and the fits stop on their own
    (see the module); ``live`` applies to a batch only.

    Returns ``(x, LSMRStats)``.
    """
    dt, dev = x0.dtype, x0.device
    if normsq is None:
        normsq = _t_normsq

    def scalar(v):
        # Rounded as JAX rounds it: conlim = 1e8 is inf in float16.
        return torch.full((), config.in_dtype(v, dt), dtype=dt, device=dev)

    lam, atol, btol = scalar(lam), scalar(atol), scalar(btol)
    one, zero = scalar(1.0), scalar(0.0)
    ctol = 1.0 / scalar(conlim) if conlim > 0 else zero

    def inverse_or_zero(s):
        return torch.where(s > 0, 1.0 / s, zero)

    # First bidiagonalization vectors: beta*u = b - A x0, alpha*v = A'u
    # (reference: lsmr.jl:73-78).
    u = _t_map(lambda ax, bi: bi - ax, matvec(x0), b)
    beta = torch.sqrt(normsq(u))
    scale = _col(inverse_or_zero(beta))
    u = _t_map(lambda ui: scale * ui, u)
    v = rmatvec(u)
    alpha = torch.sqrt(torch.sum(v * v, dim=-1))
    v = v * _col(inverse_or_zero(alpha))

    zetabar = alpha * beta
    normb = beta
    normar0 = zetabar

    c = dict(
        x=x0, u=u, v=v, h=v, hbar=torch.zeros_like(x0),
        alpha=alpha, alphabar=alpha, beta=beta, rho=one, rhobar=one,
        cbar=one, sbar=zero, zeta=zero, zetabar=zetabar,
        # ||r|| estimation cascade (lsmr.jl:92-99)
        betadd=beta, betad=zero, rhodold=one, tautildeold=zero,
        thetatilde=zero, dd=zero,
        # ||A||, cond(A) estimation (lsmr.jl:101-105). The reference starts
        # minrbar at 1e100; clamped to the dtype so float32 does not
        # overflow to inf.
        norma2=alpha * alpha, maxrbar=zero,
        minrbar=scalar(min(1e100, torch.finfo(dt).max / 16)),
        normr=beta, normar=zetabar,
    )

    def body(c, it):
        # --- bidiagonalization step (lsmr.jl:118-125) ---
        alpha_old = _col(c["alpha"])
        u_new = _t_map(lambda av, ui: av - alpha_old * ui, matvec(c["v"]), c["u"])
        beta = torch.sqrt(normsq(u_new))
        has_beta = beta > 0
        scale = _col(inverse_or_zero(beta))
        u = _t_map(lambda ui: scale * ui, u_new)
        v_new = rmatvec(u) - _col(beta) * c["v"]
        alpha_new = torch.linalg.vector_norm(v_new, dim=-1)
        v_cand = v_new * _col(inverse_or_zero(alpha_new))
        v = torch.where(_col(has_beta), v_cand, c["v"])
        alpha = torch.where(has_beta, alpha_new, c["alpha"])

        # --- rotation Qhat (regularization lam) (lsmr.jl:127-130) ---
        alphahat = torch.sqrt(c["alphabar"] * c["alphabar"] + lam * lam)
        chat = c["alphabar"] / alphahat
        shat = lam / alphahat

        # --- rotation Q_i: B_i -> R_i (lsmr.jl:132-138) ---
        rhoold = c["rho"]
        rho = torch.sqrt(alphahat * alphahat + beta * beta)
        cr = alphahat / rho
        sr = beta / rho
        thetanew = sr * alpha
        alphabar = cr * alpha

        # --- rotation Qbar_i: R_i -> Rbar_i (lsmr.jl:140-149) ---
        rhobarold = c["rhobar"]
        zetaold = c["zeta"]
        thetabar = c["sbar"] * rho
        rhotemp = c["cbar"] * rho
        rhobar = torch.sqrt(rhotemp * rhotemp + thetanew * thetanew)
        cbar = c["cbar"] * rho / rhobar
        sbar = thetanew / rhobar
        zeta = cbar * c["zetabar"]
        zetabar = -sbar * c["zetabar"]

        # --- update h, hbar, x (lsmr.jl:151-156) ---
        hbar = c["h"] + _col(-thetabar * rho / (rhoold * rhobarold)) * c["hbar"]
        x = c["x"] + _col(zeta / (rho * rhobar)) * hbar
        h = v + _col(-thetanew / rho) * c["h"]

        # --- ||r|| estimate (lsmr.jl:158-184) ---
        betaacute = chat * c["betadd"]
        betacheck = -shat * c["betadd"]
        betahat = cr * betaacute
        betadd = -sr * betaacute
        thetatildeold = c["thetatilde"]
        rhotildeold = torch.sqrt(c["rhodold"] * c["rhodold"] + thetabar * thetabar)
        ctildeold = c["rhodold"] / rhotildeold
        stildeold = thetabar / rhotildeold
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * c["betad"] + ctildeold * betahat
        tautildeold = (zetaold - thetatildeold * c["tautildeold"]) / rhotildeold
        taud = (zeta - thetatilde * tautildeold) / rhodold
        dd = c["dd"] + betacheck * betacheck
        resid = betad - taud
        normr = torch.sqrt(dd + resid * resid + betadd * betadd)

        # --- ||A|| and cond(A) estimates (lsmr.jl:186-196) ---
        norma2 = c["norma2"] + beta * beta
        norma = torch.sqrt(norma2)
        norma2 = norma2 + alpha * alpha
        maxrbar = torch.maximum(c["maxrbar"], rhobarold)
        minrbar = torch.minimum(c["minrbar"], rhobarold) if it > 1 else c["minrbar"]
        conda = torch.maximum(maxrbar, rhotemp) / torch.minimum(minrbar, rhotemp)

        # --- stopping rules (lsmr.jl:204-231) ---
        normar = torch.abs(zetabar)
        normx = torch.linalg.vector_norm(x, dim=-1)
        test1 = normr / normb
        test2 = normar / (norma * normr)
        test3 = 1.0 / conda
        t1 = test1 / (1.0 + norma * normx / normb)
        rtol = btol + atol * norma * normx / normb
        # Rules 1..6 in the reference's break order; the host takes the
        # strongest one that fired (rule 7, the iteration cap, is the
        # host's own count).
        rules = torch.stack([
            test1 <= rtol, test2 <= atol, test3 <= ctol,
            1.0 + t1 <= 1.0, 1.0 + test2 <= 1.0, 1.0 + test3 <= 1.0,
        ])
        new = dict(
            x=x, u=u, v=v, h=h, hbar=hbar,
            alpha=alpha, alphabar=alphabar, beta=beta, rho=rho, rhobar=rhobar,
            cbar=cbar, sbar=sbar, zeta=zeta, zetabar=zetabar,
            betadd=betadd, betad=betad, rhodold=rhodold,
            tautildeold=tautildeold, thetatilde=thetatilde, dd=dd,
            norma2=norma2, maxrbar=maxrbar, minrbar=minrbar,
            normr=normr, normar=normar,
        )
        return new, rules

    if x0.ndim > 1:
        return _batched_loop(c, body, normar0, maxiter, live)
    it, istop = 0, 0
    # normar0 == 0 (b = 0 or A'b = 0): x0 is the answer, zero iterations
    # (reference: lsmr.jl:115).
    if maxiter > 0 and float(normar0) != 0.0:
        while istop == 0:
            it += 1
            c, rules = body(c, it)
            fired = rules.tolist()  # the iteration's device-to-host read
            for rule in range(6):
                if fired[rule]:
                    istop = rule + 1
            if it >= maxiter:
                istop = 7
    stats = LSMRStats(
        converged=istop not in (3, 6, 7),
        istop=istop,
        iterations=it,
        mvps=2 * it,
        normr=c["normr"],
        normar=c["normar"],
    )
    return c["x"], stats


def _batched_loop(c, body, normar0, maxiter, live):
    """The iteration of a batch of fits (see the module): each fit takes
    the strongest rule that fired, in the reference's priority, and
    freezes from then on. Live fits all start at the first iteration, so
    the host's count is every running fit's own."""
    running = normar0 != 0
    if live is not None:
        running = running & live
    istop = torch.zeros(running.shape, dtype=torch.int32, device=running.device)
    its = torch.zeros_like(istop)

    def freeze(old, new, run):
        if isinstance(old, tuple):
            return tuple(freeze(o, n_, run) for o, n_ in zip(old, new))
        mask = run.reshape(run.shape + (1,) * (new.ndim - run.ndim))
        return torch.where(mask, new, old)

    it = 0
    # One device-to-host read per iteration: does any fit still run?
    while maxiter > 0 and bool(running.any()):
        it += 1
        new, rules = body(c, it)
        code = torch.zeros_like(istop)
        for rule in range(6):
            code = torch.where(rules[rule], rule + 1, code)
        if it >= maxiter:
            code = torch.full_like(code, 7)
        c = {k: freeze(v, new[k], running) for k, v in c.items()}
        istop = torch.where(running, code, istop)
        its = its + running.to(torch.int32)
        running = running & (code == 0)
    stats = LSMRStats(
        converged=(istop != 3) & (istop != 6) & (istop != 7),
        istop=istop,
        iterations=its,
        mvps=2 * its,
        normr=c["normr"],
        normar=c["normar"],
    )
    return c["x"], stats
