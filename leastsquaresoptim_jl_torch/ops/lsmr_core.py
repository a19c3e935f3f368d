"""LSMR core: Golub-Kahan bidiagonalization for min ||Ax - b||^2 + lam^2||x||^2.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/lsmr_core.py``
(reference: src/utils/lsmr.jl:53-238, itself a port of the Stanford SOL
MATLAB code, Fong & Saunders 2011): the same recurrences and the same seven
stopping rules in the same priority. Per iteration there are exactly two
operator applications (matvec / rmatvec) and two norms.

The JAX package runs the iteration as one ``lax.while_loop``; here it is a
Python loop whose scalars are 0-d tensors on the data's device, in the
data's dtype. The stop test reads the six rule flags back to the host once
per iteration (one device-to-host read), plus one read of ``||A'b||``
before the loop.

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


def _leaves(x):
    return x if isinstance(x, tuple) else (x,)


def _t_map(fn, *xs):
    """``fn`` leafwise over tensors or equal-length tuples of tensors."""
    if isinstance(xs[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*xs))
    return fn(*xs)


def _t_normsq(x):
    """Squared 2-norm of a u-space vector (local sum over every leaf)."""
    total = None
    for leaf in _leaves(x):
        s = torch.sum(leaf * leaf)
        total = s if total is None else total + s
    return total


class LSMRStats(NamedTuple):
    """Counterpart of the reference ConvergenceHistory (lsmr.jl:9-14). The
    loop runs on the host, so the counters are Python values; the two norm
    estimates stay 0-d tensors on the data's device."""

    converged: bool        # istop not in (3, 6, 7)
    istop: int             # stopping rule index (0 = never entered loop)
    iterations: int
    mvps: int              # = 2 * iterations (lsmr.jl:236)
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
):
    """Solve min ||A x - b||^2 + lam^2 ||x||^2 iteratively.

    ``matvec(v)`` maps a flat (n,) vector into u-space (a tensor or a tuple
    of tensors); ``rmatvec(u)`` maps u-space back to a flat (n,) vector.
    ``normsq(u)`` is the squared norm of a u-space vector (default: the
    local sum of squares over every leaf).

    Returns ``(x, LSMRStats)``.
    """
    dt, dev = x0.dtype, x0.device
    if normsq is None:
        normsq = _t_normsq

    def scalar(v):
        return torch.full((), v, dtype=dt, device=dev)

    lam, atol, btol = scalar(lam), scalar(atol), scalar(btol)
    one, zero = scalar(1.0), scalar(0.0)
    ctol = 1.0 / scalar(conlim) if conlim > 0 else zero

    def inverse_or_zero(s):
        return torch.where(s > 0, 1.0 / s, zero)

    # First bidiagonalization vectors: beta*u = b - A x0, alpha*v = A'u
    # (reference: lsmr.jl:73-78).
    u = _t_map(lambda ax, bi: bi - ax, matvec(x0), b)
    beta = torch.sqrt(normsq(u))
    scale = inverse_or_zero(beta)
    u = _t_map(lambda ui: scale * ui, u)
    v = rmatvec(u)
    alpha = torch.sqrt(torch.sum(v * v))
    v = v * inverse_or_zero(alpha)

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
        alpha_old = c["alpha"]
        u_new = _t_map(lambda av, ui: av - alpha_old * ui, matvec(c["v"]), c["u"])
        beta = torch.sqrt(normsq(u_new))
        has_beta = beta > 0
        scale = inverse_or_zero(beta)
        u = _t_map(lambda ui: scale * ui, u_new)
        v_new = rmatvec(u) - beta * c["v"]
        alpha_new = torch.linalg.vector_norm(v_new)
        v_cand = v_new * inverse_or_zero(alpha_new)
        v = torch.where(has_beta, v_cand, c["v"])
        alpha = torch.where(has_beta, alpha_new, alpha_old)

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
        hbar = c["h"] + (-thetabar * rho / (rhoold * rhobarold)) * c["hbar"]
        x = c["x"] + (zeta / (rho * rhobar)) * hbar
        h = v + (-thetanew / rho) * c["h"]

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
        normx = torch.linalg.vector_norm(x)
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
