"""Block-tridiagonal SPD solves for banded normal systems.

PyTorch counterpart of ``leastsquaresoptim_jl_tpu/ops/block_tridiag.py``:
the direct route for Jacobians whose Gram ``A = J'J`` is block-tridiagonal
with square (s, s) blocks (1-D chain and boundary-value models: MINPACK's
broyden_tridiagonal and discrete_boundary_value, BASELINE.json configs #4
and #5). The reference reaches such problems through Julia's sparse-CSC
factorizations (reference: test/nonlinearsolvers.jl:539-570).

Gram recovery: columns whose block indices differ by 3 or more never share
a row of A, so 3s structured probes ``A P_k`` recover every block exactly,
one matvec and one rmatvec each. Three solves of the recovered system:

  * ``block_tridiag_cholesky`` / ``block_tridiag_solve``: the blocked
    Cholesky (banded ``pbtrf``), a Python loop of nb dense (s, s) steps;
  * ``block_cyclic_reduction_solve``: block cyclic reduction, about
    log2(nb) levels of batched (s, s) algebra;
  * at s <= 2, ``_bcr_soa``: the same reduction with every block held as
    s*s separate component vectors (elementwise work only, closed-form
    inverses), the last <= ``_CR_DENSE_TAIL_NB`` blocks solved as one
    dense Cholesky.

``solve_block_tridiag_spd`` picks the route ("auto": cyclic reduction above
``_CYCLIC_REDUCTION_MIN_NB`` blocks) and retries a non-finite solve once
with the scale-invariant jitter of the dense route. The thresholds, the
route rule and the arithmetic are the JAX package's, so that both packages
compute the same thing.

Every function takes leading batch axes (independent fits): blocks are
(..., nb, s, s), vectors (..., n), probe responses (..., 3s, n). A failed
(s, s) Cholesky gives NaN (``cholesky_ex``), as XLA's does, which the
jittered retry catches. The retry reads one flag back to the host per
solve: the JAX package's ``lax.cond`` computes the retry only when it is
needed, and so does this.

Contract: the Gram must be block-tridiagonal at the declared block size; a
wider coupling aliases into the recovered blocks without any error.
"""

from __future__ import annotations

import numpy as np
import torch

# Above this block count cyclic reduction's batched levels replace the
# blocked Cholesky's nb sequential steps (the JAX package's threshold).
_CYCLIC_REDUCTION_MIN_NB = 64

# Stop the SoA cyclic reduction at this many block rows and solve the rest
# as one dense Cholesky (the JAX package's threshold).
_CR_DENSE_TAIL_NB = 64


def block_probe_matrix(n: int, s: int, dtype, device=None) -> torch.Tensor:
    """(3s, n) probe matrix for exact block-tridiagonal column recovery.

    Probe (c, o) (row c*s + o) is the indicator of the columns
    ``{b*s + o : b % 3 == c}``: within one probe the contributing columns
    sit >= 3 blocks apart, so their responses occupy disjoint rows. Built
    in float64 with numpy and cast."""
    if n % s != 0:
        raise ValueError(
            f"block size {s} must divide n={n} (pad the parameter vector "
            "or choose a divisor block size)"
        )
    j = np.arange(n)
    b, o = j // s, j % s
    P = np.zeros((3, s, n), dtype=np.float64)
    P[b % 3, o, j] = 1.0
    return torch.as_tensor(P.reshape(3 * s, n), dtype=dtype, device=device)


def extract_blocks(AV: torch.Tensor, n: int, s: int):
    """Recover (D, L) from the probe responses.

    ``AV`` is (..., 3s, n) with row c*s+o = A @ probe(c, o). Returns the
    diagonal blocks ``D`` (..., nb, s, s) and the lower off-diagonal blocks
    ``L`` (..., nb-1, s, s) with ``L[b] = A[(b+1)s:(b+2)s, bs:(b+1)s]``."""
    nb = n // s
    batch = AV.shape[:-2]
    # [batch, class c, column offset o, row block b, row r] -> [batch, b, c, r, o]
    A5 = AV.reshape((-1, 3, s, nb, s)).permute(0, 3, 1, 4, 2)
    bidx = torch.arange(nb, device=AV.device)
    cls = bidx % 3
    # D_b[r, o] = A[b*s + r, b*s + o]: block b's own class.
    D = A5[:, bidx, cls].reshape(batch + (nb, s, s))
    # L_b[r, o] = A[(b+1)*s + r, b*s + o]: row block b+1 of class cls[b].
    L = A5[:, bidx[1:], cls[:-1]].reshape(batch + (nb - 1, s, s))
    return D, L


def probe_responses(matvec, rmatvec, P, batch_shape=()):
    """``rmatvec(matvec(p))`` for every probe row p of ``P`` (3s, n), in
    one vmapped evaluation; (..., 3s, n) with the batch axes in front.
    With a batch the probe is the same for every fit."""
    k, n = P.shape
    V = P.reshape((k,) + (1,) * len(batch_shape) + (n,)).expand(
        (k,) + tuple(batch_shape) + (n,))
    AV = torch.func.vmap(lambda v: rmatvec(matvec(v)))(V)
    return AV.movedim(0, -2)


def probe_gram_blocks(matvec, rmatvec, n: int, s: int, dtype, damp=None,
                      device=None, batch_shape=()):
    """(D, L) blocks of ``A = J'J [+ diag(damp)]`` from 3s probe
    matvec-pairs."""
    P = block_probe_matrix(n, s, dtype, device)
    AV = probe_responses(matvec, rmatvec, P, batch_shape)
    if damp is not None:
        AV = AV + damp.unsqueeze(-2) * P
    return extract_blocks(AV, n, s)


def _chol_nan(A):
    """Lower Cholesky factor; NaN where the factorization fails (XLA's
    semantics, which the jittered retry relies on)."""
    G, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], G, torch.nan)


def block_tridiag_cholesky(D: torch.Tensor, L: torch.Tensor):
    """Blocked Cholesky of the SPD block-tridiagonal ``(D, L)``: one dense
    (s, s) step per block row (Cholesky, triangular solve, one product).
    Returns the diagonal factors ``G`` (..., nb, s, s) and the factor's
    off-diagonal blocks ``C`` (..., nb-1, s, s)."""
    nb = D.shape[-3]
    prev = torch.zeros_like(D[..., 0, :, :])
    Gs, Cs = [], []
    for b in range(nb):
        G = _chol_nan(D[..., b, :, :] - prev)
        Gs.append(G)
        if b + 1 < nb:
            # C_b = L_b G_b^{-T}  <=>  C_b' = G_b^{-1} L_b'
            Ct = torch.linalg.solve_triangular(G, L[..., b, :, :].mT, upper=False)
            prev = Ct.mT @ Ct
            Cs.append(Ct.mT)
    G = torch.stack(Gs, dim=-3)
    C = torch.stack(Cs, dim=-3) if Cs else D.new_zeros(D.shape[:-3] + (0,) + D.shape[-2:])
    return G, C


def block_tridiag_solve(G: torch.Tensor, C: torch.Tensor, b: torch.Tensor):
    """Solve ``A x = b`` from the blocked factor ``(G, C)``; ``b`` is
    (..., n). Forward substitution down the block rows, back substitution
    up."""
    nb, s = G.shape[-3], G.shape[-1]
    bb = b.reshape(b.shape[:-1] + (nb, s, 1))
    y = []
    for k in range(nb):
        r = bb[..., k, :, :]
        if k > 0:
            r = r - C[..., k - 1, :, :] @ y[-1]
        y.append(torch.linalg.solve_triangular(G[..., k, :, :], r, upper=False))
    x = [None] * nb
    for k in reversed(range(nb)):
        r = y[k]
        if k + 1 < nb:
            r = r - C[..., k, :, :].mT @ x[k + 1]
        x[k] = torch.linalg.solve_triangular(G[..., k, :, :].mT, r, upper=True)
    return torch.cat(x, dim=-2).reshape(b.shape)


def _binv(D):
    """Batched (k, s, s) inverse: closed form at s <= 2, LU beyond
    (``inv_ex``: a singular block gives non-finite entries, as XLA's
    inverse does, and no error check reads the card back)."""
    s = D.shape[-1]
    if s == 1:
        return 1.0 / D
    if s == 2:
        a, b = D[..., 0, 0], D[..., 0, 1]
        c, d = D[..., 1, 0], D[..., 1, 1]
        det = a * d - b * c
        adj = torch.stack(
            [torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2
        )
        return adj / det[..., None, None]
    return torch.linalg.inv_ex(D)[0]


def _shift_down(a, count, axis):
    """[0, a[0], ..., a[count-2]] along ``axis``: left-neighbor alignment."""
    z = torch.zeros_like(a.narrow(axis, 0, 1))
    return torch.cat([z, a.narrow(axis, 0, count - 1)], dim=axis)


def _pad_to(a, count, axis):
    """``a`` padded with trailing zeros to length ``count`` along ``axis``."""
    k = a.shape[axis]
    if k == count:
        return a
    shape = list(a.shape)
    shape[axis] = count - k
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _interleave(even, odd, axis):
    """Rows even[0], odd[0], even[1], ... along ``axis`` (the JAX package's
    ``.at[0::2].set(even).at[1::2].set(odd)``), built functionally."""
    ke, ko = even.shape[axis], odd.shape[axis]
    both = torch.stack([even, _pad_to(odd, ke, axis)], dim=axis + 1 if axis >= 0 else axis)
    shape = list(even.shape)
    shape[axis] = 2 * ke
    return both.reshape(shape).narrow(axis, 0, ke + ko)


def _mv(M, v):
    """Batched (..., k, s, s) @ (..., k, s)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


# -- struct-of-arrays cyclic reduction (s <= 2) ------------------------------
#
# Layout: each (s, s) block is s*s separate (..., k) component tensors, a
# nested list ``M[i][j]``. All block algebra is then elementwise over k: no
# batched tiny-matrix products and no (k, 2, 2) tensors with both block
# dims minor. The JAX package chose it for the TPU's (8, 128) tiles; on the
# GPU each component op is one elementwise kernel over k.


def _soa_split(M):
    """(..., k, s, s) -> s x s nested list of (..., k) components."""
    s = M.shape[-1]
    return [[M[..., i, j] for j in range(s)] for i in range(s)]


def _soa_mm(A, B, s, neg=False):
    """Block matmul on component lists: C = (-)A @ B."""
    out = []
    for i in range(s):
        row = []
        for l in range(s):
            acc = A[i][0] * B[0][l]
            for j in range(1, s):
                acc = acc + A[i][j] * B[j][l]
            row.append(-acc if neg else acc)
        out.append(row)
    return out


def _soa_mv(A, x, s):
    """Block matvec on component lists: y = A @ x."""
    out = []
    for i in range(s):
        acc = A[i][0] * x[0]
        for j in range(1, s):
            acc = acc + A[i][j] * x[j]
        out.append(acc)
    return out


def _soa_sub(A, B, s):
    return [[A[i][j] - B[i][j] for j in range(s)] for i in range(s)]


def _soa_inv(A, s):
    """Closed-form component inverse (s <= 2)."""
    if s == 1:
        return [[1.0 / A[0][0]]]
    a, b, c, d = A[0][0], A[0][1], A[1][0], A[1][1]
    det = a * d - b * c
    return [[d / det, -b / det], [-c / det, a / det]]


def _soa_map(f, A, s):
    return [[f(A[i][j]) for j in range(s)] for i in range(s)]


def extract_blocks_soa(AV: torch.Tensor, n: int, s: int):
    """SoA counterpart of :func:`extract_blocks`: (Dv, Lv) nested lists of
    (..., nb) / (..., nb-1) components, read straight from the (..., 3s, n)
    probe responses (Lv is None at nb = 1)."""
    nb = n // s
    A3 = AV.reshape(AV.shape[:-2] + (3, s, n))
    cls = torch.arange(nb, device=AV.device) % 3

    def pick(vals, clsv):
        # vals (..., 3, k): the response of probe class cls[b] at each b.
        return torch.where(
            clsv == 0, vals[..., 0, :],
            torch.where(clsv == 1, vals[..., 1, :], vals[..., 2, :]),
        )

    D = [[None] * s for _ in range(s)]
    Lv = [[None] * s for _ in range(s)] if nb > 1 else None
    for i in range(s):
        for j in range(s):
            rows = A3[..., :, j, :]  # (..., 3, n): responses at column offset j
            D[i][j] = pick(rows[..., i::s], cls)
            if nb > 1:
                # L_b[i, j] = A[(b+1)s + i, bs + j], b = 0..nb-2
                Lv[i][j] = pick(rows[..., s + i::s], cls[:-1])
    return D, Lv


def probe_gram_soa(matvec, rmatvec, n: int, s: int, dtype, damp=None,
                   device=None, batch_shape=()):
    """SoA counterpart of :func:`probe_gram_blocks`: the same 3s probe
    matvec-pairs, components read without an (nb, s, s) intermediate."""
    P = block_probe_matrix(n, s, dtype, device)
    AV = probe_responses(matvec, rmatvec, P, batch_shape)
    if damp is not None:
        AV = AV + damp.unsqueeze(-2) * P
    return extract_blocks_soa(AV, n, s)


def _dense_tail_solve(Dv, B, r, k, s):
    """Assemble the reduced k-block system dense and solve it with one
    Cholesky (the JAX package's ``dense_tail_solve``). Uses B, the
    sub-diagonal couplings, only: the system is symmetric."""
    # Component (i, j) of the dense (k, k) slab: D[i][j] on the diagonal,
    # B[a][i][j] at (a, a-1) and B[a][j][i] (the transposed block) at (a-1, a).
    comp = [[torch.diag_embed(Dv[i][j])
             + torch.diag_embed(B[i][j][..., 1:], offset=-1)
             + torch.diag_embed(B[j][i][..., 1:], offset=1)
             for j in range(s)] for i in range(s)]
    A = torch.stack([torch.stack(row, -3) for row in comp], -4)  # (..., s, s, k, k)
    batch = A.shape[:-4]
    A = A.permute(tuple(range(len(batch))) + tuple(len(batch) + d for d in (2, 0, 3, 1)))
    A = A.reshape(batch + (k * s, k * s))
    rv = torch.stack(r, dim=-1).reshape(batch + (k * s, 1))
    Lc = _chol_nan(A)
    z = torch.linalg.solve_triangular(Lc, rv, upper=False)
    x = torch.linalg.solve_triangular(Lc.mT, z, upper=True)
    xs = x.reshape(batch + (k, s))
    return [xs[..., i] for i in range(s)]


def _bcr_soa(Dv, Lv, rhs, nb, s):
    """Struct-of-arrays block cyclic reduction for s <= 2: the algebra of
    :func:`block_cyclic_reduction_solve` on component lists, the last
    <= ``_CR_DENSE_TAIL_NB`` blocks solved as one dense Cholesky."""
    zero1 = lambda a: torch.cat([torch.zeros_like(a[..., :1]), a], dim=-1)  # noqa: E731
    # B[i] = A[i, i-1] (0 at i=0); C[i] = A[i, i+1] (0 at i=nb-1)
    if nb > 1:
        B = _soa_map(zero1, Lv, s)
        C = [[torch.cat([Lv[j][i], torch.zeros_like(Lv[j][i][..., :1])], dim=-1)
              for j in range(s)] for i in range(s)]
    else:
        z = torch.zeros_like(Dv[0][0])
        B = [[z for _ in range(s)] for _ in range(s)]
        C = [[z for _ in range(s)] for _ in range(s)]
    r = [rhs[..., i::s] for i in range(s)]

    even = lambda a: a[..., 0::2]  # noqa: E731
    odd = lambda a: a[..., 1::2]  # noqa: E731

    stack = []
    k = nb
    while k > _CR_DENSE_TAIL_NB:
        De, Do = _soa_map(even, Dv, s), _soa_map(odd, Dv, s)
        Be, Bo = _soa_map(even, B, s), _soa_map(odd, B, s)
        Ce, Co = _soa_map(even, C, s), _soa_map(odd, C, s)
        re, ro = [even(v) for v in r], [odd(v) for v in r]
        ke = De[0][0].shape[-1]
        Dinv_o = _soa_inv(Do, s)
        stack.append((Dinv_o, Bo, Co, ro, ke))
        sl = lambda a: _shift_down(a, ke, -1)  # noqa: E731
        pr = lambda a: _pad_to(a, ke, -1)  # noqa: E731
        DinvL, BoL, CoL = (_soa_map(sl, M, s) for M in (Dinv_o, Bo, Co))
        roL = [sl(v) for v in ro]
        DinvR, BoR, CoR = (_soa_map(pr, M, s) for M in (Dinv_o, Bo, Co))
        roR = [pr(v) for v in ro]
        TL = _soa_mm(Be, DinvL, s)
        TR = _soa_mm(Ce, DinvR, s)
        Dv = _soa_sub(_soa_sub(De, _soa_mm(TL, CoL, s), s),
                      _soa_mm(TR, BoR, s), s)
        B = _soa_mm(TL, BoL, s, neg=True)
        C = _soa_mm(TR, CoR, s, neg=True)
        tl_r = _soa_mv(TL, roL, s)
        tr_r = _soa_mv(TR, roR, s)
        r = [re[i] - tl_r[i] - tr_r[i] for i in range(s)]
        k = ke
    if k > 1:
        x = _dense_tail_solve(Dv, B, r, k, s)
    else:
        x = _soa_mv(_soa_inv(Dv, s), r, s)
    for Dinv_o, Bo, Co, ro, ke in reversed(stack):
        ko = Dinv_o[0][0].shape[-1]
        x_left = [xc[..., :ko] for xc in x]
        x_right = [_pad_to(xc[..., 1:], ko, -1) for xc in x]
        bl = _soa_mv(Bo, x_left, s)
        cr = _soa_mv(Co, x_right, s)
        xo = _soa_mv(Dinv_o, [ro[i] - bl[i] - cr[i] for i in range(s)], s)
        x = [_interleave(xc, xoc, -1) for xc, xoc in zip(x, xo)]
    return torch.stack(x, dim=-1).reshape(rhs.shape)


def block_cyclic_reduction_solve(D: torch.Tensor, L: torch.Tensor,
                                 rhs: torch.Tensor) -> torch.Tensor:
    """Solve the SPD block-tridiagonal ``A x = rhs`` by block cyclic
    reduction: eliminate the odd block rows in parallel, halving the
    system per level, ceil(log2(nb)) levels of batched (s, s) work instead
    of the blocked Cholesky's nb sequential steps (about twice its flops).
    At s <= 2 the blocks go struct-of-arrays (:func:`_bcr_soa`). Unpivoted
    block elimination: the same stability class as the blocked Cholesky on
    the SPD (damped-Gram) systems this serves."""
    nb, s = D.shape[-3], D.shape[-1]
    if s <= 2:
        Dv = _soa_split(D)
        Lv = _soa_split(L) if nb > 1 else None
        return _bcr_soa(Dv, Lv, rhs, nb, s)
    # Per-row couplings: B[i] = A[i, i-1] (0 at i=0), C[i] = A[i, i+1]
    # (0 at i=nb-1). Symmetric: C[i] = B[i+1]'.
    zero = torch.zeros_like(D[..., :1, :, :])
    B = torch.cat([zero, L], dim=-3)
    C = torch.cat([L.mT, zero], dim=-3)
    r = rhs.reshape(rhs.shape[:-1] + (nb, s))

    stack = []
    k = nb
    while k > 1:
        De, Do = D[..., 0::2, :, :], D[..., 1::2, :, :]
        Be, Bo = B[..., 0::2, :, :], B[..., 1::2, :, :]
        Ce, Co = C[..., 0::2, :, :], C[..., 1::2, :, :]
        re, ro = r[..., 0::2, :], r[..., 1::2, :]
        ke = De.shape[-3]
        Dinv_o = _binv(Do)
        stack.append((Dinv_o, Bo, Co, ro, ke))
        # Left odd neighbor of even j is odd j-1 (absent at j=0, where
        # Be[0] = 0 kills the term); right odd neighbor is odd j (absent
        # for the last even row of an odd-length level, where Ce[-1] = 0).
        DinvL, BoL, CoL = (_shift_down(M, ke, -3) for M in (Dinv_o, Bo, Co))
        roL = _shift_down(ro, ke, -2)
        DinvR, BoR, CoR = (_pad_to(M, ke, -3) for M in (Dinv_o, Bo, Co))
        roR = _pad_to(ro, ke, -2)
        TL = Be @ DinvL
        TR = Ce @ DinvR
        D = De - TL @ CoL - TR @ BoR
        B = -(TL @ BoL)
        C = -(TR @ CoR)
        r = re - _mv(TL, roL) - _mv(TR, roR)
        k = ke
    x = _mv(_binv(D), r)
    for Dinv_o, Bo, Co, ro, ke in reversed(stack):
        ko = Dinv_o.shape[-3]
        x_left = x[..., :ko, :]  # even j is odd j's left neighbor
        x_right = _pad_to(x[..., 1:, :], ko, -2)  # even j+1; absent edge has Co = 0
        xo = _mv(Dinv_o, ro - _mv(Bo, x_left) - _mv(Co, x_right))
        x = _interleave(x, xo, -2)
    return x.reshape(rhs.shape)


def _retry_where_not_finite(dx, retry):
    """``dx`` with the fits whose solve is not finite replaced by
    ``retry()``; the retry runs only when some fit needs it (one
    device-to-host read)."""
    bad = ~torch.isfinite(dx).all(dim=-1)
    if not bool(bad.any()):
        return dx
    return torch.where(bad.unsqueeze(-1), retry(), dx)


def solve_block_tridiag_spd_soa(Dv, Lv, rhs, nb: int, s: int):
    """SoA-input counterpart of :func:`solve_block_tridiag_spd` (cyclic
    reduction, s <= 2) with the same jittered retry, on the components from
    :func:`probe_gram_soa`."""
    n = nb * s
    eps = float(torch.finfo(rhs.dtype).eps)

    def retry():
        diag_mean = sum(torch.mean(Dv[i][i], dim=-1, keepdim=True)
                        for i in range(s)) / s
        floor = eps * torch.clamp(diag_mean, min=1.0)
        Dj = [[Dv[i][j] + (100.0 * n * eps) * (Dv[i][j] + floor) if i == j
               else Dv[i][j] for j in range(s)] for i in range(s)]
        return _bcr_soa(Dj, Lv, rhs, nb, s)

    return _retry_where_not_finite(_bcr_soa(Dv, Lv, rhs, nb, s), retry)


def solve_block_tridiag_spd(D, L, rhs, method: str = "auto"):
    """Factor and solve with the dense route's (near-)semidefinite contract
    (solver/cholesky._solve_spd): a non-finite solve is retried once with
    the scale-invariant Tikhonov jitter on the block diagonals.

    ``method``: "scan" (the blocked Cholesky), "cr" (block cyclic
    reduction) or "auto" (cr above ``_CYCLIC_REDUCTION_MIN_NB`` blocks)."""
    nb, s = D.shape[-3], D.shape[-1]
    n = nb * s
    if method == "auto":
        method = "cr" if nb > _CYCLIC_REDUCTION_MIN_NB else "scan"
    if method == "scan":
        solve = lambda Dm: block_tridiag_solve(  # noqa: E731
            *block_tridiag_cholesky(Dm, L), rhs)
    elif method == "cr":
        solve = lambda Dm: block_cyclic_reduction_solve(Dm, L, rhs)  # noqa: E731
    else:
        raise ValueError(
            f"method must be 'auto', 'scan' or 'cr', got {method!r}"
        )
    eps = float(torch.finfo(D.dtype).eps)

    def retry():
        diag = torch.diagonal(D, dim1=-2, dim2=-1)  # (..., nb, s)
        floor = eps * torch.clamp(torch.mean(diag, dim=(-2, -1), keepdim=True), min=1.0)
        jitter = (100.0 * n * eps) * (diag + floor)
        return solve(D + torch.diag_embed(jitter))

    return _retry_where_not_finite(solve(D), retry)
