"""Batch-first dense linear algebra for the QP Newton systems.

Counterpart of sdf_nmpc_tpu/solver/linalg.py (:26-287), the linear algebra
of ``solve_qp(chol_impl='custom')``: a blocked right-looking Cholesky with
block size nb = 16 whose every sequential step acts on the whole batch at
once, so the inner recursions are short chains of (..., nb)-shaped vector
ops and the O(n^3) work lands in batched matrix products.

Per block column k: the (nb, nb) diagonal block is factored by nb rank-1
steps, the panel below it solved column by column, and the trailing matrix
updated by one batched product.  The diagonal blocks' explicit inverses
(``diag_block_inverses``) turn each block substitution of a solve into a
product.  Every function takes leading batch axes ``...``; n must be a
multiple of nb, and the ``spd_*`` functions pad with an inert identity tail.
The operation order is the JAX module's, so the two agree to rounding.
"""

from __future__ import annotations

import torch


def _chol_small(D, nb: int):
    """Lower Cholesky of (..., nb, nb) SPD blocks: nb rank-1 steps."""
    cols = []
    idx = torch.arange(nb, device=D.device)
    for j in range(nb):
        dj = torch.sqrt(torch.clamp(D[..., j, j], min=1e-30))
        col = D[..., :, j] / dj[..., None]
        col = torch.where(idx >= j, col, torch.zeros_like(col))
        cols.append(col)
        if j + 1 < nb:
            D = D - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, -1)


def _panel_solve(P, Ld, nb: int):
    """X with X Ld' = P: P (..., m, nb), Ld (..., nb, nb) lower."""
    X_cols = []
    for j in range(nb):
        acc = P[..., :, j]
        for m in range(j):
            acc = acc - X_cols[m] * Ld[..., j, m][..., None]
        X_cols.append(acc / Ld[..., j, j][..., None])
    return torch.stack(X_cols, -1)


def cholesky_batched(M, nb: int = 16):
    """Lower Cholesky of (..., n, n) SPD matrices; n a multiple of nb."""
    n = M.shape[-1]
    if n % nb:
        raise ValueError(f"n = {n} is not a multiple of nb = {nb}")
    nblk = n // nb
    A = M
    col_blocks = []
    for k in range(nblk):
        Ld = _chol_small(A[..., :nb, :nb], nb)
        if k + 1 < nblk:
            L21 = _panel_solve(A[..., nb:, :nb], Ld, nb)
            A = A[..., nb:, nb:] - L21 @ L21.transpose(-1, -2)
            col_blocks.append(torch.cat([Ld, L21], -2))
        else:
            col_blocks.append(Ld)
    L = torch.zeros_like(M)
    for k, blk in enumerate(col_blocks):
        L[..., k * nb:, k * nb:(k + 1) * nb] = blk
    return L


def _solve_small_lower(Ld, b, nb: int):
    """y with Ld y = b: Ld (..., nb, nb) lower, b (..., nb)."""
    ys = []
    for i in range(nb):
        acc = b[..., i]
        for j in range(i):
            acc = acc - Ld[..., i, j] * ys[j]
        ys.append(acc / Ld[..., i, i])
    return torch.stack(ys, -1)


def _inv_lower_small(Ld, nb: int):
    """Explicit inverse of (..., nb, nb) lower-triangular blocks: forward
    substitution on the identity, all right-hand sides at once."""
    eye = torch.eye(nb, dtype=Ld.dtype, device=Ld.device)
    rows = []
    for i in range(nb):
        acc = eye[i].expand(Ld.shape[:-2] + (nb,))
        for j in range(i):
            acc = acc - Ld[..., i, j][..., None] * rows[j]
        rows.append(acc / Ld[..., i, i][..., None])
    return torch.stack(rows, -2)


def _solve_small_upper_t(Ld, b, nb: int):
    """x with Ld' x = b (back substitution)."""
    xs = [None] * nb
    for i in reversed(range(nb)):
        acc = b[..., i]
        for j in range(i + 1, nb):
            acc = acc - Ld[..., j, i] * xs[j]
        xs[i] = acc / Ld[..., i, i]
    return torch.stack(xs, -1)


def diag_block_inverses(L, nb: int = 16):
    """(..., nblk, nb, nb) inverses of the diagonal blocks of L."""
    nblk = L.shape[-1] // nb
    return torch.stack([_inv_lower_small(L[..., k * nb:(k + 1) * nb, k * nb:(k + 1) * nb], nb)
                        for k in range(nblk)], -3)


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _mtv(M, x):
    return (M.transpose(-1, -2) @ x[..., None])[..., 0]


def cho_solve_batched(L, rhs, nb: int = 16, Linv=None):
    """x with M x = rhs for L = cholesky_batched(M): L (..., n, n), rhs
    (..., n).  With ``Linv`` (diag_block_inverses(L)) each diagonal-block
    substitution is a product."""
    nblk = L.shape[-1] // nb
    blk = lambda i: slice(i * nb, (i + 1) * nb)
    ys = []
    for k in range(nblk):
        b = rhs[..., blk(k)]
        for m in range(k):
            b = b - _mv(L[..., blk(k), blk(m)], ys[m])
        ys.append(_mv(Linv[..., k, :, :], b) if Linv is not None
                  else _solve_small_lower(L[..., blk(k), blk(k)], b, nb))
    y = torch.cat(ys, -1)
    xs = [None] * nblk
    for k in reversed(range(nblk)):
        b = y[..., blk(k)]
        for m in range(k + 1, nblk):
            b = b - _mtv(L[..., blk(m), blk(k)], xs[m])
        xs[k] = (_mtv(Linv[..., k, :, :], b) if Linv is not None
                 else _solve_small_upper_t(L[..., blk(k), blk(k)], b, nb))
    return torch.cat(xs, -1)


def cho_solve_batched_mrhs(L, RHS, nb: int = 16, Linv=None):
    """X with M X = RHS for L = cholesky_batched(M): RHS (..., n, k) ->
    (..., n, k); the same block recursion, each step a (..., nb, k) product."""
    nblk = L.shape[-1] // nb
    blk = lambda i: slice(i * nb, (i + 1) * nb)
    ys = []
    for kk in range(nblk):
        b = RHS[..., blk(kk), :]
        for m in range(kk):
            b = b - L[..., blk(kk), blk(m)] @ ys[m]
        if Linv is not None:
            ys.append(Linv[..., kk, :, :] @ b)
        else:
            Ld = L[..., blk(kk), blk(kk)]
            ys.append(torch.stack([_solve_small_lower(Ld, b[..., j], nb)
                                   for j in range(b.shape[-1])], -1))
    y = torch.cat(ys, -2)
    xs = [None] * nblk
    for kk in reversed(range(nblk)):
        b = y[..., blk(kk), :]
        for m in range(kk + 1, nblk):
            b = b - L[..., blk(m), blk(kk)].transpose(-1, -2) @ xs[m]
        if Linv is not None:
            xs[kk] = Linv[..., kk, :, :].transpose(-1, -2) @ b
        else:
            Ld = L[..., blk(kk), blk(kk)]
            xs[kk] = torch.stack([_solve_small_upper_t(Ld, b[..., j], nb)
                                  for j in range(b.shape[-1])], -1)
    return torch.cat(xs, -2)


def _pad_spd(M, nb):
    n = M.shape[-1]
    n_pad = -(-n // nb) * nb
    if n_pad == n:
        return M, n
    Mp = M.new_zeros(M.shape[:-2] + (n_pad, n_pad))
    Mp[..., :n, :n] = M
    Mp.diagonal(dim1=-2, dim2=-1)[..., n:] = 1.0
    return Mp, n


def spd_factor_batched(M, nb: int = 16):
    """((L, Linv blocks), n) with the padding folded in; pair with
    spd_factor_solve / spd_factor_solve_mrhs."""
    Mp, n = _pad_spd(M, nb)
    L = cholesky_batched(Mp, nb)
    return (L, diag_block_inverses(L, nb)), n


def spd_factor_solve(factor, n_orig: int, rhs, nb: int = 16):
    L, Linv = factor
    n_pad = L.shape[-1]
    if n_pad != n_orig:
        rhs = torch.cat([rhs, rhs.new_zeros(rhs.shape[:-1] + (n_pad - n_orig,))], -1)
    return cho_solve_batched(L, rhs, nb, Linv=Linv)[..., :n_orig]


def spd_factor_solve_mrhs(factor, n_orig: int, RHS, nb: int = 16):
    """Matrix right-hand side companion of spd_factor_solve: RHS (..., n, k)."""
    L, Linv = factor
    n_pad = L.shape[-1]
    if n_pad != n_orig:
        RHS = torch.cat([RHS, RHS.new_zeros(RHS.shape[:-2] + (n_pad - n_orig, RHS.shape[-1]))],
                        -2)
    return cho_solve_batched_mrhs(L, RHS, nb, Linv=Linv)[..., :n_orig, :]


def spd_solve_batched(M, rhs, nb: int = 16):
    """x = M^-1 rhs for SPD M (..., n, n), rhs (..., n); n padded to a
    multiple of nb with an identity tail."""
    factor, n = spd_factor_batched(M, nb)
    return spd_factor_solve(factor, n, rhs, nb)
