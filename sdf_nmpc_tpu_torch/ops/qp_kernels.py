"""Kernels 5-8: the Newton-system solves of the composed QP path.

Counterparts of sdf_nmpc_tpu/ops/qp_kernels.py, batch-first:

    factor_solve(M (B,n,n), RHS (B,r,n)) -> (X (B,r,n), L (B,n,n))
        ``_factor_solve_L_kernel`` (:200): L = chol(M), X = M^-1 RHS
    solve(L (B,n,n), RHS (B,r,n)) -> X (B,r,n)
        ``_solve_only_kernel`` (:242): X = (L L')^-1 RHS
    stiff_factor_solve(A (B,n,n), RHS (B,r,n), Cs (B,k,n), ds_inv (B,k))
        -> (X (B,r,n), (L (B,n,n), Xs (B,k,n), Lt (B,k,k)))
        ``_stiff_factor_solve_kernel`` (:311): X = M^-1 RHS for
        M = A + Cs' diag(1/ds_inv) Cs through the Woodbury identity, with
        Xs = A^-1 Cs and Lt = chol(Cs Xs' + diag(ds_inv) + jitter)
    stiff_resolve(L, Xs, Lt, Cs, RHS (B,r,n)) -> X (B,r,n)
        ``_stiff_resolve_kernel`` (:338): the same solve for more rows

Right-hand sides are rows.  The semantics are the JAX single-scenario
primals (:447-452, :494-496, :516-532, :568-572); the TPU kernels' lanes
layout and their padding to 128 scenarios have no counterpart here.

On CUDA tensors each wrapper launches its kernel of ``csrc/qp_solve.cu``
(f32, else it raises; all four on ``csrc/ip_dense.cuh``'s blocked Cholesky,
warp-level solves and warp-level Woodbury helpers); on CPU tensors it runs
its plain version (f32 or f64), ``torch.linalg.cholesky`` and
``torch.cholesky_solve``.  A failed factorization gives NaN in the plain
version, as ``jnp.linalg.cholesky`` does; the kernels clamp the pivot, as
the TPU kernels do.
"""

from __future__ import annotations

import torch

from . import _lib


def chol_plain(A):
    """Lower Cholesky factor; a failed factorization gives NaN (as in JAX)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info > 0)[:, None, None], torch.full_like(L, float("nan")), L)


def _rows_solve(L, R):
    """(L L')^-1 applied to the rows of R (B, r, n)."""
    return torch.cholesky_solve(R.transpose(-1, -2), L).transpose(-1, -2)


def woodbury_matrix(Cs, Xs, ds_inv, eps=None):
    """T = Cs Xs' + diag(ds_inv) with the relative jitter 10 eps (|T_ii| +
    1e-30) of solver/qp.py (:479-481) and of the stiff kernel (:328-330);
    eps is the factorization dtype's (default: Cs's)."""
    eps = torch.finfo(Cs.dtype).eps if eps is None else eps
    T = Cs @ Xs.transpose(-1, -2) + torch.diag_embed(ds_inv)
    diag = torch.diagonal(T, dim1=-2, dim2=-1)
    return T + torch.diag_embed(10 * eps * (diag.abs() + 1e-30))


def _woodbury_rows(X0, Xs, Lt, Cs):
    """X0 - (Xs' (T^-1 Cs X0'))' for the rows of X0, T factored in Lt."""
    y = torch.cholesky_solve(Cs @ X0.transpose(-1, -2), Lt)  # (B, k, r)
    return X0 - (Xs.transpose(-1, -2) @ y).transpose(-1, -2)


def factor_solve_plain(M, RHS):
    L = chol_plain(M)
    return _rows_solve(L, RHS), L


def solve_plain(L, RHS):
    return _rows_solve(L, RHS)


def stiff_factor_solve_plain(A, RHS, Cs, ds_inv):
    L = chol_plain(A)
    Xs = _rows_solve(L, Cs)
    Lt = chol_plain(woodbury_matrix(Cs, Xs, ds_inv))
    return _woodbury_rows(_rows_solve(L, RHS), Xs, Lt, Cs), (L, Xs, Lt)


def stiff_resolve_plain(L, Xs, Lt, Cs, RHS):
    return _woodbury_rows(_rows_solve(L, RHS), Xs, Lt, Cs)


def _check(name, tensors, shapes):
    _lib.require_cuda_f32(name, *tensors)
    for i, (t, s) in enumerate(zip(tensors, shapes)):
        _lib.require_shape(f"{name} argument {i}", t, s)


def _factor_solve_cuda(M, RHS):
    with _lib.launch("factor_solve"):
        B, n, r = M.shape[0], M.shape[-1], RHS.shape[1]
        _check("factor_solve", (M, RHS), ((B, n, n), (B, r, n)))
        X, L = torch.empty_like(RHS), torch.empty_like(M)
        err = _lib.library().factor_solve_launch(M.data_ptr(), RHS.data_ptr(), X.data_ptr(),
                                                 L.data_ptr(), B, n, r, _lib.stream_ptr())
        _lib.check(err, "factor_solve")
        return X, L


def factor_solve_geometry(n, r) -> dict:
    """Kernel 5's launch at (n, r) on the current card: threads per block,
    dynamic shared bytes per block, resident blocks per SM."""
    return _lib.geometry("factor_solve_geometry", n, r)


def stiff_factor_solve_geometry(n, r, k) -> dict:
    """Kernel 7's launch at (n, r, k), as factor_solve_geometry."""
    return _lib.geometry("stiff_factor_solve_geometry", n, r, k)


def stiff_resolve_geometry(n, r, k) -> dict:
    """Kernel 8's launch at (n, r, k), as factor_solve_geometry."""
    return _lib.geometry("stiff_resolve_geometry", n, r, k)


def _solve_cuda(L, RHS):
    with _lib.launch("solve"):
        B, n, r = L.shape[0], L.shape[-1], RHS.shape[1]
        _check("solve", (L, RHS), ((B, n, n), (B, r, n)))
        X = torch.empty_like(RHS)
        err = _lib.library().solve_launch(L.data_ptr(), RHS.data_ptr(), X.data_ptr(), B, n, r,
                                          _lib.stream_ptr())
        _lib.check(err, "solve")
        return X


def _stiff_factor_solve_cuda(A, RHS, Cs, ds_inv):
    with _lib.launch("stiff_factor_solve"):
        B, n, r, k = A.shape[0], A.shape[-1], RHS.shape[1], Cs.shape[1]
        _check("stiff_factor_solve", (A, RHS, Cs, ds_inv),
               ((B, n, n), (B, r, n), (B, k, n), (B, k)))
        X, L, Xs = torch.empty_like(RHS), torch.empty_like(A), torch.empty_like(Cs)
        Lt = torch.empty((B, k, k), dtype=A.dtype, device=A.device)
        err = _lib.library().stiff_factor_solve_launch(
            *[t.data_ptr() for t in (A, RHS, Cs, ds_inv, X, L, Xs, Lt)], B, n, r, k,
            _lib.stream_ptr())
        _lib.check(err, "stiff_factor_solve")
        return X, (L, Xs, Lt)


def _stiff_resolve_cuda(L, Xs, Lt, Cs, RHS):
    with _lib.launch("stiff_resolve"):
        B, n, r, k = L.shape[0], L.shape[-1], RHS.shape[1], Cs.shape[1]
        _check("stiff_resolve", (L, Xs, Lt, Cs, RHS),
               ((B, n, n), (B, k, n), (B, k, k), (B, k, n), (B, r, n)))
        X = torch.empty_like(RHS)
        err = _lib.library().stiff_resolve_launch(
            *[t.data_ptr() for t in (L, Cs, Xs, Lt, RHS, X)], B, n, r, k, _lib.stream_ptr())
        _lib.check(err, "stiff_resolve")
        return X


def factor_solve(M, RHS):
    """Kernel 5 on CUDA tensors, plain version on CPU tensors (module doc)."""
    return _factor_solve_cuda(M, RHS) if M.is_cuda else factor_solve_plain(M, RHS)


def solve(L, RHS):
    """Kernel 6 on CUDA tensors, plain version on CPU tensors (module doc)."""
    return _solve_cuda(L, RHS) if L.is_cuda else solve_plain(L, RHS)


def stiff_factor_solve(A, RHS, Cs, ds_inv):
    """Kernel 7 on CUDA tensors, plain version on CPU tensors (module doc)."""
    if A.is_cuda:
        return _stiff_factor_solve_cuda(A, RHS, Cs, ds_inv)
    return stiff_factor_solve_plain(A, RHS, Cs, ds_inv)


def stiff_resolve(L, Xs, Lt, Cs, RHS):
    """Kernel 8 on CUDA tensors, plain version on CPU tensors (module doc)."""
    if L.is_cuda:
        return _stiff_resolve_cuda(L, Xs, Lt, Cs, RHS)
    return stiff_resolve_plain(L, Xs, Lt, Cs, RHS)
