"""Kernel 3: condensing recursion + condensed rows (``condense``).

Counterpart of sdf_nmpc_tpu/ops/condense_kernel.py ``_condense_kernel`` (:38)
and ``condense_nodes`` (:169).  Batch-first:

    A (B, N, nx, nx), Bm (B, N, nx, nu), d (B, N, nx), e0 (B, nx),
    Jyx (B, N, ny, nx), Jyu (B, N, ny, nu), res (B, N, ny),
    Jhx (B, N, nh, nx), Jhu (B, N, nh, nu), h (B, N, nh) ->
    (e_stage (B, N, nx), E_stage (B, N, nx, nz), eN (B, nx), EN (B, nx, nz),
     G (B, N, ny, nz), res_c (B, N, ny), C (B, N, nh, nz), c0 (B, N, nh))

with e_{k+1} = A_k e_k + d_k, E_{k+1} = A_k E_k + B_k placed in column block
k, G_k = Jyx_k E_k (+ Jyu_k in block k), res_c = res + Jyx e, C_k = Jhx_k E_k
(+ Jhu_k in block k), c0 = h + Jhx e.  Needs nh >= 1.

On a CUDA tensor ``condense`` launches ``csrc/condense.cu`` (one block per
scenario, each thread four columns of E in registers, one more thread for e:
nx up to ``NX_MAX``, nz up to ``NZ_MAX``); on a CPU tensor it runs the plain
version (the scan as a Python loop).
"""

from __future__ import annotations

import torch

from . import _lib

NX_MAX = 16  # csrc/condense.cu: E's columns in registers
NZ_MAX = 508  # csrc/condense.cu: a thread per 4 columns and one for e, at most 128


def _add_block(M, k, nu, blk):
    """M (..., r, nz) with blk (..., r, nu) added into columns [k nu, (k+1) nu)."""
    M = M.clone()
    M[..., k * nu:(k + 1) * nu] += blk
    return M


def condense_plain(A, Bm, d, e0, Jyx, Jyu, res, Jhx, Jhu, h):
    B, N, nx = d.shape
    nu = Bm.shape[-1]
    nz = N * nu
    E = A.new_zeros(B, nx, nz)
    e = e0
    e_st, E_st = [], []
    for k in range(N):
        e_st.append(e)
        E_st.append(E)
        e_next = (A[:, k] @ e[..., None])[..., 0] + d[:, k]
        E = _add_block(A[:, k] @ E, k, nu, Bm[:, k])
        e = e_next
    e_st = torch.stack(e_st, 1)
    E_st = torch.stack(E_st, 1)
    G = Jyx @ E_st
    C = Jhx @ E_st
    G = torch.stack([_add_block(G[:, k], k, nu, Jyu[:, k]) for k in range(N)], 1)
    C = torch.stack([_add_block(C[:, k], k, nu, Jhu[:, k]) for k in range(N)], 1)
    res_c = res + (Jyx @ e_st[..., None])[..., 0]
    c0 = h + (Jhx @ e_st[..., None])[..., 0]
    return e_st, E_st, e, E, G, res_c, C, c0


def _check_sizes(N, nx, nu, nh):
    if nh < 1:
        raise ValueError("condense kernel needs nh >= 1 constraint rows")
    if nx > NX_MAX:
        raise ValueError(f"condense kernel keeps a column of E in registers: nx <= {NX_MAX}, "
                         f"got nx={nx}")
    if N * nu > NZ_MAX:
        raise ValueError(f"condense kernel takes a thread per four columns: nz = N nu <= "
                         f"{NZ_MAX}, got nz={N * nu}")


def condense_geometry(N, nx, nu, ny, nh) -> dict:
    """The kernel's launch at (N, nx, nu, ny, nh) on the current card:
    threads per block, dynamic shared bytes per block, resident blocks per
    SM."""
    _check_sizes(N, nx, nu, nh)
    return _lib.geometry("condense_geometry", N, nx, nu, ny, nh)


def _condense_cuda(A, Bm, d, e0, Jyx, Jyu, res, Jhx, Jhu, h):
    with _lib.launch("condense"):
        B, N, nx = d.shape
        nu, ny, nh = Bm.shape[-1], Jyx.shape[2], Jhx.shape[2]
        nz = N * nu
        _check_sizes(N, nx, nu, nh)
        ins = (A, Bm, d, e0, Jyx, Jyu, res, Jhx, Jhu, h)
        _lib.require_cuda_f32("condense", *ins)
        shapes = ((B, N, nx, nx), (B, N, nx, nu), (B, N, nx), (B, nx), (B, N, ny, nx),
                  (B, N, ny, nu), (B, N, ny), (B, N, nh, nx), (B, N, nh, nu), (B, N, nh))
        for i, (t, s) in enumerate(zip(ins, shapes)):
            _lib.require_shape(f"condense argument {i}", t, s)
        new = lambda *s: torch.empty(s, dtype=torch.float32, device=A.device)
        outs = (new(B, N, nx), new(B, N, nx, nz), new(B, nx), new(B, nx, nz),
                new(B, N, ny, nz), new(B, N, ny), new(B, N, nh, nz), new(B, N, nh))
        err = _lib.library().condense_launch(
            *[t.data_ptr() for t in ins + outs], B, N, nx, nu, ny, nh, _lib.stream_ptr())
        _lib.check(err, "condense")
        return outs


def condense(A, Bm, d, e0, Jyx, Jyu, res, Jhx, Jhu, h):
    """Kernel on CUDA tensors, plain version on CPU tensors (see module doc)."""
    if A.is_cuda:
        return _condense_cuda(A, Bm, d, e0, Jyx, Jyu, res, Jhx, Jhu, h)
    return condense_plain(A, Bm, d, e0, Jyx, Jyu, res, Jhx, Jhu, h)
