"""Batched condensed-QP solver: Mehrotra predictor-corrector interior point
with analytic slack elimination (HPIPM's soft-constraint structure).

Problem, per scenario (leading batch axis B on every field):

    min_{z,s}  0.5 z'Hz + g'z + sum_i z1_i (sl_i + su_i)
                                + 0.5 z2_i (sl_i^2 + su_i^2)
    s.t.  lh - sl <= c0 + C z <= uh + su,   sl, su >= 0,   lb <= z <= ub

``solve_qp`` runs a fixed iteration budget: ``n_warm`` iterations with the
mild-row ratio cap only, then the last ``stiff_iters`` with the stiff-row
Woodbury split, then the best-iterate / tail-average choice and the KKT
residual.  It takes one of two paths, chosen from the arguments and the
shapes before anything runs, as solver/qp.py:144-199 chooses:

* the fused path (``chol_impl`` 'auto' or 'fused', where the fused kernel
  supports the problem: f32, no warm duals, no refinement, constraint rows
  present (nc > 0) and a stiff split of a multiple of 8 rows, at most nc):
  each phase is one ``ops.ip_kernel.ip_phase`` call (kernel 4);
* the composed path (``chol_impl`` 'pallas', or anything the fused kernel
  does not support): the iteration body runs in torch, one iteration at a
  time, and its Newton solves go through kernels 5-8
  (``ops.qp_kernels``): kernels 7 and 8 for a stiff split of a multiple of
  8 rows, else kernels 5 and 6.  Warm duals, refinement sweeps, f64, a
  ``compute_dtype``, a stiff split the fused kernel does not take and a QP
  without constraint rows (nc = 0: no stiff rows, kernels 5 and 6 on H +
  diag(rb)) go this way;
* the composed path on other linear algebra, as the JAX package's routes:
  ``chol_impl`` 'xla' (torch.linalg's Cholesky and solves, no kernel) and
  'custom' (solver/linalg.py's blocked factorization, no kernel).

On CUDA tensors the kernels run (f32); on CPU tensors their plain versions
(f32 or f64).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.ip_kernel import (
    ip_consts,
    ip_finish,
    ip_init,
    ip_schedule,
    make_fused_solve,
    run_phase,
)


class QpData(NamedTuple):
    H: torch.Tensor  # (B, nz, nz) Hessian (PSD; includes LM regularization)
    g: torch.Tensor  # (B, nz)
    C: torch.Tensor  # (B, nc, nz) general-constraint rows
    c0: torch.Tensor  # (B, nc) row values at z=0
    lh: torch.Tensor  # (B, nc)
    uh: torch.Tensor  # (B, nc)
    z1: torch.Tensor  # (B, nc) L1 slack penalty weights
    z2: torch.Tensor  # (B, nc) L2 slack penalty weights
    lb: torch.Tensor  # (B, nz) box lower
    ub: torch.Tensor  # (B, nz) box upper


class QpDuals(NamedTuple):
    sl: torch.Tensor
    su: torch.Tensor
    lam_l: torch.Tensor
    lam_u: torch.Tensor
    gam_l: torch.Tensor
    gam_u: torch.Tensor
    nu_l: torch.Tensor
    nu_u: torch.Tensor


class QpResult(NamedTuple):
    dz: torch.Tensor  # (B, nz)
    kkt_residual: torch.Tensor  # (B,) inf-norm of projected stationarity
    complementarity: torch.Tensor  # (B,) final average complementarity
    duals: QpDuals = None


CHOL_IMPLS = ("auto", "fused", "pallas", "xla", "custom")
# the composed path's Newton route per chol_impl (ops/ip_kernel.py ``_newton``)
_ROUTES = {"auto": "kernels", "fused": "kernels", "pallas": "kernels", "xla": "plain",
           "custom": "custom"}


def _composed_solve(qp: QpData, iters, n_warm, k_stiff, mu0, box_margin, ratio_cap_override,
                    warm_duals, ir_steps, route, compute_dtype=None):
    fdt = None
    if compute_dtype is not None:  # the IP arithmetic in compute_dtype, the solves in qp's
        fdt = qp.g.dtype
        qp = QpData(*[t.to(compute_dtype) for t in qp])
        if warm_duals is not None:
            warm_duals = QpDuals(*[t.to(compute_dtype) for t in warm_duals])
    consts = ip_consts(qp.g.dtype, ratio_cap_override)
    data, state = ip_init(qp.H, qp.g, qp.C, qp.c0, qp.lh, qp.uh, qp.z1, qp.z2, qp.lb, qp.ub,
                          mu0, box_margin, consts, warm_duals)
    phases, n_tail = ip_schedule(iters, n_warm, k_stiff, qp.c0.shape[-1])
    for k_s, n_iters, it0, tail in phases:
        state = run_phase(data, state, k_s, n_iters, it0, consts, tail, route=route,
                          ir_steps=ir_steps, fdt=fdt)
    return ip_finish(data, state, n_tail)


def solve_qp(qp: QpData, iters: int = 8, mu0: float = 0.1, box_margin: float = 1e-6,
             k_stiff: int = 16, stiff_iters: int = None, ratio_cap_override: float = None,
             warm_duals: QpDuals = None, ir_steps: int = 0,
             chol_impl: str = "auto", compute_dtype=None) -> QpResult:
    """Solve a batch of condensed QPs with ``iters`` IP iterations.

    chol_impl: 'auto' / 'fused' (kernel 4 where it takes the problem, else
    the composed path through kernels 5-8), 'pallas' (the composed path
    through kernels 5-8), 'xla' (the composed path on torch.linalg's
    Cholesky and cholesky_solve, the counterpart of jnp.linalg) or 'custom'
    (the composed path on solver/linalg.py's blocked factorization).
    compute_dtype: the IP vector arithmetic (residuals, gaps, Schur
    coefficients, updates) in this dtype, the factorizations and solves in
    the data's (solver/qp.py:132-136, 205-208); it takes the composed path."""
    nc = qp.c0.shape[-1]
    if chol_impl not in CHOL_IMPLS:
        raise ValueError(f"unknown chol_impl {chol_impl!r}: one of {CHOL_IMPLS}")
    n_stiff = min(stiff_iters if stiff_iters is not None else iters, iters)
    n_warm = iters - n_stiff if k_stiff > 0 else iters
    fused = chol_impl in ("auto", "fused") and (
        qp.g.dtype == torch.float32 and warm_duals is None and ir_steps == 0 and nc > 0
        and compute_dtype is None
        and (n_stiff == 0 or (k_stiff % 8 == 0 and nc >= k_stiff)))
    if fused:
        run = make_fused_solve(iters=iters, n_warm=n_warm, k_stiff=k_stiff, mu0=mu0,
                               box_margin=box_margin, ratio_cap_override=ratio_cap_override)
        out = run(qp.H, qp.g, qp.C, qp.c0, qp.lh, qp.uh, qp.z1, qp.z2, qp.lb, qp.ub)
    else:
        out = _composed_solve(qp, iters, n_warm, k_stiff, mu0, box_margin, ratio_cap_override,
                              warm_duals, ir_steps, _ROUTES[chol_impl], compute_dtype)
    dz, kkt, mu, *duals = out
    return QpResult(dz=dz, kkt_residual=kkt, complementarity=mu, duals=QpDuals(*duals))
