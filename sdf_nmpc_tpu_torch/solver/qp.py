"""Batched condensed-QP solver: Mehrotra predictor-corrector interior point
with analytic slack elimination (HPIPM's soft-constraint structure).

Problem, per scenario (leading batch axis B on every field):

    min_{z,s}  0.5 z'Hz + g'z + sum_i z1_i (sl_i + su_i)
                                + 0.5 z2_i (sl_i^2 + su_i^2)
    s.t.  lh - sl <= c0 + C z <= uh + su,   sl, su >= 0,   lb <= z <= ub

``solve_qp`` runs a fixed iteration budget: ``n_warm`` iterations with the
mild-row ratio cap only, then the last ``stiff_iters`` with the stiff-row
Woodbury split, then the best-iterate / tail-average choice and the KKT
residual.  Each phase is one ``ops.ip_kernel.ip_phase`` call: on CUDA tensors
the hand-written kernel (f32), on CPU tensors its plain version (f32 or f64).
Warm duals and iterative refinement belong to the composed QP path, which is
not ported yet (ROADMAP.md), and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.ip_kernel import make_fused_solve


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


def solve_qp(qp: QpData, iters: int = 8, mu0: float = 0.1, box_margin: float = 1e-6,
             k_stiff: int = 16, stiff_iters: int = None, ratio_cap_override: float = None,
             warm_duals: QpDuals = None, ir_steps: int = 0) -> QpResult:
    """Solve a batch of condensed QPs with ``iters`` IP iterations."""
    if warm_duals is not None or ir_steps:
        raise NotImplementedError(
            "warm duals and iterative refinement need the composed QP path "
            "(kernels 5-8), which is queued in ROADMAP.md")
    nc = qp.c0.shape[-1]
    if nc == 0:
        raise NotImplementedError("a QP without general constraint rows is not ported")
    n_stiff = min(stiff_iters if stiff_iters is not None else iters, iters)
    n_warm = iters - n_stiff if k_stiff > 0 else iters
    run = make_fused_solve(iters=iters, n_warm=n_warm, k_stiff=k_stiff, mu0=mu0,
                           box_margin=box_margin, ratio_cap_override=ratio_cap_override)
    dz, kkt, mu, *duals = run(qp.H, qp.g, qp.C, qp.c0, qp.lh, qp.uh, qp.z1, qp.z2,
                              qp.lb, qp.ub)
    return QpResult(dz=dz, kkt_residual=kkt, complementarity=mu, duals=QpDuals(*duals))
