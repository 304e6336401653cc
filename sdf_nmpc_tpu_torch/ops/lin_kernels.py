"""Kernel 1: RK4 linearization + stage residual Jacobians (``lin_y_sens``).

Counterpart of sdf_nmpc_tpu/ops/lin_kernels.py ``_erk4_y_sens_kernel`` (:173)
and its wrapper ``make_lin_y_nodes`` (:249).  For M independent (scenario,
node) points it returns x+ = RK4(f, x, u, dt), A = dx+/dx, B = dx+/du,
res = y(x, u, p) - yref, Jyx = dy/dx and Jyu = dy/du.

On a CUDA tensor the wrapper launches ``csrc/lin_y_sens.cu`` (the model's
component forms f_lanes / y_lanes as device functions, forward-mode
tangents in registers).  On a CPU tensor it runs the plain version: RK4 of the
model's ``f`` (true atan2) differentiated with ``torch.func.jacfwd``, exactly
the JAX package's non-kernel path.  The two forms differ by rounding only
(the algebraic cos/sin-of-atan2 is exact), which the tests' tolerances cover.
Callers install it only when the OCP residual is exactly the model residual.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from ..solver.integrator import erk4_with_sensitivities
from . import _lib


def lin_y_sens_plain(model, X, U, dt, P, yref):
    """X (M, nx), U (M, nu), dt (M,), P (M, np), yref (M, ny) ->
    (x_next, A, B, res, Jyx, Jyu), batch-first."""

    def node(x, u, d, p):
        y_fn = lambda xv, uv: model.y(xv, uv, p)
        x_next, A, Bm = erk4_with_sensitivities(model.f, x, u, d)
        Jyx, Jyu = jacfwd(y_fn, argnums=(0, 1))(x, u)
        return x_next, A, Bm, y_fn(x, u), Jyx, Jyu

    x_next, A, Bm, y_val, Jyx, Jyu = vmap(node)(X, U, dt, P)
    return x_next, A, Bm, y_val - yref, Jyx, Jyu


def _lin_y_sens_cuda(model, layout, X, U, dt, P, yref):
    if model.kernel_limits is None or model.f_lanes is None or model.y_lanes is None:
        raise NotImplementedError(f"model {model.name!r} has no CUDA linearization kernel")
    M, nx = X.shape
    nu, ny = U.shape[-1], yref.shape[-1]
    if (nx, nu, ny) != (10, 4, 11):
        raise ValueError(f"lin_y_sens kernel is built for the att model, got {(nx, nu, ny)}")
    qd = P[:, list(layout.q_d)].contiguous()
    _lib.require_cuda_f32("lin_y_sens", X, U, dt, qd, yref)
    for name, t, shape in (("U", U, (M, nu)), ("dt", dt, (M,)), ("yref", yref, (M, ny))):
        _lib.require_shape(f"lin_y_sens {name}", t, shape)
    new = lambda *s: torch.empty((M,) + s, dtype=torch.float32, device=X.device)
    out = (new(nx), new(nx, nx), new(nx, nu), new(ny), new(ny, nx), new(ny, nu))
    lib = _lib.library()
    err = lib.lin_y_sens_launch(
        *[t.data_ptr() for t in (X, U, dt, qd, yref, *out)], M,
        *model.kernel_limits, _lib.stream_ptr())
    _lib.check(err, "lin_y_sens")
    _lib.launch_counts["lin_y_sens"] += 1
    return out


def lin_y_sens(model, layout, X, U, dt, P, yref):
    """Kernel on CUDA tensors, plain version on CPU tensors (see module doc)."""
    if X.is_cuda:
        return _lin_y_sens_cuda(model, layout, X, U, dt, P, yref)
    return lin_y_sens_plain(model, X, U, dt, P, yref)
