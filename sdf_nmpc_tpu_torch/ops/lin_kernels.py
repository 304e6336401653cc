"""Kernels 1 and 9: RK4 linearization of the dynamics, per shooting node.

Kernel 1 (``lin_y_sens``) is the counterpart of
sdf_nmpc_tpu/ops/lin_kernels.py ``_erk4_y_sens_kernel`` (:173) and its
wrapper ``make_lin_y_nodes`` (:249).  For M independent (scenario, node)
points it returns x+ = RK4(f, x, u, dt), A = dx+/dx, B = dx+/du,
res = y(x, u, p) - yref, Jyx = dy/dx and Jyu = dy/du.  It serves the models
with a component-form residual (``y_lanes``): att, acc and att_tau.

Kernel 9 (``erk4_sens``) is the counterpart of ``_erk4_sens_kernel`` (:49)
and ``make_erk4_sens_nodes`` (:120): x+, A and B alone, for the models
without ``y_lanes`` (rates, wrench, props), and for every model when the
OCP's stage residual is wider than the model's (``flags.sdf_cost``: att,
acc and att_tau too); the residual rows then come from ``torch.func`` in
the step, as in the JAX package (its solver/sqp.py:291-308).

On CUDA tensors each wrapper launches its CUDA source (``csrc/lin_y_sens.cu``,
``csrc/erk4_sens.cu``), instantiated per model: the model's component forms
f_lanes / y_lanes as device functions, two forward-mode tangents per thread
in registers (``csrc/dual2.cuh``), the model's constants
(``ModelSpec.kernel_consts``) passed by value, the instantiation named by
``ModelSpec.kernel_ids``.  A model without an
instantiation of that kernel raises.  On CPU tensors a wrapper runs its plain
version: RK4 of the model's ``f`` (true atan2 / asin) differentiated with
``torch.func.jacfwd``, exactly the JAX package's non-kernel path.  The two
forms differ by rounding only (att's algebraic cos/sin-of-atan2 is exact),
which the tests' tolerances cover.
"""

from __future__ import annotations

import ctypes

import torch
from torch.func import jacfwd, vmap

from ..models.base import N_KERNEL_CONSTS
from ..solver.integrator import erk4_with_sensitivities
from . import _lib


def _model_id(kernel: str, model) -> int:
    """The model's instantiation id in ``kernel``'s source (ModelSpec.kernel_ids)."""
    ids = dict(model.kernel_ids)
    if kernel not in ids:
        raise NotImplementedError(
            f"{kernel} has no CUDA instantiation for model {model.name!r} (its instances: "
            f"{ids})")
    return ids[kernel]


def _consts(model):
    return (ctypes.c_float * N_KERNEL_CONSTS)(*model.kernel_consts)


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
    with _lib.launch("lin_y_sens"):
        model_id = _model_id("lin_y_sens", model)
        M, nx = X.shape
        nu, ny = U.shape[-1], yref.shape[-1]
        if (nx, nu, ny) != (10, 4, 11):
            raise ValueError(f"lin_y_sens kernel is built for (nx, nu, ny) = (10, 4, 11), got "
                             f"{(nx, nu, ny)}")
        qd = layout.get_q_d(P).contiguous()
        _lib.require_cuda_f32("lin_y_sens", X, U, dt, qd, yref)
        for name, t, shape in (("U", U, (M, nu)), ("dt", dt, (M,)), ("yref", yref, (M, ny))):
            _lib.require_shape(f"lin_y_sens {name}", t, shape)
        new = lambda *s: torch.empty((M,) + s, dtype=torch.float32, device=X.device)
        out = (new(nx), new(nx, nx), new(nx, nu), new(ny), new(ny, nx), new(ny, nu))
        err = _lib.library().lin_y_sens_launch(
            *[t.data_ptr() for t in (X, U, dt, qd, yref, *out)], M, model_id, _consts(model),
            N_KERNEL_CONSTS, _lib.stream_ptr())
        _lib.check(err, "lin_y_sens")
        return out


def lin_y_sens_geometry(model) -> dict:
    """Kernel 1's launch for ``model``'s instantiation on the current card:
    threads per block, dynamic shared bytes per block, resident blocks per
    SM."""
    return _lib.geometry("lin_y_sens_geometry", _model_id("lin_y_sens", model))


def lin_y_sens(model, layout, X, U, dt, P, yref):
    """Kernel 1 on CUDA tensors, plain version on CPU tensors (see module doc)."""
    if X.is_cuda:
        return _lin_y_sens_cuda(model, layout, X, U, dt, P, yref)
    return lin_y_sens_plain(model, X, U, dt, P, yref)


def erk4_sens_plain(model, X, U, dt):
    """X (M, nx), U (M, nu), dt (M,) -> (x_next (M, nx), A (M, nx, nx),
    B (M, nx, nu)): vmap of erk4_with_sensitivities on the model's f."""
    return vmap(lambda x, u, d: erk4_with_sensitivities(model.f, x, u, d))(X, U, dt)


def _erk4_sens_cuda(model, X, U, dt):
    with _lib.launch("erk4_sens"):
        model_id = _model_id("erk4_sens", model)
        M, nx = X.shape
        nu = U.shape[-1]
        if (nx, nu) != (model.nx, 4):
            raise ValueError(f"erk4_sens for {model.name!r} takes (nx, nu) = ({model.nx}, 4), got "
                             f"{(nx, nu)}")
        _lib.require_cuda_f32("erk4_sens", X, U, dt)
        _lib.require_shape("erk4_sens U", U, (M, nu))
        _lib.require_shape("erk4_sens dt", dt, (M,))
        new = lambda *s: torch.empty((M,) + s, dtype=torch.float32, device=X.device)
        out = (new(nx), new(nx, nx), new(nx, nu))
        err = _lib.library().erk4_sens_launch(
            *[t.data_ptr() for t in (X, U, dt, *out)], M, model_id, _consts(model),
            N_KERNEL_CONSTS, _lib.stream_ptr())
        _lib.check(err, "erk4_sens")
        return out


def erk4_sens_geometry(model) -> dict:
    """Kernel 9's launch for ``model``'s instantiation on the current card:
    threads per block, dynamic shared bytes per block, resident blocks per
    SM."""
    return _lib.geometry("erk4_sens_geometry", _model_id("erk4_sens", model))


def erk4_sens(model, X, U, dt):
    """Kernel 9 on CUDA tensors, plain version on CPU tensors (see module doc)."""
    if X.is_cuda:
        return _erk4_sens_cuda(model, X, U, dt)
    return erk4_sens_plain(model, X, U, dt)
