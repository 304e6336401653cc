"""Hand-written CUDA kernels of the RTI step and their plain PyTorch versions.

Each wrapper launches its kernel on CUDA tensors and runs its plain version
on CPU tensors; ``_lib.launch_counts`` counts the kernel launches."""

from ._lib import launch_counts, reset_launch_counts
from .condense_kernel import condense, condense_plain
from .ip_kernel import ip_phase, ip_phase_plain, make_fused_solve
from .lin_kernels import erk4_sens, erk4_sens_plain, lin_y_sens, lin_y_sens_plain
from .qp_kernels import (
    factor_solve,
    factor_solve_plain,
    solve,
    solve_plain,
    stiff_factor_solve,
    stiff_factor_solve_plain,
    stiff_resolve,
    stiff_resolve_plain,
)
from .sdf_fused import (
    embed_with_tangents,
    pack_neural_df_params,
    sdf_value_grad,
    sdf_value_grad_bf16_plain,
    sdf_value_grad_mixed_plain,
    sdf_value_grad_plain,
    sdf_value_grad_x3_plain,
)

__all__ = [
    "condense", "condense_plain", "embed_with_tangents", "erk4_sens", "erk4_sens_plain",
    "factor_solve", "factor_solve_plain",
    "ip_phase", "ip_phase_plain", "launch_counts", "lin_y_sens", "lin_y_sens_plain",
    "make_fused_solve", "pack_neural_df_params", "reset_launch_counts", "sdf_value_grad",
    "sdf_value_grad_bf16_plain", "sdf_value_grad_mixed_plain", "sdf_value_grad_plain",
    "sdf_value_grad_x3_plain", "solve", "solve_plain", "stiff_factor_solve",
    "stiff_factor_solve_plain", "stiff_resolve", "stiff_resolve_plain",
]
