"""BASELINE config 1 (enable_sdf off) on the kernel-9 families: the port's
f64 step (kernel 9's plain version, the residual rows by torch.func, no
constraint rows, the nc = 0 QP on the composed path) against the JAX
make_rti_step; att, acc and att_tau are in test_torch_nosdf.py."""

import pytest

from test_torch_nosdf import nosdf_step_matches_jax
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.mark.parametrize("model", ["rates", "wrench", "props"])
def test_f64_nosdf_step_matches_jax(model):
    """As test_torch_nosdf.py's: a cold tick then a steady one, within 1e-6."""
    nosdf_step_matches_jax(model)
