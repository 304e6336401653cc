"""The RTI step under ``flags.sdf_cost`` against the JAX package: the SDF
stage cost row widens the residual past the model's, so every family takes
kernel 9 (its plain version on the CPU) for x+, A and B and ``torch.func``
for the residual rows through the network, and every stage constraint row
goes through reverse mode, as the JAX step does.  f64, narrow network."""

import pytest

from test_torch_formulation import check_step_matches_jax


@pytest.mark.parametrize("model", ["att", "acc", "att_tau", "rates"])
def test_f64_sdf_cost_step_matches_jax(model):
    """Cold tick then steady tick, u0, X, U and the evals to 1e-6."""
    check_step_matches_jax("sdf_cost", model)
