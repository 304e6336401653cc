"""The port's f32 plain path on the main path's accuracy workload, against
the repo's goldens, with the JAX package's CI gate."""


def test_f32_plain_path_passes_ci_gate_on_goldens():
    """The port's f32 plain path on the 32 cold scenarios of
    accuracy_ref_u0.npz and the warm (ticks 1-3) / steady (ticks 4+) replays
    of warm_ref.npz: the JAX package's CI gate, mean <= 2.5e-4 and max <=
    2.5e-3 (tests/test_oracle_parity.py), every status OK."""
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    cold = acc.check_accuracy(device="cpu")
    assert cold["n_ok"] == cold["n_scen"] == 32
    assert acc.ci_gate_ok(cold["u0_mean_err"], cold["u0_max_err"]), cold
    warm = acc.check_warm_accuracy(device="cpu", budget="warm")
    steady = acc.check_warm_accuracy(device="cpu", budget="steady")
    assert warm["n_ok"] == warm["n_solves"] == 128
    assert steady["n_ok"] == steady["n_solves"] == 128
    g = acc.replay_gates(warm, steady)
    assert acc.ci_gate_ok(g["warm_mean"], g["warm_max"]), g
    assert acc.ci_gate_ok(g["steady_mean"], g["steady_max"]), g
