"""Kernel 3 (condense): the plain version against the JAX Pallas kernel
(interpret mode under the custom_vmap rule, f32) and the unbatched JAX scan
(f64)."""

import jax
import numpy as np

from _torch_port import one_torch_thread, t32, t64  # noqa: F401  (fixtures)

RNG = np.random.default_rng(3)
NAMES = ("e_stage", "E_stage", "eN", "EN", "G", "res_c", "C", "c0")


def _data(B, N, nx, nu, ny, nh):
    return (RNG.normal(size=(B, N, nx, nx)) * 0.4, RNG.normal(size=(B, N, nx, nu)),
            RNG.normal(size=(B, N, nx)), RNG.normal(size=(B, nx)),
            RNG.normal(size=(B, N, ny, nx)), RNG.normal(size=(B, N, ny, nu)),
            RNG.normal(size=(B, N, ny)), RNG.normal(size=(B, N, nh, nx)),
            RNG.normal(size=(B, N, nh, nu)), RNG.normal(size=(B, N, nh)))


def test_plain_f32_matches_pallas_kernel_interpret():
    """The JAX kernel test's shapes and tolerance (tests/test_qp_kernels.py):
    1e-5 absolute and relative."""
    from sdf_nmpc_tpu.ops.condense_kernel import condense_nodes
    from sdf_nmpc_tpu_torch.ops.condense_kernel import condense

    args = [a.astype(np.float32) for a in _data(3, 5, 4, 2, 6, 2)]
    want = jax.jit(jax.vmap(condense_nodes))(*args)
    got = condense(*[t32(a) for a in args])
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_plain_f64_matches_unbatched_scan():
    """f64 against the single-scenario lax.scan at the production dims
    (nx=10, nu=4, ny=11, nh=3, N=20); only summation order differs."""
    from sdf_nmpc_tpu.ops.condense_kernel import condense_nodes
    from sdf_nmpc_tpu_torch.ops.condense_kernel import condense

    args = _data(2, 20, 10, 4, 11, 3)
    got = condense(*[t64(a) for a in args])
    scan = jax.jit(condense_nodes)
    for b in range(2):
        want = scan(*[a[b] for a in args])
        for name, g, w in zip(NAMES, got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=1e-12, atol=1e-12,
                                       err_msg=name)

