"""Kernel 2's f32 route (``sdf_nmpc_tpu_torch/csrc/sdf_fused.cu``: the
register-tiled FFMA products of ``ffma_tile.cuh`` fed by a cp.async ring) run
on the CPU in the g++ emulation of the CUDA execution model
(``tests/_torch_port.py``: each CUDA thread a ``std::thread``, barriers as
``std::barrier``s, shared memory poisoned with NaN, the ring's copies done at
once by the emulated ``async_copy.cuh``), through the package's own wrapper
``_sdf_value_grad_cuda``, against the exact plain version."""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from _torch_port import CSRC, build_emulated, load_emulated, t32, use_emulated
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def emulated_f32(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation of sdf_fused.cu")
    out = tmp_path_factory.mktemp("sdf_fused")
    return load_emulated(build_emulated(CSRC / "sdf_fused.cu", out))


@pytest.mark.parametrize("L, P, embed, act", [(16, 45, "oct", "sin"), (128, 37, "oct", "sin"),
                                              (16, 40, "none", "relu"),
                                              (128, 33, "pos", "softplus")])
def test_f32_kernel_emulated(emulated_f32, monkeypatch, L, P, embed, act):
    """A 4x32 NeuralDF (hidden widths padded to 256 in the kernel), P points
    (two 16-point tiles and a partial one; latent 128, the production net's:
    eight latent chunks that multiply the primal rows alone), against
    ``sdf_value_grad_plain``: value within 1e-5 and gradient within 1e-4,
    the tolerances tests/test_torch_sdf_fused.py holds the x3 layout to.
    The kernel sums each output as one FMA chain over k, the plain version's
    f32 matmul in its own order, so they differ by rounding alone; a row,
    column or chunk out of place moves an output by 1e-2 or more, and a read
    of shared memory that no copy or epilogue wrote brings the emulation's
    NaN poison into it."""
    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.ops import _lib, sdf_fused

    use_emulated(monkeypatch, emulated_f32)
    net = NeuralDF(size_latent=L, layer_sizes=(32, 32, 32, 32), embed=embed, act=act, w0=2.0,
                   generator=torch.Generator().manual_seed(3))
    packed = sdf_fused.pack_neural_df_params(net, torch.float32)
    rng = np.random.default_rng(L + P)
    pos, lat = t32(rng.normal(size=(P, 3))), t32(rng.normal(size=(P, L)) * 0.3)
    before = _lib.launch_counts["sdf_fused"]
    got = sdf_fused._sdf_value_grad_cuda(packed, pos, lat)
    assert _lib.launch_counts["sdf_fused"] == before + 1
    want = sdf_fused.sdf_value_grad_plain(packed, pos, lat)
    for g, w, tol in zip(got, want, (1e-5, 1e-4)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, atol=tol, rtol=0)
