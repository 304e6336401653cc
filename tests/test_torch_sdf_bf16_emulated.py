"""Kernel 2's bf16 and mixed routes (``sdf_nmpc_tpu_torch/csrc/
sdf_fused_bf16.cu``) run on the CPU in the g++ emulation of the CUDA
execution model (``tests/_torch_port.py``, with ``BF16_CUH``: ldmatrix and
the m16n8k16 product gather the warp's addresses and fragments, so a
fragment-layout swap, a wrong chunk order or a mis-packed pair shows; the
bulk copies complete on emulated mbarriers, and shared memory is poisoned
with a word that is NaN as f32 and as bf16), through the package's own
wrapper ``_sdf_value_grad_bf16_cuda``, against the plain versions of each
mode."""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from _torch_port import BF16_CUH, CSRC, build_emulated, load_emulated, t32, use_emulated
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def emulated_bf16(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation of sdf_fused_bf16.cu")
    out = tmp_path_factory.mktemp("sdf_fused_bf16")
    return load_emulated(build_emulated(CSRC / "sdf_fused_bf16.cu", out,
                                        headers={"bf16.cuh": BF16_CUH}))


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
@pytest.mark.parametrize("L, P, embed, act", [(16, 40, "oct", "sin"), (128, 37, "oct", "sin"),
                                              (5, 33, "none", "relu"),
                                              (20, 9, "pos", "softplus"),
                                              (128, 50, "oct", "sin")])
def test_bf16_kernel_emulated(emulated_bf16, monkeypatch, mode, L, P, embed, act):
    """A 4x32 NeuralDF (hidden widths padded to 256 in the kernel), P points
    (whole tiles and a partial one under the 16-point bf16 and 32-point
    mixed tiles; the latent 128 of the production net: eight latent chunks;
    latent 5 and 20: no 16-byte latent rows), against the mode's plain
    version: the median deviation within 1e-6 and every deviation within
    1e-3.  The emulation sums each 16-deep step exactly and rounds it once,
    so it differs from the plain version's f32 matmul by sum rounding, which
    a bf16 rounding of the next layer's input can carry to 1e-4 on a point
    (measured 8.3e-5 at L=128)."""
    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.ops import _lib, sdf_fused

    use_emulated(monkeypatch, emulated_bf16)
    net = NeuralDF(size_latent=L, layer_sizes=(32, 32, 32, 32), embed=embed, act=act, w0=2.0,
                   generator=torch.Generator().manual_seed(1))
    packed = sdf_fused.pack_neural_df_params(net, torch.float32)
    rng = np.random.default_rng(L + P)
    pos, lat = t32(rng.normal(size=(P, 3))), t32(rng.normal(size=(P, L)) * 0.3)
    before = _lib.launch_counts[f"sdf_fused_{mode}"]
    got = sdf_fused._sdf_value_grad_bf16_cuda(packed, pos, lat, mode)
    assert _lib.launch_counts[f"sdf_fused_{mode}"] == before + 1
    for g, w in zip(got, sdf_fused.PLAIN[mode](packed, pos, lat)):
        d = (g - w).abs()
        assert d.median() <= 1e-6 and d.max() <= 1e-3, (float(d.median()), float(d.max()))


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
def test_bf16_kernel_emulated_wide_latent(emulated_bf16, monkeypatch, mode):
    """Latent 256 (16 latent chunks), 50 points: the staged input rows do
    not fit in the activations' space and go past the resident input rows.
    Held per point as chip_smoke.py's SDF_BF16_RULE holds the card (value,
    gradient: at most 2% / 10% of the entries beyond 1e-3, the median within
    1e-6, the max within 2e-2 / 5e-2): with 16 more 16-deep steps per row a
    one-ulp difference of a sum flips a bf16 rounding on some point (1.7e-3
    on one gradient entry here)."""
    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.ops import sdf_fused

    use_emulated(monkeypatch, emulated_bf16)
    net = NeuralDF(size_latent=256, layer_sizes=(32, 32, 32, 32), embed="oct", act="sin",
                   w0=2.0, generator=torch.Generator().manual_seed(1))
    packed = sdf_fused.pack_neural_df_params(net, torch.float32)
    rng = np.random.default_rng(306)
    pos, lat = t32(rng.normal(size=(50, 3))), t32(rng.normal(size=(50, 256)) * 0.3)
    got = sdf_fused._sdf_value_grad_bf16_cuda(packed, pos, lat, mode)
    rules = ((1e-3, 0.02, 1e-6, 2e-2), (1e-3, 0.10, 1e-6, 5e-2))
    for g, w, (thr, share, med, mx) in zip(got, sdf_fused.PLAIN[mode](packed, pos, lat), rules):
        d = (g - w).abs()
        assert bool(torch.isfinite(g).all())
        assert float((d > thr).double().mean()) <= share and float(d.median()) <= med
        assert float(d.max()) <= mx, float(d.max())
