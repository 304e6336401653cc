"""Plain float64 reference of the perception front end of BASELINE config 3:
a uint16 millimetre depth frame to the latent mean of the ResNet-VAE
encoder, from the encoder's flax parameter tree (numpy leaves).

Preprocessing: depth / (dmax in millimetres) clipped to [0, 1], then depth to
range by the per-pixel factor sqrt(1 + tan_h^2 + tan_v^2) (tan_h, tan_v
linear across the image from +tan(fov) to -tan(fov)), clipped to [0, 1].
Encoder (NCHW here; flax kernels HWIO): Conv 7x7 stride 2 pad 3 with bias,
ELU, max-pool 3x3 stride 2 pad 1 (padding never wins), four residual blocks
(3x3 conv with stride s, batch norm, ReLU, 3x3 conv, batch norm; a 1x1
strided conv with batch norm on the shortcut where s = 2; ReLU of the sum;
batch norm from its running statistics, epsilon 1e-5), an adaptive 2x2
average pool, then the ``mean`` head over the features flattened in flax's
(h, w, c) order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

STRIDES = (2, 2, 2, 1)
BN_EPS = 1e-5


def preprocess(frames, dmax_mm: float, hfov: float, vfov: float):
    """uint16 frames (B, 1, H, W) -> range images in [0, 1], float64."""
    x = frames.to(torch.float64)
    x = torch.clamp(x / dmax_mm, 0.0, 1.0)
    H, W = x.shape[-2:]
    u = torch.arange(W, dtype=torch.float64, device=x.device)
    v = torch.arange(H, dtype=torch.float64, device=x.device)
    th = np.tan(hfov) * (1 - 2 * u / W)
    tv = np.tan(vfov) * (1 - 2 * v / H)
    factor = torch.sqrt(1 + th[None, :] ** 2 + tv[:, None] ** 2)
    return torch.clamp(x * factor, 0.0, 1.0)


class EncoderRef:
    def __init__(self, tree: dict, device, dtype=torch.float64):
        self.p, self.bs = tree["params"], tree.get("batch_stats", {})
        self.t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    def conv(self, x, p, stride, pad):
        w = self.t(p["kernel"]).permute(3, 2, 0, 1)  # HWIO -> OIHW
        b = self.t(p["bias"]) if "bias" in p else None
        return F.conv2d(x, w, b, stride=stride, padding=pad)

    def bn(self, x, p, s):
        mean, var = self.t(s["mean"]), self.t(s["var"])
        scale, bias = self.t(p["scale"]), self.t(p["bias"])
        inv = scale / torch.sqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * inv[:, None, None] + bias[:, None, None]

    def block(self, x, name, stride):
        p, s = self.p[name], self.bs[name]
        h = F.relu(self.bn(self.conv(x, p["Conv_0"], stride, 1), p["BatchNorm_0"],
                           s["BatchNorm_0"]))
        h = self.bn(self.conv(h, p["Conv_1"], 1, 1), p["BatchNorm_1"], s["BatchNorm_1"])
        sc = x
        if stride != 1:
            sc = self.bn(self.conv(x, p["Conv_2"], stride, 0), p["BatchNorm_2"],
                         s["BatchNorm_2"])
        return F.relu(h + sc)

    def __call__(self, x):
        """Range images (B, 1, H, W) -> latent means (B, L)."""
        h = F.elu(self.conv(x, self.p["Conv_0"], 2, 3))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for i, s in enumerate(STRIDES):
            h = self.block(h, f"ResBlock_{i}", s)
        h = F.adaptive_avg_pool2d(h, (2, 2))
        feats = h.permute(0, 2, 3, 1).flatten(1)  # flax's (h, w, c) order
        return feats @ self.t(self.p["mean"]["kernel"]) + self.t(self.p["mean"]["bias"])
