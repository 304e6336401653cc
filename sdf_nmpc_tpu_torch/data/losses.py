"""Training losses: the masked / biased VAE reconstruction, the beta-KLD, a
weighted BCE, and the composite SDF regression with its gradient and
eikonal terms.

Counterpart of sdf_nmpc_tpu/data/losses.py (reference
sdf_nmpc/utils/losses.py).  ``loss_sdf`` takes the network's input
gradient by ``torch.autograd.grad`` with ``create_graph=True``, so the
parameter gradient of a loss that reads it runs a double backward.
"""

from __future__ import annotations

import torch


def _loss_with_invalid_pixels(loss, target):
    """Invalid (0) target pixels masked, the rest summed per image, the
    mean taken over the batch."""
    masked = torch.where(target > 0, loss, torch.zeros_like(loss))
    return masked.sum(dim=tuple(range(1, loss.dim()))).mean()


def loss_mse_valid_pixels(target, reconst):
    return _loss_with_invalid_pixels((reconst - target) ** 2, target)


def loss_mse_valid_pixels_bias_distance(target, reconst, weight_ratio=0.1, degree=2):
    """Errors weighted toward the near-range pixels."""
    mse = (reconst - target) ** 2
    return _loss_with_invalid_pixels(mse * (target**degree * (weight_ratio - 1) + 1), target)


def loss_mse_valid_pixels_bias_positive(target, reconst, weight_ratio=0.1):
    """Asymmetric: an error that predicts farther than the target counts in
    full, one that predicts closer by ``weight_ratio``."""
    mse = (reconst - target) ** 2
    return _loss_with_invalid_pixels(torch.where(target > reconst, mse * weight_ratio, mse),
                                     target)


def loss_mse_valid_pixels_bias_pos_dist(target, reconst, pos_ratio=1.0, dist_ratio=1.0,
                                        degree=2):
    """The positive and the distance bias together."""
    mse = (reconst - target) ** 2
    biased = torch.where(target > reconst, mse * pos_ratio, mse)
    return _loss_with_invalid_pixels(biased * (target**degree * (dist_ratio - 1) + 1), target)


def loss_kld(mean, logvar, beta, size_latent, size_img):
    """beta-normalized KLD (beta-VAE, https://openreview.net/pdf?id=Sy2fzU9gl)."""
    beta_norm = (beta * size_latent) / (size_img[0] * size_img[1])
    kld = torch.mean(-0.5 * torch.sum(1 + logvar - mean**2 - torch.exp(logvar), dim=1))
    return kld * beta_norm


def loss_weighted_bce(predictions, labels, weights=(1.0, 1.0)):
    """Class-weighted binary cross-entropy."""
    p = torch.clamp(predictions, 1e-7, 1 - 1e-7)
    bce = -weights[1] * labels * torch.log(p) - weights[0] * (1 - labels) * torch.log(1 - p)
    return bce.mean()


def value_and_input_grad(apply_fn, inputs, grad_apply_fn=None, create_graph=True):
    """(values (...,), input gradient (..., 3)) of the network: apply_fn(x)
    -> (..., 1) is the value path; the gradient of the first 3 inputs comes
    from ``grad_apply_fn``'s forward when given (a second forward: in
    training, the JAX package's gradient path, whose dropout masks are drawn
    apart from the value path's), else from the value path's own forward."""
    with torch.enable_grad():
        x = inputs.detach().requires_grad_(True)
        out = apply_fn(x)
        grad_out = out if grad_apply_fn is None else grad_apply_fn(x)
        nn_grad = torch.autograd.grad(grad_out.sum(), x, create_graph=create_graph)[0]
    return out[..., 0], nn_grad[..., :3]


def loss_sdf(apply_fn, inputs, target_grad, target_outputs, grad_apply_fn=None,
             create_graph=True):
    """Composite SDF loss (reference losses.py:68-96):
      1. sign-weighted regression (x10 on a sign mismatch);
      2. the gradient's MSE against the ground-truth direction;
      3. the gradient's angle to it [deg] over the unsaturated points;
      4. eikonal: |grad| toward |grad_gt|.

    The values and the input gradient as ``value_and_input_grad`` takes
    them.  Returns (regression, grad_mse, grad_dir_deg, eikonal)."""
    outputs, nn_grad = value_and_input_grad(apply_fn, inputs, grad_apply_fn, create_graph)

    mse = (outputs - target_outputs) ** 2
    different_sign = torch.sign(target_outputs) != torch.sign(outputs)
    loss_regression = torch.where(different_sign, mse * 10.0, mse).mean()

    loss_gradient_mse = ((nn_grad - target_grad) ** 2).mean()

    norm_nn = torch.linalg.vector_norm(nn_grad, dim=-1)
    norm_gt = torch.linalg.vector_norm(target_grad, dim=-1)
    mask_unsat = norm_gt > 0
    cosang = (nn_grad * target_grad).sum(-1) / (norm_nn + 1e-6)
    ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    n_unsat = torch.clamp(mask_unsat.sum(), min=1)
    loss_gradient_dir = torch.rad2deg(
        torch.where(mask_unsat, ang, torch.zeros_like(ang)).sum() / n_unsat)

    loss_eikonal = ((norm_nn - norm_gt) ** 2).mean()
    return loss_regression, loss_gradient_mse, loss_gradient_dir, loss_eikonal
