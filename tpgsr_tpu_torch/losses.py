"""Training losses of the text-prior cascade (counterpart of tpgsr_tpu/losses.py:26-61).

NHWC images and [T, B, C] probability sequences, as the JAX package:

* ``image_loss``: w0 MSE + w1 gradient prior over RGB, weights (1, 1e-4)
  (reference loss/image_loss.py:10-30; the trainer scales it by 100);
* ``gradient_prior_loss``: L1 between the central-difference gradient maps
  (loss/image_loss.py:33-51);
* ``semantic_loss``: the text-prior distillation, mean |gt - pred| plus torch
  ``KLDivLoss``'s elementwise mean of gt (log gt - log pred), eps 1e-20 on
  both (loss/semantic_loss.py:10-43);
* ``ssim_loss``: (1 - SSIM) x 10 (``--ssim_loss``, super_resolution.py:388-391);
* ``charbonnier_loss``: LapSRN's L1_Charbonnier, the SUM of sqrt(d^2 + 1e-6)
  over every element, not a mean (model/lapsrn.py:126-137).
"""

from __future__ import annotations

import torch

from tpgsr_tpu_torch.ops.image import gradient_map, ssim


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def gradient_prior_loss(out_images: torch.Tensor, target_images: torch.Tensor) -> torch.Tensor:
    return l1_loss(gradient_map(out_images), gradient_map(target_images))


def image_loss(out_images: torch.Tensor, target_images: torch.Tensor, gradient: bool = True) -> torch.Tensor:
    loss = mse_loss(out_images, target_images)
    if gradient:
        loss = loss + 1e-4 * gradient_prior_loss(out_images[..., :3], target_images[..., :3])
    return loss


def semantic_loss(pred_vec: torch.Tensor, gt_vec: torch.Tensor) -> torch.Tensor:
    eps = 1e-20
    target = gt_vec + eps
    kl = target * (torch.log(target) - torch.log(pred_vec + eps))
    return torch.mean(torch.abs(gt_vec - pred_vec)) + torch.mean(kl)


def ssim_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    return (1.0 - ssim(sr, hr)) * 10.0


def charbonnier_loss(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    diff = a - b
    return torch.sum(torch.sqrt(diff * diff + eps))
