"""Training losses of the text-prior cascade (counterpart of tpgsr_tpu/losses.py:26-61).

NHWC images and [T, B, C] probability sequences, as the JAX package:

* ``image_loss``: w0 MSE + w1 gradient prior over RGB, weights (1, 1e-4)
  (reference loss/image_loss.py:10-30; the trainer scales it by 100);
* ``gradient_prior_loss``: L1 between the central-difference gradient maps
  (loss/image_loss.py:33-51);
* ``semantic_loss``: the text-prior distillation, mean |gt - pred| plus torch
  ``KLDivLoss``'s elementwise mean of gt (log gt - log pred), eps 1e-20 on
  both (loss/semantic_loss.py:10-43).
"""

from __future__ import annotations

import torch

from tpgsr_tpu_torch.ops.image import gradient_map


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
