"""The train and eval steps of the text-prior cascade (counterpart of
tpgsr_tpu/train/step.py:113-398, ``tsrn_tl_cascade`` branch, CRNN recognizer).

Each stage runs the student CRNN on the previous stage's image (the LR at
stage 0), turns its logits into the prior, and runs TSRN_TL on the LR with
that prior.  In eval the frozen teacher CRNN then reads SR, LR, HR and each
earlier stage's SR for the word accuracies: what ``TextSR.test()`` and
``demo()`` serve (tpgsr_tpu/train/trainer.py:736-800).  In training the
teacher's softmax on HR is the distillation target, and the step ends with
backward, the SR clip and Adam.

Batches are NHWC numpy arrays or tensors (a loader's, pinned), float in
[0, 1] or uint8 (the compact wire, divided by 255 on the device): ``hr``
[B, 2h, 2w, 4], ``lr`` [B, h, w, 4].  With ``mask`` a uint8 batch may carry
RGB only, and the steps append the contour mask on the device
(``_ensure_mask``).  The train step also reads ``ctc_labels``,
``ctc_lengths`` and ``weighted_tics`` under ``use_label``; only the keys of
``train_wire_keys`` cross to the device.  Outputs keep the JAX layouts:
``sr`` NHWC, per-sample ``mse`` and ``ssim`` [B], logits [T, B, C].  Only
the ``tsrn_tl_cascade`` arch is ported; the factories raise for any other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from tpgsr_tpu_torch.device import DeviceLike, resolve_device
from tpgsr_tpu_torch.losses import image_loss, semantic_loss
from tpgsr_tpu_torch.ops.ctc import ctc_loss
from tpgsr_tpu_torch.ops.image import append_contour_mask_u8, ssim
from tpgsr_tpu_torch.train.priors import logits_to_prior, parse_crnn_data, prior_dropout_first_quarter
from tpgsr_tpu_torch.train.state import TrainState, clip_sr_grads


@dataclass
class EvalModels:
    """SR models (one per stage, or one with ``sr_share``), student CRNNs
    (one per stage, or one with ``tpg_share``) and the frozen teacher CRNN."""

    sr: Sequence[nn.Module]
    stu: Sequence[nn.Module]
    teacher: nn.Module

    def eval(self) -> "EvalModels":
        for m in (*self.sr, *self.stu, self.teacher):
            m.eval()
        return self


def crnn_width(cfg_width: int) -> int:
    """100 when TRAIN.width is 128, else TRAIN.width (reference interfaces/base.py:808)."""
    return 100 if cfg_width == 128 else cfg_width


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _ensure_mask(t: torch.Tensor, want: bool) -> torch.Tensor:
    """Append the contour-mask channel to a uint8 RGB batch when the model
    takes the mask (tpgsr_tpu/train/step.py:74-82): the collate's
    ``device_mask`` wire ships RGB only.  Any other batch is returned as is."""
    if want and t.dtype == torch.uint8 and t.shape[-1] == 3:
        return append_contour_mask_u8(t)
    return t


def _as_image(arr, dev: torch.device, want_mask: bool = False) -> torch.Tensor:
    """Batch image -> fp32 in [0, 1] on ``dev`` (tpgsr_tpu/train/step.py,
    ``_ensure_mask`` then ``_as_image``): a uint8 array crosses as uint8,
    takes its mask channel there if it lacks one and ``want_mask``, and is
    divided by 255 in fp32; any other is cast to fp32."""
    t = torch.as_tensor(arr)
    if t.dtype == torch.uint8:
        return _ensure_mask(t.to(dev, non_blocking=True), want_mask).to(torch.float32) / 255.0
    return t.to(dev, torch.float32, non_blocking=True)


def _check_arch(args: Mapping) -> None:
    arch = args.get("arch", "tsrn_tl_cascade")
    if arch != "tsrn_tl_cascade":
        raise NotImplementedError(f"arch {arch!r} is not ported: the steps run the tsrn_tl_cascade branch only")


def train_wire_keys(arch: str = "tsrn_tl_cascade") -> frozenset:
    """The batch keys the train step reads, the only ones it copies to the
    device (tpgsr_tpu/train/step.py:85-98): the collate's ``label_vecs`` and
    ``labels`` stay on the host."""
    _check_arch({"arch": arch})
    return frozenset({"hr", "lr", "ctc_labels", "ctc_lengths", "weighted_tics"})


EvalStep = Callable[[EvalModels, Mapping[str, np.ndarray]], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_eval_step(args: Mapping, width: int = 128, device: DeviceLike = None) -> EvalStep:
    """``eval_step(models, batch) -> (sr, outs)``.

    ``args`` reads ``arch``, ``stu_iter``, ``sr_share``, ``tpg_share`` and
    ``mask`` as the CLI names them; ``width`` is TRAIN.width (it sets the
    CRNN input width).  The batch's ``hr`` and ``lr`` go to ``device`` (the
    card unless told otherwise)."""
    _check_arch(args)
    dev = resolve_device(device)
    want_mask = bool(args.get("mask", False))
    stu_iter = int(args.get("stu_iter", 1))
    sr_share = bool(args.get("sr_share", False))
    tpg_share = bool(args.get("tpg_share", False))
    cw = crnn_width(int(width))

    def recognize(models: EvalModels, img: torch.Tensor) -> torch.Tensor:
        return models.teacher(_nchw(parse_crnn_data(img, cw)))

    @torch.no_grad()
    def eval_step(models: EvalModels, batch: Mapping[str, np.ndarray]):
        hr, lr = _as_image(batch["hr"], dev, want_mask), _as_image(batch["lr"], dev, want_mask)
        cascade = lr
        sr_list = []
        for i in range(stu_iter):
            stu = models.stu[0 if tpg_share else i]
            prior = logits_to_prior(stu(_nchw(parse_crnn_data(cascade, cw))))
            sr_model = models.sr[0 if sr_share else i]
            sr_out = _nhwc(sr_model(_nchw(lr[..., : sr_model.in_planes]), _nchw(prior)))
            cascade = sr_out
            sr_list.append(sr_out)
        sr = sr_list[-1]
        diff = (sr[..., :3] - hr[..., :3]) * 255.0
        outs = {
            "mse": torch.mean(diff * diff, dim=(1, 2, 3)),
            # SSIM reads the first 3 channels of the full tensors, as
            # cal_ssim does (reference super_resolution.py:974-975)
            "ssim": ssim(sr, hr[..., : sr.shape[-1]], size_average=False),
        }
        for name, img in (("sr", sr), ("lr", lr), ("hr", hr)):
            outs[f"logits_{name}"] = recognize(models, img)
        for i, s in enumerate(sr_list[:-1]):
            outs[f"logits_stage{i}"] = recognize(models, s)
        return sr, outs

    return eval_step


TrainStep = Callable[[TrainState, Mapping[str, np.ndarray]], Dict[str, torch.Tensor]]
_NOT_PORTED = ("ssim_loss",)


def make_train_step(args: Mapping, width: int = 128, device: DeviceLike = None) -> TrainStep:
    """``train_step(state, batch) -> metrics``, one optimizer step in fp32.

    Follows tpgsr_tpu/train/step.py:148-279 for ``tsrn_tl_cascade``: the
    teacher reads HR without grad; each stage runs its student in train mode
    on the previous stage's image, adds the mean of its CTC loss against the
    batch's labels times ``weighted_tics`` (``use_label``) and
    ``semantic_loss x 100`` against the teacher (``use_distill``), both to
    ``loss_distill``, zeroes the prior of the first B // 4 samples,
    runs its SR model in train mode on the LR and adds ``image_loss x 100``
    (with the gradient prior when ``gradient``).  Gradients flow through the
    whole cascade; then each SR model is clipped and Adam steps.  BatchNorm
    running statistics update by torch's own rule.  ``args`` reads ``arch``,
    ``stu_iter``, ``sr_share``, ``tpg_share``, ``use_label``,
    ``use_distill``, ``gradient`` and ``mask`` as the CLI names them;
    ``ssim_loss`` is not ported and raises.  Metrics are detached tensors on
    the device: ``loss_img_{i}``, ``loss_img``, ``loss_distill``,
    ``loss_total``."""
    _check_arch(args)
    wire_keys = train_wire_keys(args.get("arch", "tsrn_tl_cascade"))
    for name in _NOT_PORTED:
        if args.get(name, False):
            raise NotImplementedError(f"--{name} is not ported to the train step yet")
    dev = resolve_device(device)
    stu_iter = int(args.get("stu_iter", 1))
    sr_share = bool(args.get("sr_share", False))
    tpg_share = bool(args.get("tpg_share", False))
    use_label = bool(args.get("use_label", False))
    use_distill = bool(args.get("use_distill", False))
    gradient = bool(args.get("gradient", False))
    want_mask = bool(args.get("mask", False))
    cw = crnn_width(int(width))

    def train_step(state: TrainState, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        wire = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True) for k in wire_keys if k in batch}
        hr, lr = _as_image(wire["hr"], dev, want_mask), _as_image(wire["lr"], dev, want_mask)
        for m in (*state.sr, *state.stu):
            m.train()
        state.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            target = torch.softmax(state.teacher(_nchw(parse_crnn_data(hr, cw))), -1)

        metrics: Dict[str, torch.Tensor] = {}
        loss_img = lr.new_zeros(())
        loss_distill = lr.new_zeros(())
        cascade = lr
        for i in range(stu_iter):
            logits = state.stu[0 if tpg_share else i](_nchw(parse_crnn_data(cascade, cw)))
            if use_label:
                per = ctc_loss(logits, wire["ctc_labels"], wire["ctc_lengths"])
                loss_distill = loss_distill + torch.mean(per * wire["weighted_tics"])
            if use_distill:
                loss_distill = loss_distill + semantic_loss(torch.softmax(logits, -1), target) * 100.0
            prior = prior_dropout_first_quarter(logits_to_prior(logits))
            sr_model = state.sr[0 if sr_share else i]
            planes = sr_model.in_planes
            sr_out = _nhwc(sr_model(_nchw(lr[..., :planes]), _nchw(prior)))
            loss_each = image_loss(sr_out, hr[..., :planes], gradient=gradient) * 100.0
            loss_img = loss_img + loss_each
            metrics[f"loss_img_{i}"] = loss_each.detach()
            cascade = sr_out
        loss = loss_img + loss_distill
        loss.backward()
        clip_sr_grads(state.sr)
        state.optimizer.step()
        state.step += 1
        metrics.update(loss_img=loss_img.detach(), loss_distill=loss_distill.detach(), loss_total=loss.detach())
        return metrics

    return train_step
