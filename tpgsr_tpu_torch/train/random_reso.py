"""Variable-resolution eval (``--random_reso``) with a confidence gate
(counterpart of tpgsr_tpu/train/random_reso.py; reference
interfaces/super_resolution.py:51-73 and :624-731).

Each image is read at its own size, one at a time.  The stage-0 student
reads the LR first (``cal_conf``: the mean top softmax probability over the
frames whose argmax is not the blank); an image whose confidence is above
the threshold (0.85 for the cascade archs, 0.9 for ``tsrn``) and whose LR is
taller than 16 rows keeps its LR ('LR' in the gate's counts), any other runs
the SR cascade ('SR'): each stage's student reads the previous stage's image
for the prior, and every stage's SR model reads the original LR.  The
metrics are the reference's list branches (:832-1160): the recognizer's
word accuracy on SR, LR and HR after ``str_filt(., 'lower')``, PSNR and SSIM
against the HR with an output of another size (a kept LR) resized to the
HR's bilinearly, and the gate's counts ``go_LR`` and ``go_SR``.

The JAX package compiles one SR program a shape (its ``BucketedSR``, a jit
cache keyed by (H, W)); eager PyTorch needs no such cache, and each SR
module is called directly at the image's shape.  So on the card every
image launches the SR model's kernels at a new shape: K1's forward with
T = W and N = H over W, T = H and N = W over H.  cuDNN's autotuner
(``torch.backends.cudnn.benchmark``) is left as it is, off by default: with
it on, every new shape would be timed again.

Confidences and their gate are computed in numpy on the logits read back,
with the JAX package's arithmetic, so that a gate decision rests on the
logits alone.  ``laplacian_var`` is the reference's sharpness probe
(cv2.Laplacian(gray, CV_64F).var()), computed there and read by no gate.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from tpgsr_tpu_torch.charset import str_filt
from tpgsr_tpu_torch.device import DeviceLike, resolve_device
from tpgsr_tpu_torch.models.registry import ABLATION_SET
from tpgsr_tpu_torch.ops.image import calculate_psnr, ssim
from tpgsr_tpu_torch.ops.resize import interpolate_bilinear
from tpgsr_tpu_torch.train.priors import logits_to_prior

# an LR at most this tall runs the SR whatever its confidence (reference :627-643)
MIN_HEIGHT = 16

# (lr [1, H, W, C], prior [1, 1, T, 37]) -> SR [1, 2H, 2W, C], NHWC tensors
SRApply = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# image [1, H, W, C] -> logits [T, 1, 37]
RecApply = Callable[[torch.Tensor], torch.Tensor]


def laplacian_var(img01: np.ndarray) -> float:
    """The variance of the 4-neighbour Laplacian of the BT.601 grayscale of
    ``img01`` [H, W, C] in [0, 1], at 0-255 and with edge-replicated
    borders."""
    rgb = np.asarray(img01[..., :3], np.float64) * 255.0
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    p = np.pad(gray, 1, mode="edge")
    lap = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4.0 * gray
    return float(lap.var())


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def confidence(logits_tc: np.ndarray) -> float:
    """The mean, over the frames whose argmax is not the blank, of their top
    softmax probability (0 where every frame is the blank)."""
    probs = _softmax(np.asarray(logits_tc))
    idx = probs.argmax(-1)
    picked = probs[np.arange(probs.shape[0]), idx]
    nz = idx > 0
    return float(np.sum(picked * nz) / (float(nz.sum()) + 1e-10))


def _one(img, dev: torch.device) -> torch.Tensor:
    """An image [H, W, C] or [1, H, W, C] (numpy or tensor) -> [1, H, W, C]
    float32 on ``dev``."""
    t = torch.as_tensor(img)
    t = t if t.dim() == 4 else t[None]
    return t.to(dev, torch.float32)


def cal_conf(lr_list: Sequence, crnn_apply: RecApply, device: DeviceLike = None) -> List[float]:
    """Each LR's ``confidence`` under ``crnn_apply`` (which resizes the image
    itself, ``priors.parse_crnn_data``), one image at a time on ``device``."""
    dev = resolve_device(device)
    with torch.no_grad():
        return [confidence(crnn_apply(_one(img, dev))[:, 0].float().cpu().numpy()) for img in lr_list]


def _gated(x: torch.Tensor, conf: float, stu_applies: Sequence[RecApply], sr_applies: Sequence[SRApply],
           stu_iter: int, conf_threshold: float, min_height: int, is_tl: bool = True) -> Tuple[torch.Tensor, str]:
    """(output, 'LR' or 'SR') of one image ``x`` [1, H, W, C]: the LR kept
    where the gate says so, else the SR cascade of ``stu_iter`` stages (a
    plain arch's SR model reads no prior)."""
    if conf > conf_threshold and x.shape[1] > min_height:
        return x, "LR"
    cascade = x
    for i in range(stu_iter):
        if is_tl:
            prior = logits_to_prior(stu_applies[i](cascade))
        else:
            prior = x.new_zeros((1, 1, 1, 1))
        cascade = sr_applies[i](x, prior)
    return cascade, "SR"


def eval_random_reso(lr_list: Sequence, crnn_apply: RecApply, sr_apply: SRApply, stu_iter: int = 1,
                     conf_threshold: float = 0.85, min_height: int = MIN_HEIGHT,
                     device: DeviceLike = None) -> Tuple[List[np.ndarray], List[str]]:
    """The gated cascade over variable-resolution LRs, one student and one SR
    model for every stage: (outputs [H', W', C] as numpy, each image's 'LR'
    or 'SR')."""
    dev = resolve_device(device)
    confs = cal_conf(lr_list, crnn_apply, dev)
    out, stat = [], []
    with torch.no_grad():
        for img, conf in zip(lr_list, confs):
            y, s = _gated(_one(img, dev), conf, [crnn_apply] * stu_iter, [sr_apply] * stu_iter, stu_iter,
                          conf_threshold, min_height)
            out.append(y[0].cpu().numpy())
            stat.append(s)
    return out, stat


def _images(batch: Mapping) -> Tuple[List, List]:
    """(LRs, HRs) of a batch: the lists of ``collate_syn_random_reso``, or a
    fixed-shape batch's ``lr`` and ``hr`` split into images."""
    if "lr_list" in batch:
        return list(batch["lr_list"]), list(batch["hr_list"])
    return list(batch["lr"]), list(batch["hr"])


def evaluate_random_reso_loader(val_loader, stu_applies: Sequence[RecApply], sr_applies: Sequence[SRApply],
                                rec_apply: RecApply, decoder: Callable[[torch.Tensor], List[str]],
                                stu_iter: int = 1, conf_threshold: float = 0.85, min_height: int = MIN_HEIGHT,
                                is_tl: bool = True, device: DeviceLike = None) -> Dict[str, float]:
    """The ``--random_reso`` val over ``val_loader``'s batches, each image on
    its own on ``device`` (the card unless told otherwise): the stage-0
    student's confidence on the LR gates it, ``stu_applies[i]`` and
    ``sr_applies[i]`` run stage i, ``rec_apply`` reads SR, LR and HR for the
    accuracies and ``decoder`` turns its logits into strings.  Returns
    {accuracy, accuracy_lr, accuracy_hr, psnr_avg, ssim_avg, images, go_LR,
    go_SR}, PSNR and SSIM averaged over the images."""
    dev = resolve_device(device)
    n = c_sr = c_lr = c_hr = 0
    psnrs: List[float] = []
    ssims: List[float] = []
    go = {"LR": 0, "SR": 0}
    with torch.no_grad():
        for batch in val_loader:
            lrs, hrs = _images(batch)
            confs = cal_conf(lrs, stu_applies[0], dev)
            for img_lr, img_hr, label, conf in zip(lrs, hrs, batch["labels"], confs):
                x, hr = _one(img_lr, dev), _one(img_hr, dev)
                sr, s = _gated(x, conf, stu_applies, sr_applies, stu_iter, conf_threshold, min_height, is_tl)
                go[s] += 1
                srm = sr
                if srm.shape != hr.shape:
                    srm = interpolate_bilinear(srm.permute(0, 3, 1, 2), tuple(hr.shape[1:3])).permute(0, 2, 3, 1)
                psnrs.append(float(calculate_psnr(srm, hr)))
                ssims.append(float(ssim(srm, hr)))
                gt = str_filt(label, "lower")
                p_sr, p_lr, p_hr = (str_filt(decoder(rec_apply(img))[0], "lower") for img in (sr, x, hr))
                c_sr += int(p_sr == gt)
                c_lr += int(p_lr == gt)
                c_hr += int(p_hr == gt)
                n += 1
    d = float(max(n, 1))
    return {"accuracy": c_sr / d, "accuracy_lr": c_lr / d, "accuracy_hr": c_hr / d,
            "psnr_avg": float(np.mean(psnrs)) if psnrs else 0.0, "ssim_avg": float(np.mean(ssims)) if ssims else 0.0,
            "images": n, "go_LR": go["LR"], "go_SR": go["SR"]}


def conf_threshold_of(arch: str) -> float:
    """The gate's threshold: 0.85 for the cascade archs, 0.9 for any other
    (reference :703 against :630; tpgsr_tpu/train/trainer.py:698-700)."""
    return 0.85 if arch in ABLATION_SET else 0.9
