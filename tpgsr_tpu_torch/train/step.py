"""The train and eval steps of the SR zoo (counterpart of
tpgsr_tpu/train/step.py:47-398: the cascade branch for the ``ABLATION_SET``
archs, the one-student branch for the ``TL_SIMPLE`` archs and the plain
branch for the archs without a prior, with the branches of ``tsrn_c2f``
and ``sem_tsrn``; the CRNN, ASTER, MORAN and SEED eval recognizers).

Cascade archs: each stage runs the student CRNN on the previous stage's
image (the LR at stage 0), turns its logits into the prior, and runs the SR
model on the LR with that prior.  ``TL_SIMPLE`` archs (``tsrn_tl``,
``tsrn_tl_wmask``, ``esrgan_tl``) run one such stage whatever
``stu_iter`` says.  Plain archs run the SR model on the LR alone.  In eval
a frozen CRNN then reads SR, LR, HR and each earlier stage's SR for the
word accuracies: the teacher of a prior arch, the explicit eval recognizer
(``EvalModels.rec``) of a plain one or of the ``--tpg OPT`` flagship, whose
OPT teacher cannot read for it, or ASTER, MORAN or SEED for any
(``EvalModels.rec_kind``, tpgsr_tpu/train/step.py:317-346).  That is
what ``TextSR.test()`` and ``demo()`` serve (tpgsr_tpu/train/trainer.py:736-800).
In training the teacher of a prior arch reads HR, and its softmax is the
distillation target; the step ends with backward, the SR clip and Adam.

Batches are NHWC numpy arrays or tensors (a loader's, pinned), float in
[0, 1] or uint8 (the compact wire, divided by 255 on the device): ``hr``
[B, 2h, 2w, C], ``lr`` [B, h, w, C].  With ``mask`` a uint8 batch may carry
RGB only, and the steps append the contour mask on the device
(``_ensure_mask``).  The SR model reads the first ``ArchSpec.in_channels``
of the LR, and its loss the same channels of the HR.  The cascade's train
step also reads ``ctc_labels``, ``ctc_lengths`` and ``weighted_tics`` under
``use_label``, ``tsrn_c2f``'s its ``coarse`` target and ``sem_tsrn``'s its
``w2v`` vectors; only the keys of ``train_wire_keys`` cross to the device.
Outputs keep the JAX layouts: ``sr`` NHWC, per-sample ``mse`` and ``ssim``
[B], logits [T, B, C].

The train step runs in TRAIN.compute_dtype, 'fp32' or 'bf16'
(tpgsr_tpu/train/step.py:142-146): in bf16 the models run under
``torch.autocast`` in bfloat16 with fp32 parameters, and the softmaxes, the
losses, the SR clip and Adam stay fp32.  The eval step is fp32 always, as in
the JAX package.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from tpgsr_tpu_torch.charset import AsterInfo
from tpgsr_tpu_torch.device import DeviceLike, resolve_device
from tpgsr_tpu_torch.losses import charbonnier_loss, image_loss, l1_loss, mse_loss, semantic_loss, ssim_loss
from tpgsr_tpu_torch.models.aster import RecognizerBuilder, decode_aster_ids
from tpgsr_tpu_torch.models.moran import MORAN, decode_moran_ids
from tpgsr_tpu_torch.models.registry import ABLATION_SET, TL_SIMPLE, check_arch
from tpgsr_tpu_torch.models.seed import SEEDModelBuilder, parse_seed_data
from tpgsr_tpu_torch.ops import tiling
from tpgsr_tpu_torch.ops.ctc import ctc_loss, decode_crnn
from tpgsr_tpu_torch.ops.image import append_contour_mask_u8, ssim
from tpgsr_tpu_torch.ops.resize import interpolate_bicubic
from tpgsr_tpu_torch.parallel import average_gradients, plain_batchnorms, rank_and_world, reduce_metrics
from tpgsr_tpu_torch.train.priors import logits_to_prior, parse_crnn_data, prior_dropout_first_quarter
from tpgsr_tpu_torch.train.state import TrainState, clip_sr_grads


# the eval recognizers (--test_model) that the port runs
REC_KINDS = ("CRNN", "ASTER", "MORAN", "SEED")


@dataclass
class EvalModels:
    """SR models (one per stage, or one with ``sr_share``), student CRNNs
    (one per stage, or one with ``tpg_share``; none for a plain arch), the
    frozen teacher CRNN (None for a plain arch) and the eval recognizer
    ``rec``, which reads SR, LR and HR in place of the teacher
    (tpgsr_tpu/train/step.py:318-346): a CRNN for a plain arch, which has no
    teacher, or for ``--tpg OPT``, whose teacher is no CRNN; or an ASTER,
    MORAN or SEED for any arch (``rec_kind``)."""

    sr: Sequence[nn.Module]
    stu: Sequence[nn.Module]
    teacher: Optional[nn.Module]
    rec: Optional[nn.Module] = None

    def eval(self) -> "EvalModels":
        for m in (*self.sr, *self.stu, self.teacher, self.rec):
            if m is not None:
                m.eval()
        return self

    @property
    def recognizer(self) -> nn.Module:
        return self.rec if self.rec is not None else self.teacher

    @property
    def rec_kind(self) -> str:
        """The kind of the recognizer that reads the images: 'ASTER',
        'MORAN' or 'SEED' for those models as ``rec``, else 'CRNN'."""
        for cls, kind in ((RecognizerBuilder, "ASTER"), (MORAN, "MORAN"), (SEEDModelBuilder, "SEED")):
            if isinstance(self.rec, cls):
                return kind
        return "CRNN"


def rec_decoder(rec_kind: str, voc_type: str = "all") -> Callable[[torch.Tensor], list]:
    """The host decoder of a recognizer's output in the eval step: CRNN
    logits by greedy CTC, ASTER's and SEED's beam ids through
    ``AsterInfo(voc_type)``, MORAN's L2R logits by argmax cut at '$'
    (tpgsr_tpu/train/trainer.py:381-436)."""
    if rec_kind in ("ASTER", "SEED"):
        info = AsterInfo(voc_type)
        return lambda ids: decode_aster_ids(ids, info)
    return {"CRNN": decode_crnn, "MORAN": decode_moran_ids}[rec_kind]


def recognizer_input(rec_kind: str, img: torch.Tensor, crnn_w: int = 100) -> torch.Tensor:
    """NHWC images in [0, 1] -> what a recognizer of ``rec_kind`` reads, NCHW
    (tpgsr_tpu/train/step.py:320-346): ASTER the RGB resized bicubic to
    32x128 and scaled to [-1, 1] (parse_aster_data); SEED the RGB resized
    bicubic to 32x100 and scaled to [-1, 1] (parse_seed_data); MORAN the
    bicubic 32x100 grayscale (parse_moran_data); a CRNN the bicubic 32 x
    ``crnn_w`` grayscale (parse_crnn_data)."""
    if rec_kind == "ASTER":
        return interpolate_bicubic(_nchw(img[..., :3]), (32, 128)) * 2.0 - 1.0
    if rec_kind == "SEED":
        return parse_seed_data(_nchw(img))
    return _nchw(parse_crnn_data(img, 100 if rec_kind == "MORAN" else crnn_w))


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


# TRAIN.compute_dtype -> the dtype the train step runs its models in
COMPUTE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a TRAIN.compute_dtype value, 'fp32' or 'bf16';
    raises ``ValueError`` for any other."""
    if str(name) not in COMPUTE_DTYPES:
        raise ValueError(f"TRAIN.compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[str(name)]


def compute_context(device_type: str, dtype: torch.dtype):
    """What the train step runs its models under: autocast in bf16, nothing
    in fp32."""
    return torch.autocast(device_type, dtype=dtype) if dtype != torch.float32 else contextlib.nullcontext()


def _as_image(arr, dev: torch.device, want_mask: bool = False, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batch image -> ``dtype`` in [0, 1] on ``dev`` (tpgsr_tpu/train/step.py,
    ``_ensure_mask`` then ``_as_image``): a uint8 array crosses as uint8,
    takes its mask channel there if it lacks one and ``want_mask``, is
    divided by 255 in fp32, then cast; any other is cast to ``dtype``."""
    t = torch.as_tensor(arr)
    if t.dtype == torch.uint8:
        return (_ensure_mask(t.to(dev, non_blocking=True), want_mask).to(torch.float32) / 255.0).to(dtype)
    return t.to(dev, dtype, non_blocking=True)


# the batch keys of the archs whose model returns (SR, an auxiliary output)
AUX_KEYS = {"tsrn_c2f": ("coarse",), "sem_tsrn": ("w2v",)}


def train_wire_keys(arch: str = "tsrn_tl_cascade") -> frozenset:
    """The batch keys the train step reads, the only ones it copies to the
    device (tpgsr_tpu/train/step.py:85-98): the collate's ``label_vecs`` and
    ``labels`` stay on the host, and a plain arch reads the images alone,
    ``tsrn_c2f`` with its ``coarse`` target and ``sem_tsrn`` with its ``w2v``.
    A ``TL_SIMPLE`` arch ships the cascade's keys, as the JAX step does."""
    check_arch(arch)
    if arch in ABLATION_SET or arch in TL_SIMPLE:
        return frozenset({"hr", "lr", "ctc_labels", "ctc_lengths", "weighted_tics"})
    return frozenset({"hr", "lr", *AUX_KEYS.get(arch, ())})



def image_crit(kind: str, gradient: bool) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """An arch's image loss (tpgsr_tpu/train/step.py:47-56): ``image`` (with
    the gradient prior under ``gradient``), ``mse``, ``l1`` or
    ``charbonnier``; ``gradient`` does nothing for the last three."""
    if kind == "image":
        return lambda sr, hr: image_loss(sr, hr, gradient=gradient)
    return {"mse": mse_loss, "l1": l1_loss, "charbonnier": charbonnier_loss}[kind]


EvalStep = Callable[[EvalModels, Mapping[str, np.ndarray]], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_eval_step(args: Mapping, width: int = 128, device: DeviceLike = None,
                   tile: int = 0) -> EvalStep:
    """``eval_step(models, batch) -> (sr, outs)``.

    ``args`` reads ``arch``, ``stu_iter``, ``sr_share``, ``tpg_share`` and
    ``mask`` as the CLI names them; ``width`` is TRAIN.width (it sets the
    CRNN input width).  A cascade arch runs ``stu_iter`` stages, a
    ``TL_SIMPLE`` arch one, a plain one its SR model on the LR, keeping the
    SR of ``tsrn_c2f``'s and ``sem_tsrn``'s pairs (tpgsr_tpu/train/step.py:354-379).  The batch's
    ``hr`` and ``lr`` go to ``device`` (the card unless told otherwise).

    The ``logits_<name>`` outputs are what the recognizer of
    ``models.rec_kind`` gives for its input (``recognizer_input``): a CRNN
    its [T, B, 37] logits, ASTER its beam-search ids [B, max_len], MORAN
    its L2R logits [B, 20, 37], SEED its beam-search ids [B, max_len].
    ``rec_decoder`` turns each into strings.

    With ``tile`` set (TRAIN.eval_tile), a batch of more than ``tile`` rows
    that ``tile`` divides runs as tiles of ``tile`` rows, their outputs
    joined (``ops.tiling.tiled_apply``; tpgsr_tpu/train/step.py:400-429):
    every output is per-sample, a CRNN's time-major logits joined along
    axis 1 and the rest along axis 0.  Under data parallelism the tile is
    a rank's: ``evaluate`` hands each rank its own rows.  ``tile`` 0, the
    default, runs every batch whole: on the H100 the flagship's batch 512
    evaluates faster flat than in tiles of 64 (PERF.md), so tiles are only
    for an eval that must bound its memory."""
    arch = args.get("arch", "tsrn_tl_cascade")
    in_ch = check_arch(arch).in_channels
    tl_arch = arch in ABLATION_SET or arch in TL_SIMPLE
    dev = resolve_device(device)
    want_mask = bool(args.get("mask", False))
    n_stage = int(args.get("stu_iter", 1)) if arch in ABLATION_SET else 1
    sr_share = bool(args.get("sr_share", False))
    tpg_share = bool(args.get("tpg_share", False))
    cw = crnn_width(int(width))

    def recognize(models: EvalModels, img: torch.Tensor) -> torch.Tensor:
        x = recognizer_input(models.rec_kind, img, cw)
        if models.rec_kind == "MORAN":
            return models.rec(x)[0]
        return models.recognizer(x)

    @torch.no_grad()
    def eval_step(models: EvalModels, batch: Mapping[str, np.ndarray]):
        hr, lr = _as_image(batch["hr"], dev, want_mask), _as_image(batch["lr"], dev, want_mask)
        lr_in = _nchw(lr[..., :in_ch])
        sr_list = []
        if tl_arch:
            cascade = lr
            for i in range(n_stage):
                stu = models.stu[0 if tpg_share else i]
                prior = logits_to_prior(stu(_nchw(parse_crnn_data(cascade, cw))))
                cascade = _nhwc(models.sr[0 if sr_share else i](lr_in, _nchw(prior)))
                sr_list.append(cascade)
        else:
            out = models.sr[0](lr_in)
            sr_list.append(_nhwc(out[0] if isinstance(out, tuple) else out))
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

    if not tile:
        return eval_step

    def tiled_eval_step(models: EvalModels, batch: Mapping[str, np.ndarray]):
        time_major = models.rec_kind == "CRNN"
        return tiling.tiled_apply(lambda tile_batch: eval_step(models, tile_batch), batch, tile,
                                  batch_dim=lambda key: 1 if time_major and key.startswith("logits_") else 0)

    return tiled_eval_step


TrainStep = Callable[[TrainState, Mapping[str, np.ndarray]], Dict[str, torch.Tensor]]


@contextlib.contextmanager
def _running_stats_kept(model: nn.Module):
    """Put back every BatchNorm running statistic of ``model`` (and
    ``num_batches_tracked``) on leaving: the recompute of a checkpointed SR
    stage runs it in train mode again, and its statistics must move once a
    call, as the JAX step threads them out of the forward alone."""
    bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.track_running_stats]
    kept = [(m.running_mean.clone(), m.running_var.clone(), m.num_batches_tracked.clone()) for m in bns]
    try:
        yield
    finally:
        with torch.no_grad():
            for m, (mean, var, count) in zip(bns, kept):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
                m.num_batches_tracked.copy_(count)


def make_train_step(args: Mapping, width: int = 128, device: DeviceLike = None,
                    compute_dtype: str = "fp32") -> TrainStep:
    """``train_step(state, batch) -> metrics``, one optimizer step with the
    models in ``compute_dtype`` ('fp32' or 'bf16', TRAIN.compute_dtype).

    Follows tpgsr_tpu/train/step.py:148-279.  A cascade arch
    (``ABLATION_SET``): the teacher reads HR without grad; each stage runs
    its student in train mode on the previous stage's image, adds the mean of
    its CTC loss against the batch's labels times ``weighted_tics``
    (``use_label``) and ``semantic_loss x 100`` against the teacher
    (``use_distill``), both to ``loss_distill``, zeroes the prior of the
    first B // 4 samples, runs its SR model in train mode on the LR and adds
    the arch's image loss x 100 (``image_crit``).  Gradients flow through the
    whole cascade.  A ``TL_SIMPLE`` arch runs one stage with student 0 and
    SR model 0 whatever ``stu_iter`` says: the distillation always, CTC
    never (not even under ``use_label``), and the prior is not dropped.
    Under ``ssim_loss`` each stage of either branch adds (1 - SSIM(SR, HR))
    x 10 to ``loss_img`` (not to ``loss_img_{i}``).  A plain arch runs its
    one SR model on the LR: the loss is its image loss x 100, and
    ``loss_distill`` is 0 whatever ``use_label``, ``use_distill`` and
    ``ssim_loss`` say; an arch without parameters (``bicubic``) reports its
    loss and changes nothing.  ``tsrn_c2f`` adds the image loss x 100 of its
    coarse output against the batch's ``coarse`` (its first ``in_planes``
    channels, fp32) to ``loss_total``, not to ``loss_img``; ``sem_tsrn``
    feeds the batch's ``w2v`` to its model, whose loss is the image loss
    alone (tpgsr_tpu/train/step.py:213-242).  ``sem_tsrn``'s ``w2v_proj``
    and its blocks' bypassed ``w2v_proj`` reach no loss: they get no
    gradient (``None``), Adam keeps no state for them and leaves them as they
    are, as optax's zero gradients leave them in the JAX package.  Then each SR model is clipped and Adam
    steps.  BatchNorm running statistics update by torch's own rule, once a
    call of a model.  ``args`` reads ``arch``, ``stu_iter``, ``sr_share``,
    ``tpg_share``, ``use_label``, ``use_distill``, ``gradient``,
    ``ssim_loss`` and ``mask`` as the CLI names them.  Metrics are detached
    tensors on the device: ``loss_img_{i}`` (the stages of a prior arch),
    ``loss_img``, ``loss_distill``, ``loss_total``.

    Data parallel (the step made in a process group of W ranks,
    ``parallel``): each rank's batch is its contiguous slice of the global
    batch, and the step computes what the JAX step computes over the
    global batch on its data mesh.  The trainable models' BatchNorm must be
    global (``parallel.replicate``; a plain one raises), the prior dropout
    zeroes the global batch's first quarter, and between the backward and
    the clip every trainable gradient becomes its mean over the ranks (the
    sum for ``lapsrn``, whose Charbonnier loss sums over the batch), so the
    clip sees the global gradient; the metrics are the global batch's
    (the ranks' mean, or sum).

    A cascade of several stages recomputes each SR stage in its backward
    (``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``,
    step.py:190-193): that changes memory, not results.  The recompute
    keeps the autocast state, and runs K1's forward again on the card; the
    BatchNorm statistics it would move a second time are put back
    (``_running_stats_kept``).

    In bf16 (tpgsr_tpu/train/step.py:148-201): the batch is divided by 255 in
    fp32 and cast to bf16; every model runs under ``torch.autocast`` in
    bf16, the teacher on the bf16 HR; logits are cast to fp32 before the
    softmaxes, CTC and the distillation; the prior is cast to bf16 for the
    SR model; the image loss compares fp32 casts of the bf16 SR output and
    of the bf16 HR.  Parameters, gradients, BatchNorm statistics, the clip
    and Adam are fp32.  In fp32 every cast is the identity."""
    arch = args.get("arch", "tsrn_tl_cascade")
    spec = check_arch(arch)
    wire_keys = train_wire_keys(arch)
    dev = resolve_device(device)
    cascade_arch = arch in ABLATION_SET
    tl_arch = cascade_arch or arch in TL_SIMPLE
    crit = image_crit(spec.crit, bool(args.get("gradient", False)))
    in_ch = spec.in_channels
    n_stage = int(args.get("stu_iter", 1)) if cascade_arch else 1
    remat = n_stage > 1
    sr_share = bool(args.get("sr_share", False))
    tpg_share = bool(args.get("tpg_share", False))
    use_label = cascade_arch and bool(args.get("use_label", False))
    use_distill = bool(args.get("use_distill", False)) or not cascade_arch
    use_ssim = bool(args.get("ssim_loss", False))
    want_mask = bool(args.get("mask", False))
    cw = crnn_width(int(width))
    dtype = torch_dtype(compute_dtype)
    rank, world = rank_and_world()
    batch_mean = spec.crit != "charbonnier"  # else the loss sums over the batch

    def run(model: nn.Module, *inputs: torch.Tensor) -> torch.Tensor:
        with compute_context(dev.type, dtype):
            return model(*inputs)

    def run_sr(model: nn.Module, *inputs: torch.Tensor) -> torch.Tensor:
        if not remat:
            return run(model, *inputs)
        return checkpoint(run, model, *inputs, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), _running_stats_kept(model)))

    def image_term(sr_out: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        return crit(sr_out.float(), hr[..., :in_ch].float()) * 100.0

    def prior_losses(state: TrainState, wire, hr, lr, metrics):
        with torch.no_grad():
            target = torch.softmax(run(state.teacher, _nchw(parse_crnn_data(hr, cw))).float(), -1)
        loss_img = lr.new_zeros((), dtype=torch.float32)
        loss_distill = lr.new_zeros((), dtype=torch.float32)
        cascade = lr
        for i in range(n_stage):
            logits = run(state.stu[0 if tpg_share else i], _nchw(parse_crnn_data(cascade, cw))).float()
            if use_label:
                per = ctc_loss(logits, wire["ctc_labels"], wire["ctc_lengths"])
                loss_distill = loss_distill + torch.mean(per * wire["weighted_tics"])
            if use_distill:
                loss_distill = loss_distill + semantic_loss(torch.softmax(logits, -1), target) * 100.0
            prior = logits_to_prior(logits)
            if cascade_arch:
                b = prior.shape[0]
                prior = prior_dropout_first_quarter(prior, rank * b, world * b)
            sr_out = _nhwc(run_sr(state.sr[0 if sr_share else i], _nchw(lr[..., :in_ch]), _nchw(prior.to(dtype))))
            loss_each = image_term(sr_out, hr)
            loss_img = loss_img + loss_each
            if use_ssim:
                loss_img = loss_img + ssim_loss(sr_out.float(), hr[..., :in_ch].float())
            metrics[f"loss_img_{i}"] = loss_each.detach()
            cascade = sr_out
        return loss_img, loss_distill

    def train_step(state: TrainState, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        plain = plain_batchnorms([*state.sr, *state.stu]) if world > 1 else []
        if plain:
            raise RuntimeError(f"a data-parallel train step needs global BatchNorm (parallel.replicate): "
                               f"{plain[:3]} normalize one rank's rows")
        wire = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True) for k in wire_keys if k in batch}
        hr, lr = _as_image(wire["hr"], dev, want_mask, dtype), _as_image(wire["lr"], dev, want_mask, dtype)
        for m in (*state.sr, *state.stu):
            m.train()
        state.optimizer.zero_grad(set_to_none=True)
        metrics: Dict[str, torch.Tensor] = {}
        loss_aux = None
        if tl_arch:
            loss_img, loss_distill = prior_losses(state, wire, hr, lr, metrics)
        else:
            lr_in = _nchw(lr[..., :in_ch])
            if arch == "tsrn_c2f":
                sr_out, coarse = run(state.sr[0], lr_in)
                target = _as_image(wire["coarse"], dev)[..., : coarse.shape[1]]
                loss_aux = crit(_nhwc(coarse).float(), target) * 100.0
            elif arch == "sem_tsrn":
                sr_out, _ = run(state.sr[0], lr_in, wire.get("w2v"))
            else:
                sr_out = run(state.sr[0], lr_in)
            loss_img = image_term(_nhwc(sr_out), hr)
            loss_distill = torch.zeros_like(loss_img)
        loss = loss_img + loss_distill
        if loss_aux is not None:
            loss = loss + loss_aux
        if spec.trainable:
            loss.backward()
        average_gradients((p for m in (*state.sr, *state.stu) for p in m.parameters()), average=batch_mean)
        clip_sr_grads(state.sr)
        state.optimizer.step()
        state.step += 1
        metrics.update(loss_img=loss_img.detach(), loss_distill=loss_distill.detach(), loss_total=loss.detach())
        return reduce_metrics(metrics, average=batch_mean)

    return train_step
