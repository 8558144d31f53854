"""Flax variables of the JAX package -> the port's ``state_dict``s.

Input: ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays (``jax.device_get`` of the flax variables).  The rules invert
tpgsr_tpu/interop/torch_import.py:48-101, of which this module keeps its own
copy:

    conv          HWIO (kh, kw, I, O)        -> OIHW
    conv-T        flipped HWIO of the forward conv -> [I, O, kh, kw]:
                  flip(transpose(k, (2, 3, 0, 1)), (2, 3))
    linear        (I, O)                     -> (O, I)
    GRU / LSTM    torch layout, copied verbatim
    BatchNorm     BatchNorm_0 {scale, bias} + {mean, var} -> weight, bias,
                  running_mean, running_var; num_batches_tracked = 0
    PReLU         alpha                      -> weight

``sr_state_dict(arch, variables)`` converts the SR model of each ported
arch (TSRN / TSRN_TL / TSRN_C2F and ``textzoom_net``, SEM_TSRN, SRCNN(_TL),
SRResNet(_TL), RDN(_TL), VDSR(_TL), EDSR, LapSRN, RRDBNet(_TL); ``bicubic``
has none), inverting ``import_sr_checkpoint`` (torch_import.py:620-647).  LapSRN's
deconvs take the conv-T rule: the flax kernel is the unflipped kernel of
the dilated conv.  The STN head (``stn_head``) inverts torch_import.py:163-181, running
statistics included, when the flax variables hold one (``init`` in train
mode).  ``aster_state_dict`` and ``moran_state_dict`` invert ``import_aster``
(torch_import.py:195) and ``import_moran`` (:235): the eval recognizers;
``seed_state_dict`` maps SEED's flax tree to the original SEED's keys.
``opt_state_dict`` inverts ``import_opt`` (:317), the ``--tpg OPT`` model.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable, contiguous copy


def _conv(sd: StateDict, p: Mapping, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv_t(sd: StateDict, p: Mapping, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _t(np.flip(np.transpose(p["kernel"], (2, 3, 0, 1)), (2, 3)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _linear(sd: StateDict, p: Mapping, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(p["kernel"], (1, 0)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd: StateDict, p: Mapping, s: Mapping, prefix: str) -> None:
    p, s = p["BatchNorm_0"], s["BatchNorm_0"]
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _rnn(sd: StateDict, p: Mapping, prefix: str) -> None:
    for ours, value in p.items():  # w_ih_l0[_reverse] -> weight_ih_l0[_reverse]
        name = ours.replace("w_", "weight_", 1) if ours.startswith("w_") else ours.replace("b_", "bias_", 1)
        sd[f"{prefix}.{name}"] = _t(value)


def _infogen(sd: StateDict, p: Mapping, s: Mapping) -> None:
    for k in (1, 2, 3, 4):
        _conv_t(sd, p["infoGen"][f"tconv{k}"], f"infoGen.tconv{k}")
        _bn(sd, p["infoGen"][f"bn{k}"], s["infoGen"][f"bn{k}"], f"infoGen.bn{k}")


def _prelu(sd: StateDict, p: Mapping, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _t(p["alpha"])


def _stn(sd: StateDict, p: Mapping, s: Mapping) -> None:
    if "stn_head" in p:
        _stn_head(sd, p["stn_head"], s["stn_head"], "stn_head")


def tsrn_state_dict(variables: Mapping[str, Any], srb_nums: int = 5) -> StateDict:
    """Flax ``TSRN``, ``TSRN_TL`` or ``TSRN_C2F`` variables ->
    ``models.tsrn.TSRN``, ``TSRN_TL`` or ``TSRN_C2F`` state_dict
    (torch_import.py:118-160); the prior's pyramid and ``coarse_proj`` when
    the variables hold them."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    _conv(sd, p["block1_conv"], "block1.0")
    _prelu(sd, p["block1_prelu"], "block1.1")
    for i in range(2, srb_nums + 2):
        bp, bs = p[f"block{i}"], s[f"block{i}"]
        _conv(sd, bp["conv1"], f"block{i}.conv1")
        _bn(sd, bp["bn1"], bs["bn1"], f"block{i}.bn1")
        _conv(sd, bp["conv2"], f"block{i}.conv2")
        _bn(sd, bp["bn2"], bs["bn2"], f"block{i}.bn2")
        for g in ("gru1", "gru2"):
            _conv(sd, bp[g]["conv1"], f"block{i}.{g}.conv1")
            _rnn(sd, bp[g]["gru"], f"block{i}.{g}.gru")
    if "infoGen" in p:
        _infogen(sd, p, s)
    last = srb_nums + 2
    _conv(sd, p[f"block{last}_conv"], f"block{last}.0")
    _bn(sd, p[f"block{last}_bn"], s[f"block{last}_bn"], f"block{last}.1")
    if "coarse_proj" in p:  # TSRN_C2F (torch_import.py:147)
        _conv(sd, p["coarse_proj"], "coarse_proj")
    _head(sd, p, srb_nums)
    _stn(sd, p, s)
    return sd


tsrn_tl_state_dict = tsrn_state_dict


def _head(sd: StateDict, p: Mapping, srb_nums: int) -> None:
    """The upsample convs ``block{srb+3}_up{j}`` and the HR 9x9 conv (in
    TSRN and TSRN_TL the fused head's ConvParams, tsrn.py:222-224)."""
    out = srb_nums + 3
    j = 0
    while f"block{out}_up{j}" in p:
        _conv(sd, p[f"block{out}_up{j}"]["conv"], f"block{out}.{j}.conv")
        j += 1
    _conv(sd, p[f"block{out}_conv"], f"block{out}.{j}")


def sem_tsrn_state_dict(variables: Mapping[str, Any], srb_nums: int = 5) -> StateDict:
    """Flax ``SEM_TSRN`` -> ``models.tsrn.SEM_TSRN`` (torch_import.py:580-608,
    inverted).  Each block's ``feature_enhancer.w2v_proj``, which the
    original declares and bypasses and the JAX package lacks, is written as
    zeros so that the state_dict loads strictly."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    _conv(sd, p["block1_conv"], "block1.0")
    _prelu(sd, p["block1_prelu"], "block1.1")
    for i in range(2, srb_nums + 2):
        bp, bs = p[f"block{i}"], s[f"block{i}"]
        for n in (1, 2):
            _conv(sd, bp[f"conv{n}"], f"block{i}.conv{n}")
            _bn(sd, bp[f"bn{n}"], bs[f"bn{n}"], f"block{i}.bn{n}")
        fp, prefix = bp["feature_enhancer"], f"block{i}.feature_enhancer"
        for j, lin in enumerate(("linear_q", "linear_k", "linear_v", "linear_out")):
            _linear(sd, fp["mask_multihead"][lin], f"{prefix}.mask_multihead.linears.{j}")
        for ln in ("mul_layernorm1", "mul_layernorm3"):
            sd[f"{prefix}.{ln}.a_2"] = _t(fp[ln]["a_2"])
            sd[f"{prefix}.{ln}.b_2"] = _t(fp[ln]["b_2"])
        for lin in ("w_1", "w_2"):
            _linear(sd, fp["pff"][lin], f"{prefix}.pff.{lin}")
        c = fp["pff"]["w_2"]["kernel"].shape[1]
        sd[f"{prefix}.w2v_proj.weight"] = torch.zeros(c, 300)
        sd[f"{prefix}.w2v_proj.bias"] = torch.zeros(c)
    _linear(sd, p["w2v_proj"]["vec_proj"], "w2v_proj.vec_proj")
    last = srb_nums + 2
    _conv(sd, p[f"block{last}_conv"], f"block{last}.0")
    _bn(sd, p[f"block{last}_bn"], s[f"block{last}_bn"], f"block{last}.1")
    _head(sd, p, srb_nums)
    _stn(sd, p, s)
    return sd


def srcnn_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax ``SRCNN`` / ``SRCNN_TL`` -> ``models.srcnn`` (torch_import.py:407-418)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    for i in (1, 2, 3):
        _conv(sd, p[f"conv{i}"], f"conv{i}")
    if "infoGen" in p:
        _infogen(sd, p, s)
    _stn(sd, p, s)
    return sd


def srresnet_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax ``SRResNet`` / ``SRResNet_TL`` -> ``models.srresnet``
    (torch_import.py:421-446)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    _conv(sd, p["block1_conv"], "block1.0")
    _prelu(sd, p["block1_prelu"], "block1.1")
    for i in range(2, 7):
        bp, bs = p[f"block{i}"], s[f"block{i}"]
        _conv(sd, bp["conv1"], f"block{i}.conv1")
        _bn(sd, bp["bn1"], bs["bn1"], f"block{i}.bn1")
        _prelu(sd, bp["prelu"], f"block{i}.prelu")
        _conv(sd, bp["conv2"], f"block{i}.conv2")
        _bn(sd, bp["bn2"], bs["bn2"], f"block{i}.bn2")
    _conv(sd, p["block7_conv"], "block7.0")
    _bn(sd, p["block7_bn"], s["block7_bn"], "block7.1")
    j = 0
    while f"block8_up{j}" in p:
        _conv(sd, p[f"block8_up{j}"]["conv"], f"block8.{j}.conv")
        _prelu(sd, p[f"block8_up{j}"]["prelu"], f"block8.{j}.prelu")
        j += 1
    _conv(sd, p["block8_conv"], f"block8.{j}")
    if "infoGen" in p:
        _infogen(sd, p, s)
    _stn(sd, p, s)
    return sd


def rdn_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax ``RDN`` / ``RDN_TL`` -> ``models.rdn`` (torch_import.py:449-467)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    for name in ("conv1", "conv2"):
        _conv(sd, p[name], name)
    for k in (1, 2, 3):
        i = 0
        while f"dense{i}" in p[f"RDB{k}"]:
            _conv(sd, p[f"RDB{k}"][f"dense{i}"]["conv"], f"RDB{k}.dense_layers.{i}.conv")
            i += 1
        _conv(sd, p[f"RDB{k}"]["conv_1x1"], f"RDB{k}.conv_1x1")
    for name in ("GFF_1x1", "GFF_3x3", "conv_up", "conv3"):
        _conv(sd, p[name], name)
    if "infoGen" in p:
        _infogen(sd, p, s)
    return sd


def vdsr_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax ``VDSR`` / ``VDSR_TL`` -> ``models.vdsr`` (torch_import.py:470-489):
    the plain model's blocks under ``residual_layer.{i}``, the TL model's
    under ``block{k}``."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    tl = "infoGen" in p
    _conv(sd, p["input"], "input")
    k = 1
    while f"block{k}" in p:
        _conv(sd, p[f"block{k}"], f"block{k}.conv" if tl else f"residual_layer.{k - 1}.conv")
        k += 1
    _conv(sd, p["output"], "output")
    if tl:
        _infogen(sd, p, s)
    return sd


def edsr_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax ``EDSR`` -> ``models.edsr.EDSR`` (torch_import.py:492-509)."""
    p = variables["params"]
    sd: StateDict = {}
    _conv(sd, p["conv_input"], "conv_input")
    i = 0
    while f"res{i}" in p:
        for c in ("conv1", "conv2"):
            _conv(sd, p[f"res{i}"][c], f"residual.{i}.{c}")
        i += 1
    _conv(sd, p["conv_mid"], "conv_mid")
    j = 0
    while f"up{j}" in p:
        _conv(sd, p[f"up{j}"], f"upscale.{2 * j}")
        j += 1
    _conv(sd, p["conv_output"], "conv_output")
    return sd


def lapsrn_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax ``LapSRN`` -> ``models.lapsrn.LapSRN`` (torch_import.py:512-530)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    _conv(sd, p["conv_input"], "conv_input")
    level = 1
    while f"convt_F{level}" in p:
        fb = p[f"convt_F{level}"]
        for i in range(10):
            _conv(sd, fb[f"conv{i}"], f"convt_F{level}.0.cov_block.{2 * i}")
        _conv_t(sd, fb["deconv"], f"convt_F{level}.0.cov_block.20")
        _conv_t(sd, p[f"convt_I{level}"], f"convt_I{level}")
        _conv(sd, p[f"convt_R{level}"], f"convt_R{level}")
        level += 1
    _stn(sd, p, s)
    return sd


def rrdbnet_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax ``RRDBNet`` / ``RRDBNet_TL`` -> ``models.rrdb`` (torch_import.py:533-551
    for RRDBNet; the JAX importer reads no ``infoGen``, which this writes for
    RRDBNet_TL)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    _conv(sd, p["conv_first"], "conv_first")
    i = 0
    while f"RRDB{i}" in p:
        for k in (1, 2, 3):
            for c in range(1, 6):
                _conv(sd, p[f"RRDB{i}"][f"RDB{k}"][f"conv{c}"], f"RRDB_trunk.{i}.RDB{k}.conv{c}")
        i += 1
    _conv(sd, p["trunk_conv"], "trunk_conv")
    j = 1
    while f"upconv{j}" in p:
        _conv(sd, p[f"upconv{j}"], f"upconv{j}")
        j += 1
    _conv(sd, p["HRconv"], "HRconv")
    _conv(sd, p["conv_last"], "conv_last")
    if "infoGen" in p:
        _infogen(sd, p, s)
    return sd


def sr_state_dict(arch: str, variables: Mapping[str, Any], srb_nums: int = 5) -> StateDict:
    """The SR model of a ported ``arch``: the dispatch of
    ``import_sr_checkpoint`` (torch_import.py:620-647), inverted;
    ``textzoom_net`` is a TSRN of 6 SRBs, ``tsrn_c2f`` a TSRN with
    ``coarse_proj``, ``bicubic`` has no parameters."""
    if arch.startswith("tsrn"):
        return tsrn_state_dict(variables, srb_nums)
    if arch == "sem_tsrn":
        return sem_tsrn_state_dict(variables, srb_nums)
    if arch == "textzoom_net":
        return tsrn_state_dict(variables, 6)
    if arch == "bicubic":
        return {}
    for prefix, convert in (("srcnn", srcnn_state_dict), ("srres", srresnet_state_dict), ("rdn", rdn_state_dict),
                            ("vdsr", vdsr_state_dict), ("edsr", edsr_state_dict), ("lapsrn", lapsrn_state_dict),
                            ("esrgan", rrdbnet_state_dict)):
        if arch.startswith(prefix):
            return convert(variables)
    raise ValueError(f"no converter for arch {arch!r}")


def _stn_head(sd: StateDict, p: Mapping, s: Mapping, prefix: str) -> None:
    """Flax ``STNHead`` -> ``models.stn.STNHead`` (torch_import.py:163-181)."""
    for n, index in enumerate((0, 2, 4, 6, 8, 10)):
        block = f"{prefix}.stn_convnet.{index}"
        _conv(sd, p[f"_ConvBlock_{n}"], f"{block}.0")
        _bn(sd, p[f"_ConvBlock_{n}"], s[f"_ConvBlock_{n}"], f"{block}.1")
    _linear(sd, {"kernel": p["fc1_kernel"], "bias": p["fc1_bias"]}, f"{prefix}.stn_fc1.0")
    _bn(sd, p, s, f"{prefix}.stn_fc1.1")
    _linear(sd, {"kernel": p["fc2_kernel"], "bias": p["fc2_bias"]}, f"{prefix}.stn_fc2")


def crnn_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax ``CRNN`` variables -> ``models.crnn.CRNN`` state_dict."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    for i in range(7):
        _conv(sd, p[f"conv{i}"], f"cnn.conv{i}")
        if f"batchnorm{i}" in p:
            _bn(sd, p[f"batchnorm{i}"], s[f"batchnorm{i}"], f"cnn.batchnorm{i}")
    for j in (0, 1):
        _rnn(sd, p[f"rnn{j}"]["rnn"], f"rnn.{j}.rnn")
        _linear(sd, p[f"rnn{j}"]["embedding"], f"rnn.{j}.embedding")
    return sd


def _rnn_layer(sd: StateDict, p: Mapping, prefix: str, layer: int) -> None:
    """A flax BiLSTM's ``w_ih_l0``-style parameters as layer ``layer`` of a
    multi-layer torch LSTM (torch_import.py:184-192, inverted)."""
    for ours, value in p.items():
        name = ours.replace("w_", "weight_", 1) if ours.startswith("w_") else ours.replace("b_", "bias_", 1)
        sd[f"{prefix}.{name.replace('_l0', f'_l{layer}')}"] = _t(value)


def opt_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax ``OPTModel`` -> ``models.opt_tpg.OPTModel``, clova's keys
    (torch_import.py:289-326, inverted)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    fp, fs, base = p["FeatureExtraction"], s["FeatureExtraction"], "FeatureExtraction.ConvNet"
    sd: StateDict = {}

    def conv_bn(name: str, conv: str, bn: str) -> None:
        _conv(sd, fp[f"{name}_conv"], f"{base}.{conv}")
        _bn(sd, fp[f"{name}_bn"], fs[f"{name}_bn"], f"{base}.{bn}")

    conv_bn("conv0_1", "conv0_1", "bn0_1")
    conv_bn("conv0_2", "conv0_2", "bn0_2")
    si = 1
    while f"layer{si}_0" in fp:
        bi = 0
        while f"layer{si}_{bi}" in fp:
            bp, bs, prefix = fp[f"layer{si}_{bi}"], fs[f"layer{si}_{bi}"], f"{base}.layer{si}.{bi}"
            for n in (1, 2):
                _conv(sd, bp[f"conv{n}"], f"{prefix}.conv{n}")
                _bn(sd, bp[f"bn{n}"], bs[f"bn{n}"], f"{prefix}.bn{n}")
            if "down_conv" in bp:
                _conv(sd, bp["down_conv"], f"{prefix}.downsample.0")
                _bn(sd, bp["down_bn"], bs["down_bn"], f"{prefix}.downsample.1")
            bi += 1
        if f"conv{si}_conv" in fp:
            conv_bn(f"conv{si}", f"conv{si}", f"bn{si}")
        si += 1
    conv_bn("conv4_1", "conv4_1", "bn4_1")
    conv_bn("conv4_2", "conv4_2", "bn4_2")
    _linear(sd, p["Prediction"], "Prediction")
    return sd


def aster_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax ``RecognizerBuilder`` -> ``models.aster.RecognizerBuilder``
    (torch_import.py:195-232, inverted)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    ep, es = p["encoder"], s["encoder"]
    _conv(sd, ep["layer0_conv"], "encoder.layer0.0")
    _bn(sd, ep["layer0_bn"], es["layer0_bn"], "encoder.layer0.1")
    li = 1
    while f"layer{li}_block0" in ep:
        bi = 0
        while f"layer{li}_block{bi}" in ep:
            bp, bs, prefix = ep[f"layer{li}_block{bi}"], es[f"layer{li}_block{bi}"], f"encoder.layer{li}.{bi}"
            for n in (1, 2):
                _conv(sd, bp[f"conv{n}"], f"{prefix}.conv{n}")
                _bn(sd, bp[f"bn{n}"], bs[f"bn{n}"], f"{prefix}.bn{n}")
            if "downsample_conv" in bp:
                _conv(sd, bp["downsample_conv"], f"{prefix}.downsample.0")
                _bn(sd, bp["downsample_bn"], bs["downsample_bn"], f"{prefix}.downsample.1")
            bi += 1
        li += 1
    for layer in (0, 1):
        _rnn_layer(sd, ep[f"rnn_l{layer}"], "encoder.rnn", layer)
    dp = p["decoder"]["decoder"]
    for lin in ("sEmbed", "xEmbed", "wEmbed"):
        _linear(sd, dp["attention_unit"][lin], f"decoder.decoder.attention_unit.{lin}")
    sd["decoder.decoder.tgt_embedding.weight"] = _t(dp["tgt_embedding"]["embedding"])
    for part in ("w_ih", "w_hh", "b_ih", "b_hh"):
        name = part.replace("w_", "weight_") if part.startswith("w_") else part.replace("b_", "bias_")
        sd[f"decoder.decoder.gru.{name}_l0"] = _t(dp[f"gru_{part}"])
    _linear(sd, dp["fc"], "decoder.decoder.fc")
    _stn(sd, p, s)
    return sd


def moran_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax ``MORAN`` -> ``models.moran.MORAN`` (torch_import.py:235-286,
    inverted)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    mp, ms = p["MORN"]["cnn"], s["MORN"]["cnn"]
    for i, (ci, bi) in enumerate(((1, 2), (5, 6), (9, 10), (12, 13), (15, 16))):
        _conv(sd, mp[f"cnn{i}"], f"MORN.cnn.{ci}")
        _bn(sd, mp[f"cnn{i}_bn"], ms[f"cnn{i}_bn"], f"MORN.cnn.{bi}")
    ap, as_ = p["ASRN"], s["ASRN"]
    cp, cs = ap["cnn"], as_["cnn"]
    _conv(sd, cp["block0_conv"], "ASRN.cnn.block0.0")
    _bn(sd, cp["block0_bn"], cs["block0_bn"], "ASRN.cnn.block0.1")
    li = 1
    while f"block{li}_0" in cp:
        ri = 0
        while f"block{li}_{ri}" in cp:
            bp, bs, prefix = cp[f"block{li}_{ri}"], cs[f"block{li}_{ri}"], f"ASRN.cnn.block{li}.{ri}"
            for n in (1, 2):
                _conv(sd, bp[f"conv{n}"], f"{prefix}.conv{n}.0")
                _bn(sd, bp[f"bn{n}"], bs[f"bn{n}"], f"{prefix}.conv{n}.1")
            if "down_conv" in bp:
                _conv(sd, bp["down_conv"], f"{prefix}.downsample.0")
                _bn(sd, bp["down_bn"], bs["down_bn"], f"{prefix}.downsample.1")
            ri += 1
        li += 1
    for j in (0, 1):
        _rnn(sd, ap[f"rnn{j}"], f"ASRN.rnn.{j}.rnn")
        _linear(sd, ap[f"rnn{j}_embedding"], f"ASRN.rnn.{j}.embedding")
    for att in ("attentionL2R", "attentionR2L"):
        if att not in ap:
            continue
        tp, prefix = ap[att], f"ASRN.{att}"
        sd[f"{prefix}.char_embeddings"] = _t(tp["char_embeddings"])
        _linear(sd, tp["generator"], f"{prefix}.generator")
        for lin in ("i2h", "h2h", "score"):
            _linear(sd, tp[lin], f"{prefix}.attention_cell.{lin}")
        for part in ("w_ih", "w_hh", "b_ih", "b_hh"):
            name = part.replace("w_", "weight_") if part.startswith("w_") else part.replace("b_", "bias_")
            sd[f"{prefix}.attention_cell.rnn.{name}"] = _t(tp[f"gru_{part}"])
    return sd


def seed_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax ``SEEDModelBuilder`` (no STN) -> ``models.seed.SEEDModelBuilder``:
    ASTER's encoder and decoder keys (``aster_state_dict``), the semantic
    head ``embeder.eEmbed`` and the decoder's ``embed_fc`` (the original
    SEED's names, attention_recognition_head.py:251)."""
    p = variables["params"]
    sd = aster_state_dict(variables)
    _linear(sd, p["embeder"]["eEmbed"], "embeder.eEmbed")
    _linear(sd, p["embed_fc"], "decoder.decoder.embed_fc")
    return sd
