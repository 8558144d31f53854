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

The STN head (``stn_head``) inverts torch_import.py:163-181, running
statistics included, when the flax variables hold one (``init`` in train
mode).
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


def tsrn_tl_state_dict(variables: Mapping[str, Any], srb_nums: int = 5) -> StateDict:
    """Flax ``TSRN_TL`` variables -> ``models.tsrn.TSRN_TL`` state_dict."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    _conv(sd, p["block1_conv"], "block1.0")
    sd["block1.1.weight"] = _t(p["block1_prelu"]["alpha"])
    for i in range(2, srb_nums + 2):
        bp, bs = p[f"block{i}"], s[f"block{i}"]
        _conv(sd, bp["conv1"], f"block{i}.conv1")
        _bn(sd, bp["bn1"], bs["bn1"], f"block{i}.bn1")
        _conv(sd, bp["conv2"], f"block{i}.conv2")
        _bn(sd, bp["bn2"], bs["bn2"], f"block{i}.bn2")
        for g in ("gru1", "gru2"):
            _conv(sd, bp[g]["conv1"], f"block{i}.{g}.conv1")
            _rnn(sd, bp[g]["gru"], f"block{i}.{g}.gru")
    for k in (1, 2, 3, 4):
        _conv_t(sd, p["infoGen"][f"tconv{k}"], f"infoGen.tconv{k}")
        _bn(sd, p["infoGen"][f"bn{k}"], s["infoGen"][f"bn{k}"], f"infoGen.bn{k}")
    last = srb_nums + 2
    _conv(sd, p[f"block{last}_conv"], f"block{last}.0")
    _bn(sd, p[f"block{last}_bn"], s[f"block{last}_bn"], f"block{last}.1")
    out = srb_nums + 3
    j = 0
    while f"block{out}_up{j}" in p:
        _conv(sd, p[f"block{out}_up{j}"]["conv"], f"block{out}.{j}.conv")
        j += 1
    # the fused head's ConvParams hold the HR 9x9 conv (tsrn.py:222-224)
    _conv(sd, p[f"block{out}_conv"], f"block{out}.{j}")
    if "stn_head" in p:
        _stn_head(sd, p["stn_head"], s["stn_head"], "stn_head")
    return sd


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
