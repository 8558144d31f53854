"""Shared pieces of the eval-recognizer parity tests (tests/test_torch_aster.py,
tests/test_torch_moran.py, tests/test_torch_rec_eval.py): the JAX package's
ASTER and MORAN drawn from a seed, SEED's flax variables from a port draw,
their variables as numpy trees, the same weights in the port through
``interop.from_jax``, and the decode margins.

The draws are rescaled so that the outputs depend on the image, as a
trained model's do; with the package's draws alone every image decodes to
the same ids on near-ties:

* every BatchNorm's statistics and affine are drawn around their defaults;
* the convolutions of ASTER's encoder are scaled by sqrt(6), to He's
  variance (the original ResNet's kaiming init), and those of MORAN's ASRN
  by sqrt(3), to unit variance (its residual branch has no ReLU between
  its two convolutions, and He's variance grows its features to 6e5): with
  torch's default range the input's share of the features decays to 1e-4
  over their 45 layers;
* ASTER's STN fc1 and fc2 are drawn at N(0, 0.01) and N(0, 0.1), so that
  the control points move with the image;
* the decoders' GRU weights on the attention context and their output
  layers are scaled by 10, so that the context, not the previous symbol's
  embedding, picks the next symbol; ASTER's EOS logit is raised by 1.5, so
  that some beams finish at once and stay frozen while others run on."""

import jax
import numpy as np
import torch
from flax.core import unfreeze

from tpgsr_tpu.charset import AsterInfo as JaxAsterInfo
from tpgsr_tpu.interop.torch_import import import_aster
from tpgsr_tpu.models.aster import RecognizerBuilder as JaxAster
from tpgsr_tpu.models.moran import MORAN as JaxMORAN
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.aster import RecognizerBuilder
from tpgsr_tpu_torch.models.moran import MORAN


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def _randomize_batchnorm(tree, rng, stats: bool):
    """Every BatchNorm's scale/bias (params) or mean/var (batch_stats) drawn
    around its default, in place."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if k == "BatchNorm_0":
            if stats:
                v["mean"] = (0.1 * rng.standard_normal(v["mean"].shape)).astype(np.float32)
                v["var"] = rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)
            else:
                v["scale"] = rng.uniform(0.8, 1.2, v["scale"].shape).astype(np.float32)
                v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
        else:
            _randomize_batchnorm(v, rng, stats)


def _scale_convs(tree, factor: float):
    for v in tree.values():
        if isinstance(v, dict):
            if "kernel" in v and v["kernel"].ndim == 4:
                v["kernel"] = (v["kernel"] * factor).astype(np.float32)
            _scale_convs(v, factor)


def _scale_decoder(p, w_ih: str, context: slice, out: str):
    p[w_ih] = p[w_ih].copy()
    p[w_ih][:, context] *= 10.0
    p[out] = {**p[out], "kernel": p[out]["kernel"] * 10.0}


def _randomized(variables, seed: int):
    v = numpy_tree(variables)
    rng = np.random.default_rng(seed)
    _randomize_batchnorm(v["params"], rng, stats=False)
    _randomize_batchnorm(v["batch_stats"], rng, stats=True)
    return v


def jax_aster(max_len: int, seed: int = 3, voc_type: str = "all"):
    """(JAX RecognizerBuilder, its numpy variables, AsterInfo)."""
    info = JaxAsterInfo(voc_type)
    model = JaxAster(rec_num_classes=info.rec_num_classes, eos_id=info.char2id[info.EOS], max_len_labels=max_len)
    x = np.zeros((1, 32, 128, 3), np.float32)
    variables = _randomized(jax.jit(lambda key: model.init(key, x, train=False))(jax.random.PRNGKey(seed)), seed)
    p = variables["params"]
    stn, rng = p["stn_head"], np.random.default_rng(seed)
    for name, scale in (("fc1_kernel", 0.01), ("fc2_kernel", 0.1)):
        stn[name] = (scale * rng.standard_normal(stn[name].shape)).astype(np.float32)
    _scale_convs(p["encoder"], np.sqrt(6.0))
    dec = p["decoder"]["decoder"]
    _scale_decoder(dec, "gru_w_ih", slice(dec["tgt_embedding"]["embedding"].shape[1], None), "fc")
    dec["fc"]["bias"] = dec["fc"]["bias"].copy()
    dec["fc"]["bias"][info.char2id[info.EOS]] += 1.5
    return model, variables, info


def port_aster(variables, info, max_len: int) -> RecognizerBuilder:
    model = RecognizerBuilder(info.rec_num_classes, info.char2id[info.EOS], max_len_labels=max_len)
    model.load_state_dict(from_jax.aster_state_dict(variables))
    return model.eval()


def jax_moran(seed: int = 5):
    """(JAX MORAN, its numpy variables)."""
    model = JaxMORAN()
    x = np.zeros((1, 32, 100, 1), np.float32)
    variables = _randomized(jax.jit(lambda key: model.init(key, x, train=False))(jax.random.PRNGKey(seed)), seed)
    p = variables["params"]["ASRN"]
    _scale_convs(p["cnn"], np.sqrt(3.0))
    for att in ("attentionL2R", "attentionR2L"):
        _scale_decoder(p[att], "gru_w_ih", slice(0, p[att]["h2h"]["kernel"].shape[0]), "generator")
    return model, variables


def port_moran(variables) -> MORAN:
    model = MORAN()
    model.load_state_dict(from_jax.moran_state_dict(variables))
    return model.eval()


def seed_variables(port, seed: int):
    """A port SEED's draw (no STN) as the JAX ``SEEDModelBuilder``'s numpy
    variables, rescaled as ``jax_aster`` rescales ASTER's (less the STN):
    ASTER's encoder and decoder through ``import_aster``, then the semantic
    head ``embeder.eEmbed`` and the decoder's ``embed_fc``, which the JAX
    module keeps at its top level."""
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    v = numpy_tree(import_aster(sd))
    for name, key in (("embeder", "embeder.eEmbed"), ("embed_fc", "decoder.decoder.embed_fc")):
        linear = {"kernel": sd[f"{key}.weight"].T, "bias": sd[f"{key}.bias"]}
        v["params"][name] = {"eEmbed": linear} if name == "embeder" else linear
    rng = np.random.default_rng(seed)
    _randomize_batchnorm(v["params"], rng, stats=False)
    _randomize_batchnorm(v["batch_stats"], rng, stats=True)
    _scale_convs(v["params"]["encoder"], np.sqrt(6.0))
    dec = v["params"]["decoder"]["decoder"]
    _scale_decoder(dec, "gru_w_ih", slice(dec["tgt_embedding"]["embedding"].shape[1], None), "fc")
    dec["fc"]["bias"] = dec["fc"]["bias"].copy()
    dec["fc"]["bias"][port.eos_id] += 1.5
    return v


def greedy_margins(logits_blc: np.ndarray) -> np.ndarray:
    """[B]: the least gap, over the steps, between the top two logits (or
    probabilities) of a greedy decode."""
    top2 = np.sort(np.asarray(logits_blc), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]).min(axis=-1)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
