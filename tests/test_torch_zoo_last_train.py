"""The train step of the last three paths held to the JAX package's on the
CPU, one step from shared weights on the same batch: ``tsrn_c2f`` (with its
STN and its coarse target), ``sem_tsrn`` (with its ``w2v`` vectors) and the
flagship with ``--tpg OPT`` at ``--stu_iter 2`` (two OPT students feeding
one SR model, the stages recomputed in the backward), in fp32 and in bf16.

The rule is tests/test_torch_zoo_train.py's: every metric at rtol 5e-6;
per model, Adam's first and second moments at a relative L2 error of 5e-3
and the BatchNorm statistics at 1e-5, the pre-BN biases apart; every
parameter within 2.5 lr of the JAX one; the update of every tracked
parameter within 5 % of the JAX update.  The OPT flagship's losses,
moments and updates are held at ``OPT_LOSS_RTOL`` and ``OPT_MOMENT_RTOL``,
measured against fp64.  ``sem_tsrn``'s ``w2v_proj`` and its blocks'
bypassed projections reach no loss: the port leaves them without a
gradient and without Adam state where optax holds zero moments; both leave
them as they were.  bf16 follows tests/test_torch_bf16.py: E_port <= 2 E_jax + floor
against the JAX fp32 step, for every loss and the SR model's moments.
Sizes: LR 16x32 -> HR 32x64, batch 4, 2 SRBs at hidden 8; the OPT models
at 64 channels."""

import functools
import os

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.test_torch_bf16 import LOSS_FLOOR, REL_FLOOR
from tests.test_torch_zoo_train import PRE_BN_BIAS, _rel
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu.config import default_args, load_config
from tpgsr_tpu.interop.torch_import import import_opt, import_sr_checkpoint
from tpgsr_tpu.models.opt_tpg import OPTModel as JaxOPTModel
from tpgsr_tpu.models.registry import ARCHS as JAX_ARCHS
from tpgsr_tpu.train.state import create_train_state as jax_create_train_state
from tpgsr_tpu.train.step import make_train_step as jax_make_train_step
from tpgsr_tpu.train.step import train_wire_keys as jax_train_wire_keys
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.opt_tpg import OPTModel
from tpgsr_tpu_torch.models.registry import build_model
from tpgsr_tpu_torch.train import checkpoint as ckpt
from tpgsr_tpu_torch.train.state import create_train_state
from tpgsr_tpu_torch.train.step import make_train_step, train_wire_keys

B, H, W = 4, 16, 32
LR = 1e-3
SRB, HD_U = 2, 8
OPT_CHANNELS = 64
# each path: its arch and flags
PATHS = {
    "tsrn_c2f": dict(arch="tsrn_c2f", STN=True, stu_iter=1),
    "sem_tsrn": dict(arch="sem_tsrn", stu_iter=1),
    "opt": dict(arch="tsrn_tl_cascade", STN=True, use_distill=True, sr_share=True, stu_iter=2, tpg="OPT"),
}
# The OPT flagship's step runs two OPT students in train mode, whose
# BatchNorms normalize over 4 x 17 values a channel in their last layers:
# their backward cancels, and fp32's rounding there reaches the stage-2 loss
# and every gradient that flows back through a student.  Against the port's
# fp64 step on these weights (``python -m tests.torch_fp64_noise``,
# ``opt_flagship_step``, one thread as here), the port's fp32 lies 1.2e-5
# away in ``loss_img_1`` and ``loss_distill`` (JAX's 4e-7 and 1.2e-5), and
# 14 % / 16 % / 11 % away in the first moments of the SR model and the two
# students (JAX's 7.5 % / 11 % / 5.5 %), 16 % / 15 % / 12 % from JAX's.  So
# that path's losses are held at OPT_LOSS_RTOL and its moments and updates
# at OPT_MOMENT_RTOL, about three times that noise; a zeroed, negated or
# random gradient (errors 1, 2, ~1.4) still fails.
OPT_LOSS_RTOL = 4e-5
OPT_MOMENT_RTOL = 0.5
# the parameters that reach no loss in sem_tsrn
UNUSED = ("w2v_proj.", ".feature_enhancer.w2v_proj.")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _args(path):
    return default_args(**{**dict(mask=True, gradient=True, srb=SRB, hd_u=HD_U), **PATHS[path]})


def _config(dtype="fp32"):
    cfg = load_config()
    cfg.TRAIN.width, cfg.TRAIN.height, cfg.TRAIN.batch_size, cfg.TRAIN.compute_dtype = 2 * W, 2 * H, B, dtype
    return cfg


def _dicts(args):
    return ({"STN": args["STN"], "mask": True, "srb": SRB, "hd_u": HD_U},
            {"scale_factor": 2, "width": 2 * W, "height": 2 * H})


def _drawn(module, seed):
    init_torch_defaults_(module, torch.Generator().manual_seed(seed))
    return {k: t.numpy() for k, t in module.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _jax(path):
    """(SR model, student model, the JAX train state): the port's seeded
    draws read by the JAX package's importers."""
    args = _args(path)
    arch = args["arch"]
    spec = JAX_ARCHS[arch]
    sr_model = spec.build(*_dicts(args))
    lr_img = np.zeros((B, H, W, 4), np.float32)
    sr_inputs = (lr_img, np.zeros((B, 1, 26, 37), np.float32)) if spec.uses_prior else (lr_img,)
    sr_init = import_sr_checkpoint(arch, _drawn(build_model(arch, *_dicts(args))[0], 0), srb_nums=SRB)
    opt = path == "opt"
    teacher = import_opt(_drawn(OPTModel(37, OPT_CHANNELS), 1)) if opt else None
    state = jax_create_train_state(jax.random.PRNGKey(0), sr_model, sr_inputs, n_sr=1,
                                   n_stu=int(args["stu_iter"]) if opt else 0, teacher_variables=teacher,
                                   sr_init_variables=sr_init)
    return sr_model, JaxOPTModel(nclass=37, output_channel=OPT_CHANNELS), state


def _vars(params, stats):
    return jax.tree_util.tree_map(np.asarray, unfreeze({"params": params, "batch_stats": stats}))


def _to_sd(path, kind):
    if kind == "sr":
        return lambda p, s: from_jax.sr_state_dict(_args(path)["arch"], _vars(p, s), srb_nums=SRB)
    return lambda p, s: from_jax.opt_state_dict(_vars(p, s))


def _port_state(path, state):
    args = _args(path)
    sr, _ = build_model(args["arch"], *_dicts(args))
    sr.load_state_dict(_to_sd(path, "sr")(state.sr_params[0], state.sr_stats[0]))
    teacher = None
    if state.teacher_params is not None:
        teacher = OPTModel(37, OPT_CHANNELS)
        teacher.load_state_dict(_to_sd(path, "stu")(state.teacher_params, state.teacher_stats))
    return create_train_state([sr], teacher, n_stu=len(state.stu_params))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"hr": rng.random((B, 2 * H, 2 * W, 4), dtype=np.float32),
            "lr": rng.random((B, H, W, 4), dtype=np.float32),
            "coarse": rng.random((B, H, W, 4), dtype=np.float32),
            "w2v": np.zeros((B, 300), np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_step(path, dtype):
    sr_model, stu_model, state = _jax(path)
    arch = _args(path)["arch"]
    step = jax_make_train_step(arch, JAX_ARCHS[arch], sr_model, stu_model, _args(path), _config(dtype), donate=False)
    return step(state, _batch(0))


def _models(port, state):
    out = [("sr", 0, port.sr[0], state.sr_params[0], state.sr_stats[0])]
    return out + [("stu", i, m, state.stu_params[i], state.stu_stats[i]) for i, m in enumerate(port.stu)]


def _moment(port, param, key):
    """Adam's ``key`` moment of ``param``: zeros where the port keeps no
    state, as for a parameter that never had a gradient."""
    st = port.optimizer.state.get(param, {})
    return st[key] if key in st else torch.zeros_like(param)


@pytest.mark.parametrize("path", list(PATHS))
def test_train_step_matches_jax(path):
    """One fp32 step from shared weights, held as the module docstring says;
    ``tsrn_c2f``'s coarse term is in ``loss_total`` and not in ``loss_img``."""
    args = _args(path)
    assert train_wire_keys(args["arch"]) == jax_train_wire_keys(args["arch"])
    _, _, state0 = _jax(path)
    state, ref = _jax_step(path, "fp32")
    port = _port_state(path, state0)
    init = [{k: t.clone() for k, t in m.state_dict().items()} for m in (*port.sr, *port.stu)]
    got = make_train_step(args, width=2 * W, device="cpu")(port, _batch(0))
    assert sorted(got) == sorted(ref)
    opt = path == "opt"
    for name in got:
        np.testing.assert_allclose(float(got[name]), float(ref[name]), rtol=OPT_LOSS_RTOL if opt else 5e-6,
                                   err_msg=name)
    if path == "tsrn_c2f":
        assert float(got["loss_total"]) > 1.5 * float(got["loss_img"]) and float(got["loss_distill"]) == 0.0
    adam = state.opt_state[0]
    assert len(port.stu) == (2 if path == "opt" else 0)
    for j, (kind, i, m, params, stats) in enumerate(_models(port, state)):
        to_sd = _to_sd(path, kind)
        ref_sd, sd = to_sd(params, stats), m.state_dict()
        named = dict(m.named_parameters())
        tracked = [n for n in named if not PRE_BN_BIAS.search(n)]
        unused = [n for n in named if path == "sem_tsrn" and (n.startswith(UNUSED[0]) or UNUSED[1] in n)]
        assert bool(unused) == (path == "sem_tsrn" and kind == "sr")
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            ref_m = to_sd(getattr(adam, moment)[kind][i], stats)
            err = _rel([(_moment(port, named[n], key), ref_m[n]) for n in tracked])
            print(path, kind, i, moment, err)
            assert err <= (OPT_MOMENT_RTOL if opt else 5e-3), (kind, i, moment, err)
            for n in unused:
                assert named[n].grad is None and named[n] not in port.optimizer.state, n
                assert not ref_m[n].any() and torch.equal(sd[n], init[j][n]) and torch.equal(ref_sd[n], init[j][n]), n
        running = [n for n in sd if "running" in n]
        assert _rel([(sd[n], ref_sd[n]) for n in running]) <= 1e-5, (kind, i)
        for n in named:
            reach = float((sd[n] - ref_sd[n]).abs().max())
            assert reach <= 2.5 * LR, (kind, i, n, reach)
        err = _rel([(sd[n] - init[j][n], ref_sd[n] - init[j][n]) for n in tracked])
        print(path, kind, i, "update", err)
        assert err <= (OPT_MOMENT_RTOL if opt else 0.05), (kind, i, err)
    assert port.step == 1


def test_sem_tsrn_adam_state_saves_and_restores(tmp_path):
    """After a ``sem_tsrn`` step, Adam's state (none for the parameters
    without a gradient) goes through ``save_checkpoint`` and
    ``restore_checkpoint``, and a second step runs from it."""
    _, _, state0 = _jax("sem_tsrn")
    port = _port_state("sem_tsrn", state0)
    step = make_train_step(_args("sem_tsrn"), width=2 * W, device="cpu")
    step(port, _batch(0))
    info = {"arch": "sem_tsrn", "iters": 1, "epochs": 0, "batch_size": B, "voc_type": "all", "up_scale_factor": 2,
            "best_history_res": {}, "best_model_info": {}}
    ckpt.save_checkpoint(str(tmp_path), port, info, False)
    resumed = _port_state("sem_tsrn", state0)
    ckpt.restore_checkpoint(str(tmp_path), resumed)
    assert resumed.step == 1 and os.path.exists(tmp_path / "opt_state.pth")
    want, got = port.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert sorted(got) == sorted(want) and len(want) < len(list(port.sr[0].parameters()))
    for k in want:
        assert all(torch.equal(got[k][n], want[k][n]) for n in want[k]), k
    metrics = step(resumed, _batch(1))
    assert np.isfinite(float(metrics["loss_total"])) and resumed.step == 2


@pytest.mark.parametrize("path", list(PATHS))
def test_bf16_step_as_close_to_fp32_as_jax_bf16(path):
    """One bf16 step: every loss with E_port <= 2 E_jax + 1e-3 |JAX fp32|,
    and the SR model's Adam moments (the pre-BN biases apart) with E_port <=
    2 E_jax + 2e-2, as tests/test_torch_bf16.py holds the flagship's.  Only
    ``sem_tsrn``'s first moment can fail that bound: the JAX package's own
    bf16 SR gradient lies 64 % (``tsrn_c2f``) and 136 % (the OPT flagship)
    from its fp32 one on these weights, so there the losses carry the
    check."""
    _, _, state0 = _jax(path)
    (s32, m32), (s16, m16) = _jax_step(path, "fp32"), _jax_step(path, "bf16")
    port = _port_state(path, state0)
    got = make_train_step(_args(path), width=2 * W, device="cpu", compute_dtype="bf16")(port, _batch(0))
    assert sorted(got) == sorted(m32)
    for k in got:
        ref, e_jax, e_port = float(m32[k]), abs(float(m16[k]) - float(m32[k])), abs(float(got[k]) - float(m32[k]))
        print(path, k, "E_port", e_port, "E_jax", e_jax, "JAX fp32", ref)
        assert np.isfinite(float(got[k])) and e_port <= 2 * e_jax + LOSS_FLOOR * abs(ref), (k, e_port, e_jax)
    to_sd = _to_sd(path, "sr")
    named = dict(port.sr[0].named_parameters())
    tracked = [n for n in named if not PRE_BN_BIAS.search(n)]
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want, jax16 = (to_sd(getattr(s.opt_state[0], moment)["sr"][0], s32.sr_stats[0]) for s in (s32, s16))
        e_jax = _rel([(jax16[n], want[n]) for n in tracked])
        e_port = _rel([(_moment(port, named[n], key), want[n]) for n in tracked])
        print(path, moment, "E_port", e_port, "E_jax", e_jax)
        assert e_port <= 2 * e_jax + REL_FLOOR, (moment, e_port, e_jax)
        # a zeroed, negated or random gradient (errors 1, 2, ~1.4) fails sem_tsrn's first moment
        assert moment == "nu" or (2 * e_jax + REL_FLOOR < 1) == (path == "sem_tsrn"), e_jax
