"""The SR zoo's train step held to the JAX package's on the CPU: one fp32 step
of each of the seven archs the repo's other train scripts run, with each
script's flags, from shared weights on the same batch; the plain archs'
loss, which no prior flag reaches; and one bf16 step of ``tsrn`` and of a
cascade arch.

The rule is tests/test_torch_train.py's for a first step: every metric at
rtol 5e-6; per model, Adam's first and second moments (the gradients
themselves after one step) at a relative L2 error of 5e-3 (2e-2 for the
students of ``srresnet_tl``'s three stages, ``CASCADE_STUDENT_RTOL``) and the
BatchNorm statistics at 1e-5, the pre-BN biases apart (their gradient is
zero in exact arithmetic); every parameter within 2.5 lr of the JAX one;
and the update of every tracked parameter within 5 % of the JAX update.
bf16 follows tests/test_torch_bf16.py: E_port <= 2 E_jax + floor against
the JAX fp32 step.  Sizes: LR 16x32 -> HR 32x64, batch 4, the TSRNs at 2
SRBs and hidden 8."""

import functools
import re

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.test_torch_bf16 import LOSS_FLOOR, REL_FLOOR
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu.charset import CTC_NUM_CLASSES
from tpgsr_tpu.config import default_args, load_config
from tpgsr_tpu.interop.torch_import import import_crnn, import_sr_checkpoint
from tpgsr_tpu.models.crnn import CRNN as JaxCRNN
from tpgsr_tpu.models.registry import ARCHS as JAX_ARCHS
from tpgsr_tpu.train.state import create_train_state as jax_create_train_state
from tpgsr_tpu.train.step import make_train_step as jax_make_train_step
from tpgsr_tpu.train.step import train_wire_keys as jax_train_wire_keys
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES as PORT_CLASSES
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.registry import ABLATION_SET, build_model
from tpgsr_tpu_torch.train.state import create_train_state
from tpgsr_tpu_torch.train.step import make_train_step, train_wire_keys

B, H, W = 4, 16, 32
LR = 1e-3
SRB, HD_U = 2, 8
# conv biases that a BatchNorm follows in train mode (block4.0: the TSRNs'
# conv-BN at 2 SRBs; block7.0: SRResNet's)
PRE_BN_BIAS = re.compile(r"(block\d+\.conv[12]|block[47]\.0|stn_convnet\.\d+\.0|stn_fc1\.0|cnn\.conv[246])\.bias$")
# Adam's moments of the students of a cascade of several stages: without
# the distillation their gradient reaches them only through the prior, the
# train-mode BatchNorm of InfoGen and the later stages, and fp32 rounds it
# coarsely in either package.  Against the port's fp64 step on these
# weights (``python -m tests.torch_fp64_noise``), the port's fp32 step lies 6.7e-3 away
# for student 0 and JAX's 4.5e-3 for student 2, while the two agree with
# fp64 to 1e-4 on the others and to 7e-6 on the SR model; so these are held
# at about three times that noise, as chip_smoke.py's phase 7 holds
# gradients, and everything else at 5e-3.
CASCADE_STUDENT_RTOL = 2e-2
# each script's flags (train_*.sh)
SCRIPTS = {
    "tsrn": dict(STN=True, use_distill=True, stu_iter=1),
    "srcnn": dict(use_distill=True, stu_iter=1),
    "srcnn_tl": dict(use_distill=True, stu_iter=1),
    "srres": dict(use_distill=True, stu_iter=1),
    "srresnet_tl": dict(stu_iter=3),
    "rdn": dict(use_distill=True, stu_iter=1),
    "rdn_tl": dict(use_distill=True, stu_iter=1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _args(arch, **over):
    return default_args(**{**dict(arch=arch, mask=True, gradient=True, sr_share=True, srb=SRB, hd_u=HD_U),
                           **SCRIPTS[arch], **over})


def _config(dtype="fp32"):
    cfg = load_config()
    cfg.TRAIN.width, cfg.TRAIN.height, cfg.TRAIN.batch_size, cfg.TRAIN.compute_dtype = 2 * W, 2 * H, B, dtype
    return cfg


def _dicts(args):
    return ({"STN": args["STN"], "mask": True, "srb": SRB, "hd_u": HD_U},
            {"scale_factor": 2, "width": 2 * W, "height": 2 * H})


def _drawn(module, seed):
    """A port module's seeded weights (``init_torch_defaults_``), as numpy."""
    init_torch_defaults_(module, torch.Generator().manual_seed(seed))
    return {k: t.numpy() for k, t in module.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _jax(arch):
    """(SR model, student model, the JAX train state) for ``arch`` with its
    script's flags: one SR model (``--sr_share``, or a plain arch), a student
    per stage and the teacher for a cascade arch.  The weights are the
    port's seeded draws, read by the JAX package's own importers: flax's
    jitted init would compile each model once more."""
    args = _args(arch)
    spec = JAX_ARCHS[arch]
    sr_model = spec.build(*_dicts(args))
    lr_img = np.zeros((B, H, W, spec.in_channels), np.float32)
    sr_inputs = (lr_img, np.zeros((B, 1, 26, CTC_NUM_CLASSES), np.float32)) if spec.uses_prior else (lr_img,)
    tl = arch in ABLATION_SET
    sr_init = import_sr_checkpoint(arch, _drawn(build_model(arch, *_dicts(args))[0], 0), srb_nums=SRB)
    teacher = import_crnn(_drawn(CRNN(nclass=PORT_CLASSES), 1)) if tl else None
    state = jax_create_train_state(jax.random.PRNGKey(0), sr_model, sr_inputs, n_sr=1,
                                   n_stu=int(args["stu_iter"]) if tl else 0,
                                   teacher_variables=teacher, sr_init_variables=sr_init)
    return sr_model, JaxCRNN(nclass=CTC_NUM_CLASSES), state


def _vars(params, stats):
    return jax.tree_util.tree_map(np.asarray, unfreeze({"params": params, "batch_stats": stats}))


def _to_sd(arch, kind):
    if kind == "sr":
        return lambda p, s: from_jax.sr_state_dict(arch, _vars(p, s), srb_nums=SRB)
    return lambda p, s: from_jax.crnn_state_dict(_vars(p, s))


def _port_state(arch, state):
    """The port's train state on the JAX state's weights."""
    args = _args(arch)
    sr, _ = build_model(arch, *_dicts(args))
    sr.load_state_dict(_to_sd(arch, "sr")(state.sr_params[0], state.sr_stats[0]))
    teacher = None
    if state.teacher_params is not None:
        teacher = CRNN(nclass=PORT_CLASSES)
        teacher.load_state_dict(_to_sd(arch, "stu")(state.teacher_params, state.teacher_stats))
    return create_train_state([sr], teacher, n_stu=len(state.stu_params))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"hr": rng.random((B, 2 * H, 2 * W, 4), dtype=np.float32),
            "lr": rng.random((B, H, W, 4), dtype=np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_step(arch, dtype):
    """The JAX package's step on ``_batch(0)`` from ``_jax(arch)``'s state:
    (new state, metrics)."""
    sr_model, stu_model, state = _jax(arch)
    step = jax_make_train_step(arch, JAX_ARCHS[arch], sr_model, stu_model, _args(arch), _config(dtype), donate=False)
    return step(state, _batch(0))


def _rel(pairs):
    num = sum(float((a - b).pow(2).sum()) for a, b in pairs)
    den = sum(float(b.pow(2).sum()) for _, b in pairs)
    return (num / max(den, 1e-30)) ** 0.5


def _models(arch, port, state):
    """(kind, index, port module, JAX params, JAX stats) of every trained model."""
    out = [("sr", 0, port.sr[0], state.sr_params[0], state.sr_stats[0])]
    out += [("stu", i, m, state.stu_params[i], state.stu_stats[i]) for i, m in enumerate(port.stu)]
    return out


@pytest.mark.parametrize("arch", list(SCRIPTS))
def test_train_step_matches_jax(arch):
    """One fp32 step of ``arch`` with its script's flags (``srresnet_tl`` at
    ``--stu_iter=3``: three students feeding one SR model) from shared
    weights, held as the module docstring says."""
    _, _, state0 = _jax(arch)
    state, ref = _jax_step(arch, "fp32")
    port = _port_state(arch, state0)
    init = [{k: t.clone() for k, t in m.state_dict().items()} for m in (*port.sr, *port.stu)]
    got = make_train_step(_args(arch), width=2 * W, device="cpu")(port, _batch(0))
    assert sorted(got) == sorted(ref)
    for name in got:
        np.testing.assert_allclose(float(got[name]), float(ref[name]), rtol=5e-6, err_msg=name)
    adam = state.opt_state[0]
    assert len(port.stu) == len(state.stu_params) == (int(_args(arch)["stu_iter"]) if arch in ABLATION_SET else 0)
    for j, (kind, i, m, params, stats) in enumerate(_models(arch, port, state)):
        to_sd = _to_sd(arch, kind)
        ref_sd, sd = to_sd(params, stats), m.state_dict()
        named = dict(m.named_parameters())
        tracked = [n for n in named if not PRE_BN_BIAS.search(n)]
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            ref_m = to_sd(getattr(adam, moment)[kind][i], stats)
            err = _rel([(port.optimizer.state[named[n]][key], ref_m[n]) for n in tracked])
            assert err <= (CASCADE_STUDENT_RTOL if kind == "stu" and len(port.stu) > 1 else 5e-3), (kind, i, moment, err)
        running = [n for n in sd if "running" in n]
        if running:
            assert _rel([(sd[n], ref_sd[n]) for n in running]) <= 1e-5, (kind, i)
        for n in named:
            reach = float((sd[n] - ref_sd[n]).abs().max())
            assert reach <= 2.5 * LR, (kind, i, n, reach)
        err = _rel([(sd[n] - init[j][n], ref_sd[n] - init[j][n]) for n in tracked])
        assert err <= 0.05, (kind, i, err)
    assert port.step == 1


@pytest.mark.parametrize("arch", [a for a in SCRIPTS if a not in ABLATION_SET])
def test_plain_arch_loss_ignores_the_prior_flags(arch):
    """A plain arch reads ``hr`` and ``lr`` alone, as JAX's step does; its
    loss is the image loss x 100 and ``loss_distill`` 0 with or without
    ``--use_distill`` and ``--use_label`` (train_TSRN.sh and train_SRCNN.sh
    pass the first); ``--gradient`` moves only ``tsrn``'s image loss, the
    others' criteria being MSE (srcnn, srres) and L1 (rdn)."""
    assert train_wire_keys(arch) == jax_train_wire_keys(arch) == {"hr", "lr"}
    _, _, state0 = _jax(arch)
    runs = {}
    for name, over in (("script", {}), ("no_prior_flags", dict(use_distill=False, use_label=False)),
                       ("use_label", dict(use_label=True)), ("no_gradient", dict(gradient=False))):
        port = _port_state(arch, state0)
        metrics = make_train_step(_args(arch, **over), width=2 * W, device="cpu")(port, _batch(0))
        runs[name] = ({k: float(v) for k, v in metrics.items()},
                      [p.grad.clone() for p in port.sr[0].parameters()])
    script, _ = runs["script"]
    assert sorted(script) == ["loss_distill", "loss_img", "loss_total"]
    assert script["loss_distill"] == 0.0 and script["loss_total"] == script["loss_img"] > 0
    for name in ("no_prior_flags", "use_label"):
        assert runs[name][0] == script
        assert all(torch.equal(a, b) for a, b in zip(runs[name][1], runs["script"][1]))
    assert (runs["no_gradient"][0] == script) == (arch != "tsrn")


# ---------------------------------------------------------------- bf16


@pytest.mark.parametrize("arch", ["tsrn", "srcnn_tl"])
def test_bf16_step_as_close_to_fp32_as_jax_bf16(arch):
    """One bf16 step of ``tsrn`` (K1's plain bf16 recurrences, the STN) and of
    ``srcnn_tl`` (a cascade arch without BatchNorm in its SR trunk): every
    loss with E_port <= 2 E_jax + 1e-3 |JAX fp32|, and the SR model's
    gradient (Adam's first moment, the pre-BN biases apart; its bound below 1)
    and second moment with E_port <= 2 E_jax + 2e-2, as
    tests/test_torch_bf16.py holds the flagship's.  (The student's bf16 gradient under the
    distillation alone is near-tie sign noise in both packages; that file
    holds it with ``--use_label``.)"""
    _, _, state0 = _jax(arch)
    (s32, m32), (s16, m16) = _jax_step(arch, "fp32"), _jax_step(arch, "bf16")
    port = _port_state(arch, state0)
    got = make_train_step(_args(arch), width=2 * W, device="cpu", compute_dtype="bf16")(port, _batch(0))
    assert sorted(got) == sorted(m32)
    for k in got:
        ref, e_jax, e_port = float(m32[k]), abs(float(m16[k]) - float(m32[k])), abs(float(got[k]) - float(m32[k]))
        assert np.isfinite(float(got[k])) and e_port <= 2 * e_jax + LOSS_FLOOR * abs(ref), (k, e_port, e_jax)
    to_sd = _to_sd(arch, "sr")
    named = dict(port.sr[0].named_parameters())
    tracked = [n for n in named if not PRE_BN_BIAS.search(n)]
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want, jax16 = (to_sd(getattr(s.opt_state[0], moment)["sr"][0], s32.sr_stats[0]) for s in (s32, s16))
        e_jax = _rel([(jax16[n], want[n]) for n in tracked])
        e_port = _rel([(port.optimizer.state[named[n]][key], want[n]) for n in tracked])
        assert e_port <= 2 * e_jax + REL_FLOOR, (moment, e_port, e_jax)
        # a zeroed, negated or random gradient (errors 1, 2, ~1.4) fails the first moment's bound
        assert moment == "nu" or 2 * e_jax + REL_FLOOR < 1, e_jax
