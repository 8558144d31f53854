"""The train steps of the rest of the zoo held to the JAX package's on the CPU:
the one-student step of the ``TL_SIMPLE`` archs (``tsrn_tl``,
``tsrn_tl_wmask``, ``esrgan_tl``), with and without ``--ssim_loss``, in
fp32 and bf16; the plain archs' steps (``vdsr``, ``edsr``, ``lapsrn`` with
its Charbonnier sum, ``esrgan``, ``textzoom_net``) and ``vdsr_tl``'s
cascade step; ``bicubic``'s step, which reports its loss and changes
nothing; ``--ssim_loss``, which a plain arch ignores; and ``cli.main`` with
no ``--arch`` (``tsrn_tl_wmask``), and ``TextSR`` for the archs a CPU trains
at full width in seconds.

The rules are tests/test_torch_zoo_train.py's for a first step: every metric
at rtol 5e-6 (a Charbonnier sum and an SSIM term at 2e-5); per model, Adam's
first and second moments at a relative L2 error of 5e-3 and the BatchNorm
statistics at 1e-5, the pre-BN biases apart; every parameter within 2.5 lr
of the JAX one; and the update of every tracked parameter within 5 % of the
JAX update (``STUDENT_UPDATE_RTOL`` for ``vdsr_tl``'s student).  bf16
follows tests/test_torch_bf16.py: E_port <= 2 E_jax + floor against the
JAX fp32 step.  Sizes: LR 16x32 -> HR 32x64 (the STN's
pools need it), batch 4, the TSRNs at 2 SRBs and hidden 8 (``textzoom_net``
at its fixed 6 and 32), EDSR at 2 residual blocks, RRDB at ``nb=2``."""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.test_torch_bf16 import LOSS_FLOOR, REL_FLOOR
from tests.test_torch_zoo_train import PRE_BN_BIAS
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu.charset import CTC_NUM_CLASSES
from tpgsr_tpu.config import default_args, load_config
from tpgsr_tpu.interop.torch_import import import_crnn, import_sr_checkpoint
from tpgsr_tpu.models import edsr as jax_edsr
from tpgsr_tpu.models import rrdb as jax_rrdb
from tpgsr_tpu.models.crnn import CRNN as JaxCRNN
from tpgsr_tpu.models.registry import ARCHS as JAX_ARCHS
from tpgsr_tpu.train.state import create_train_state as jax_create_train_state
from tpgsr_tpu.train.step import make_train_step as jax_make_train_step
from tpgsr_tpu.train.step import train_wire_keys as jax_train_wire_keys
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES as PORT_CLASSES
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models import edsr, rrdb
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.registry import ARCHS, build_model
from tpgsr_tpu_torch.train.state import create_train_state
from tpgsr_tpu_torch.train.step import EvalModels, make_eval_step, make_train_step, train_wire_keys

B, H, W = 4, 16, 32
LR = 1e-3
SRB, HD_U = 2, 8
SHALLOW = {
    "edsr": (lambda: jax_edsr.EDSR(2, n_resblocks=2), lambda: edsr.EDSR(2, n_resblocks=2)),
    "esrgan": (lambda: jax_rrdb.RRDBNet(2, nb=2), lambda: rrdb.RRDBNet(2, nb=2)),
    "esrgan_tl": (lambda: jax_rrdb.RRDBNet_TL(2, nb=2), lambda: rrdb.RRDBNet_TL(2, nb=2)),
}
# the flags of each case: the TL_SIMPLE archs at --stu_iter 2 with
# --use_label, which their step ignores (one stage, no CTC)
FLAGS = {
    "tsrn_tl_wmask": dict(STN=True, use_label=True, stu_iter=2),
    "tsrn_tl_wmask-ssim": dict(STN=True, use_label=True, stu_iter=2, ssim_loss=True),
    "tsrn_tl": dict(stu_iter=1, gradient=False),
    "esrgan_tl": dict(stu_iter=1),
    "esrgan_tl-ssim": dict(stu_iter=1, ssim_loss=True),
    "vdsr": dict(stu_iter=1),
    "vdsr_tl": dict(stu_iter=1, use_distill=True),
    "edsr": dict(stu_iter=1),
    "lapsrn": dict(STN=True, stu_iter=1),
    "esrgan": dict(stu_iter=1),
    "textzoom_net": dict(stu_iter=1),
    "bicubic": dict(stu_iter=1),
}
# the first Adam update of vdsr_tl's student, which the distillation alone
# reaches: it is lr times the sign of the gradient, near enough, and fp32
# flips the sign of its smallest entries.  Against the port's fp64 step on
# these weights (``python -m tests.torch_fp64_noise``,
# ``vdsr_tl_student_update``) the port's fp32 update lies 5.4e-2 away and
# JAX's 4.8e-2, their moments agreeing to 4e-3; so it is held at about
# three times that noise, as tests/test_torch_zoo_train.py holds its
# cascade's students' moments.
STUDENT_UPDATE_RTOL = 0.15
FP32_CASES = ["tsrn_tl_wmask", "tsrn_tl_wmask-ssim", "tsrn_tl", "esrgan_tl-ssim", "vdsr", "vdsr_tl", "edsr", "lapsrn",
              "esrgan", "textzoom_net"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arch(case):
    return case.split("-")[0]


def _args(case, **over):
    return default_args(**{**dict(arch=_arch(case), mask=True, gradient=True, sr_share=True, srb=SRB, hd_u=HD_U),
                           **FLAGS[case], **over})


def _config(dtype="fp32"):
    cfg = load_config()
    cfg.TRAIN.width, cfg.TRAIN.height, cfg.TRAIN.batch_size, cfg.TRAIN.compute_dtype = 2 * W, 2 * H, B, dtype
    return cfg


def _dicts(args):
    return ({"STN": args["STN"], "mask": True, "srb": SRB, "hd_u": HD_U},
            {"scale_factor": 2, "width": 2 * W, "height": 2 * H})


def _models(case):
    """(flax SR model, port SR model) of the case."""
    arch = _arch(case)
    if arch in SHALLOW:
        return SHALLOW[arch][0](), SHALLOW[arch][1]()
    args = _args(case)
    return JAX_ARCHS[arch].build(*_dicts(args)), build_model(arch, *_dicts(args))[0]


def _drawn(module, seed):
    init_torch_defaults_(module, torch.Generator().manual_seed(seed))
    return {k: t.numpy() for k, t in module.state_dict().items()}


def _prior_arch(arch):
    return ARCHS[arch].uses_prior


@functools.lru_cache(maxsize=None)
def _jax(case):
    """(flax SR model, the JAX train state): one SR model, one student and the
    teacher for a prior arch.  The weights are the port's seeded draws read
    by the JAX package's importers; ``esrgan_tl``'s SR model (whose
    ``infoGen`` that importer does not read) and ``bicubic`` (no
    parameters) take flax's init."""
    arch = _arch(case)
    spec = JAX_ARCHS[arch]
    sr_model, port_model = _models(case)
    lr_img = np.zeros((B, H, W, spec.in_channels), np.float32)
    sr_inputs = (lr_img, np.zeros((B, 1, 26, CTC_NUM_CLASSES), np.float32)) if spec.uses_prior else (lr_img,)
    sr_init = None
    if arch not in ("esrgan_tl", "bicubic"):
        name = "tsrn" if arch == "textzoom_net" else arch
        sr_init = import_sr_checkpoint(name, _drawn(port_model, 0), srb_nums=6 if arch == "textzoom_net" else SRB)
    teacher = import_crnn(_drawn(CRNN(nclass=PORT_CLASSES), 1)) if _prior_arch(arch) else None
    state = jax_create_train_state(jax.random.PRNGKey(0), sr_model, sr_inputs, n_sr=1,
                                   n_stu=1 if _prior_arch(arch) else 0, teacher_variables=teacher,
                                   sr_init_variables=sr_init)
    return sr_model, state


def _vars(params, stats):
    return jax.tree_util.tree_map(np.asarray, unfreeze({"params": params, "batch_stats": stats}))


def _to_sd(arch, kind):
    if kind == "sr":
        return lambda p, s: from_jax.sr_state_dict(arch, _vars(p, s), srb_nums=SRB)
    return lambda p, s: from_jax.crnn_state_dict(_vars(p, s))


def _port_state(case, state):
    """The port's train state on the JAX state's weights."""
    arch = _arch(case)
    sr = _models(case)[1]
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
def _jax_step(case, dtype):
    """The JAX package's step on ``_batch(0)`` from ``_jax(case)``'s state:
    (new state, metrics)."""
    sr_model, state = _jax(case)
    arch = _arch(case)
    step = jax_make_train_step(arch, JAX_ARCHS[arch], sr_model, JaxCRNN(nclass=CTC_NUM_CLASSES), _args(case),
                               _config(dtype), donate=False)
    return step(state, _batch(0))


def _rel(pairs):
    num = sum(float((a - b).pow(2).sum()) for a, b in pairs)
    den = sum(float(b.pow(2).sum()) for _, b in pairs)
    return (num / max(den, 1e-30)) ** 0.5


def _trained(port, state):
    """(kind, index, port module, JAX params, JAX stats) of every trained model."""
    out = [("sr", 0, port.sr[0], state.sr_params[0], state.sr_stats[0])]
    return out + [("stu", i, m, state.stu_params[i], state.stu_stats[i]) for i, m in enumerate(port.stu)]


def _metric_rtol(case):
    return 2e-5 if _arch(case) == "lapsrn" or case.endswith("-ssim") else 5e-6


@pytest.mark.parametrize("case", FP32_CASES)
def test_train_step_matches_jax(case):
    """One fp32 step of the case from shared weights, held as the module
    docstring says; a ``TL_SIMPLE`` arch reports one stage's ``loss_img_0``."""
    arch = _arch(case)
    _, state0 = _jax(case)
    state, ref = _jax_step(case, "fp32")
    port = _port_state(case, state0)
    init = [{k: t.clone() for k, t in m.state_dict().items()} for m in (*port.sr, *port.stu)]
    got = make_train_step(_args(case), width=2 * W, device="cpu")(port, _batch(0))
    assert sorted(got) == sorted(ref)
    assert ("loss_img_0" in got) == _prior_arch(arch) and "loss_img_1" not in got
    for name in got:
        np.testing.assert_allclose(float(got[name]), float(ref[name]), rtol=_metric_rtol(case), err_msg=name)
    adam = state.opt_state[0]
    for j, (kind, i, m, params, stats) in enumerate(_trained(port, state)):
        to_sd = _to_sd(arch, kind)
        ref_sd, sd = to_sd(params, stats), m.state_dict()
        named = dict(m.named_parameters())
        tracked = [n for n in named if not PRE_BN_BIAS.search(n)]
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            ref_m = to_sd(getattr(adam, moment)[kind][i], stats)
            err = _rel([(port.optimizer.state[named[n]][key], ref_m[n]) for n in tracked])
            assert err <= 5e-3, (kind, i, moment, err)
        running = [n for n in sd if "running" in n]
        if running:
            assert _rel([(sd[n], ref_sd[n]) for n in running]) <= 1e-5, (kind, i)
        for n in named:
            reach = float((sd[n] - ref_sd[n]).abs().max())
            assert reach <= 2.5 * LR, (kind, i, n, reach)
        err = _rel([(sd[n] - init[j][n], ref_sd[n] - init[j][n]) for n in tracked])
        assert err <= (STUDENT_UPDATE_RTOL if kind == "stu" and arch == "vdsr_tl" else 0.05), (kind, i, err)
    assert port.step == 1


def test_tl_simple_step_runs_one_stage_with_the_distillation_always():
    """``tsrn_tl_wmask`` at ``--stu_iter 2 --use_label`` without
    ``--use_distill``: the wire carries the cascade's keys, as JAX's does; the
    step's losses are those of one stage with the distillation and no CTC
    (the same with ``--use_label`` off, and the same at ``--stu_iter 1``); its
    ``--ssim_loss`` adds (1 - SSIM) x 10 to ``loss_img`` alone."""
    case = "tsrn_tl_wmask"
    assert train_wire_keys(case) == jax_train_wire_keys(case) == {"hr", "lr", "ctc_labels", "ctc_lengths",
                                                                  "weighted_tics"}
    _, state0 = _jax(case)
    runs = {}
    for name, over in (("script", {}), ("no_label", dict(use_label=False)), ("one_stage", dict(stu_iter=1)),
                       ("ssim", dict(ssim_loss=True))):
        port = _port_state(case, state0)
        runs[name] = {k: float(v) for k, v in make_train_step(_args(case, **over), width=2 * W, device="cpu")(
            port, _batch(0)).items()}
    script = runs["script"]
    assert script["loss_distill"] > 0 and runs["no_label"] == script == runs["one_stage"]
    ssim = runs["ssim"]
    assert ssim["loss_img_0"] == script["loss_img_0"] and ssim["loss_distill"] == script["loss_distill"]
    assert 0 < ssim["loss_img"] - script["loss_img"] <= 20


def test_plain_arch_ignores_the_ssim_loss():
    """``--ssim_loss`` on a plain arch (``vdsr``) builds, and its step gives
    the losses and gradients of the step without it, which equal JAX's."""
    case = "vdsr"
    _, state0 = _jax(case)
    _, ref = _jax_step(case, "fp32")
    runs = []
    for over in ({}, dict(ssim_loss=True)):
        port = _port_state(case, state0)
        metrics = make_train_step(_args(case, **over), width=2 * W, device="cpu")(port, _batch(0))
        runs.append(({k: float(v) for k, v in metrics.items()}, [p.grad.clone() for p in port.sr[0].parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    np.testing.assert_allclose(runs[1][0]["loss_total"], float(ref["loss_total"]), rtol=5e-6)


def test_bicubic_step_reports_its_loss_and_changes_nothing():
    """``bicubic`` has no parameters: the JAX step runs Adam on an empty tree;
    the port's reports the same loss (MSE x 100 over the 4 channels), and
    its state and eval output stay those of the bicubic resize."""
    case = "bicubic"
    _, state0 = _jax(case)
    _, ref = _jax_step(case, "fp32")
    port = _port_state(case, state0)
    assert list(port.sr[0].parameters()) == [] and port.optimizer.param_groups[0]["params"] == []
    got = make_train_step(_args(case), width=2 * W, device="cpu")(port, _batch(0))
    assert sorted(got) == sorted(ref) == ["loss_distill", "loss_img", "loss_total"]
    for name in got:
        np.testing.assert_allclose(float(got[name]), float(ref[name]), rtol=5e-6, err_msg=name)
    assert port.step == 1 and port.optimizer.state_dict()["state"] == {}
    models = EvalModels(sr=port.sr, stu=[], teacher=None, rec=CRNN(nclass=PORT_CLASSES)).eval()
    sr, _ = make_eval_step(_args(case), width=2 * W, device="cpu")(models, _batch(0))
    want = torch.nn.functional.interpolate(torch.from_numpy(_batch(0)["lr"]).permute(0, 3, 1, 2), scale_factor=2,
                                           mode="bicubic", align_corners=True).permute(0, 2, 3, 1)
    torch.testing.assert_close(sr, want, rtol=0, atol=0)


# ---------------------------------------------------------------- bf16


@pytest.mark.parametrize("case", ["tsrn_tl_wmask", "esrgan_tl"])
def test_bf16_step_as_close_to_fp32_as_jax_bf16(case):
    """One bf16 step of ``tsrn_tl_wmask`` (K1's plain bf16 recurrences, the
    STN, InfoGen's BatchNorm) and of ``esrgan_tl`` (RRDB under autocast): every
    loss with E_port <= 2 E_jax + 1e-3 |JAX fp32|, and the SR model's
    gradient (Adam's first moment, the pre-BN biases apart; its bound below
    1) and second moment with E_port <= 2 E_jax + 2e-2, as
    tests/test_torch_bf16.py holds the flagship's."""
    arch = _arch(case)
    _, state0 = _jax(case)
    (s32, m32), (s16, m16) = _jax_step(case, "fp32"), _jax_step(case, "bf16")
    port = _port_state(case, state0)
    got = make_train_step(_args(case), width=2 * W, device="cpu", compute_dtype="bf16")(port, _batch(0))
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
        assert moment == "nu" or 2 * e_jax + REL_FLOOR < 1, e_jax


# ---------------------------------------------------------------- the trainer and the CLI


@pytest.fixture(scope="module")
def textzoom(tmp_path_factory):
    """The 16-pair LMDB of ``tests.fixtures``, and a YAML (the packaged one at
    this file's size: HR 32x64, batch 8, one epoch of 2 iterations, a val and
    a save at 2, one loader process) in ``dtype``."""
    from tests.fixtures import make_textzoom_lmdb
    from tpgsr_tpu_torch import config

    root = tmp_path_factory.mktemp("tl_simple")
    db = make_textzoom_lmdb(str(root / "db"), 16)

    def yaml_path(dtype):
        cfg = config.load_config()
        t = cfg.TRAIN
        t.train_data_dir, t.VAL.val_data_dir, cfg.TEST.test_data_dir = [db], [db], db
        t.width, t.height, t.batch_size, t.epochs, t.compute_dtype, t.workers = 2 * W, 2 * H, 8, 1, dtype, 0
        t.VAL.valInterval, t.saveInterval, t.displayInterval = 2, 2, 1
        t.VAL.crnn_pretrained, t.ckpt_dir = "", str(root / "ckpt")
        path = root / f"{dtype}.yaml"
        path.write_text(json.dumps(cfg))  # JSON is YAML
        return str(path)

    return root, yaml_path


def _recorded_losses(monkeypatch):
    from tpgsr_tpu_torch.train import trainer

    losses, make = [], trainer.make_train_step

    def recorded_make(*a, **k):
        step = make(*a, **k)

        def recorded(state, batch):
            metrics = step(state, batch)
            losses.append({n: float(v) for n, v in metrics.items()})
            return metrics

        return recorded

    monkeypatch.setattr(trainer, "make_train_step", recorded_make)
    return losses


def test_cli_without_arch_trains_tsrn_tl_wmask(textzoom, monkeypatch):
    """``cli.main`` with no ``--arch`` (so ``tsrn_tl_wmask``) on the packaged
    YAML (bf16): one student and one SR model, 2 iterations with a val and a
    save, finite losses of one stage; ``--test --rec crnn`` from its
    checkpoint; then the flagship's flags with ``--ssim_loss``."""
    from tpgsr_tpu_torch import cli, config

    root, yaml_path = textzoom
    monkeypatch.chdir(root)
    losses = _recorded_losses(monkeypatch)
    argv = ["--srb", "2", "--hd_u", "8", "--config", yaml_path("bf16")]
    assert config.build_arg_parser().parse_args(argv).arch == "tsrn_tl_wmask"
    state = cli.main(argv, device="cpu")
    assert state.step == 2 and len(state.sr) == 1 and len(state.stu) == 1 and len(losses) == 2
    assert all(sorted(m) == ["loss_distill", "loss_img", "loss_img_0", "loss_total"] for m in losses)
    assert all(np.isfinite(v) for m in losses for v in m.values())
    ckpt_dir = root / "ckpt" / "tsrn_tl_wmask"
    assert {"checkpoint_0.pth", "recognizer_0.pth", "opt_state.pth", "info.json"} <= set(os.listdir(ckpt_dir))
    md = cli.main(argv + ["--test", "--rec", "crnn", "--resume", str(ckpt_dir)], device="cpu")
    assert md["images"] == 16 and 0 < md["psnr_avg"] < 100
    flagship = ["--arch", "tsrn_tl_wmask", "--STN", "--mask", "--gradient", "--ssim_loss", "--vis_dir", "ssim"]
    state = cli.main(argv + flagship, device="cpu")
    assert state.step == 2 and len(losses) == 4
    assert all(np.isfinite(v) for m in losses[2:] for v in m.values())


# the zoo's archs a CPU trains at full width in seconds (the others, EDSR and
# RRDB, through chip_smoke.py phase 15)
CHEAP = {
    "bicubic": [],
    "vdsr": [],
    "vdsr_tl": ["--use_distill"],
    "lapsrn": ["--STN"],
    "textzoom_net": ["--STN"],
    "tsrn_tl": ["--STN", "--mask"],
}


@pytest.mark.parametrize("arch", list(CHEAP))
def test_textsr_trains_and_evaluates(textzoom, monkeypatch, arch):
    """``TextSR.train()`` of the arch through ``cli.main`` (fp32): 2
    iterations with a val and a save, finite losses; then ``--go_test`` from
    the checkpoint gives the val's metric dict again.  ``bicubic``'s state
    is unchanged and its empty Adam state saves and loads."""
    from tpgsr_tpu_torch import cli, config
    from tpgsr_tpu_torch.train import trainer

    root, yaml_path = textzoom
    monkeypatch.chdir(root)
    losses = _recorded_losses(monkeypatch)
    vals, run_val = [], trainer.TextSR._run_val

    def recorded_val(mission, *a, **k):
        vals.append(run_val(mission, *a, **k))
        return vals[-1]

    monkeypatch.setattr(trainer.TextSR, "_run_val", recorded_val)
    argv = ["--arch", arch, "--srb", "2", "--hd_u", "8", "--mask", "--vis_dir", f"run_{arch}",
            "--config", yaml_path("fp32")] + CHEAP[arch]
    state = cli.main(argv, device="cpu")
    assert state.step == 2 and len(losses) == 2
    assert all(np.isfinite(v) for m in losses for v in m.values())
    assert len(state.stu) == (1 if ARCHS[arch].uses_prior else 0)
    ckpt_dir = str(root / "ckpt" / f"run_{arch}")
    go_test = cli.main(argv + ["--go_test", "--resume", ckpt_dir], device="cpu")
    assert vals[-1] == go_test
    if arch == "bicubic":
        assert losses[0]["loss_img"] > 0 and state.optimizer.state_dict()["state"] == {}
        assert torch.load(os.path.join(ckpt_dir, "checkpoint_0.pth"), weights_only=True)["state_dict_G"] == {}
        resumed = trainer.TextSR(config.load_config(yaml_path("fp32")), config.default_args(arch=arch, resume=ckpt_dir),
                                 device="cpu").init_state()
        assert resumed.step == 2 and resumed.optimizer.state_dict()["state"] == {}
