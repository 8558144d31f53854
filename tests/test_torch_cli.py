"""The port's configuration and command line held to the JAX package on the
CPU: the flag surface and its defaults, the packaged YAML, what is not
ported yet, and ``--go_test``, ``--test`` and ``--demo`` through
``tpgsr_tpu_torch.cli.main`` against the JAX ``TextSR`` on shared weights.

Sizes are tests/test_torch_train.py's (2 SRBs, hidden 8, LR 16x32 -> HR
32x64) over the 16-pair LMDB of ``tests.fixtures.make_textzoom_lmdb``, batch
8; the SR weights cross through ``interop.from_jax``, the teacher through a
``crnn.pth`` both packages load."""

import contextlib
import io
import json
import os
import shlex
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from flax.core import unfreeze

from tests.fixtures import make_textzoom_lmdb, render_word
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu import config as jax_config
from tpgsr_tpu.train.trainer import TextSR as JaxTextSR
from tpgsr_tpu_torch import cli, config
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.train import trainer

ROOT = Path(__file__).resolve().parent.parent
H, W, B = 16, 32, 8
FLAGS = ["--arch", "tsrn_tl_cascade", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
         "--stu_iter=1", "--srb", "2", "--hd_u", "8", "--batch_size", str(B)]
PSNR_SSIM_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _script_argv(name):
    """The flags of a one-line ``python3 main.py ...`` script, as the shell
    splits them."""
    line = (ROOT / name).read_text().strip()
    return shlex.split(line)[2:]


@pytest.mark.parametrize("argv", [[], _script_argv("train_TPGSR-TSRN.sh"), _script_argv("test.sh"),
                                  _script_argv("train_TSRN.sh"), ["--demo", "--rec", "crnn", "--hd_u", "12"]],
                         ids=["empty", "train_TPGSR-TSRN", "test", "train_TSRN", "demo"])
def test_flags_parse_as_in_the_jax_package(argv):
    got = vars(config.build_arg_parser().parse_args(argv))
    assert got == vars(jax_config.build_arg_parser().parse_args(argv))
    assert config.default_args() == jax_config.default_args()


def test_packaged_yaml_equals_the_jax_package_s():
    """The JAX package's keys and values, and ``eval_tile: 0``, which the JAX
    package's YAML leaves out (it tiles at 64): on the H100 the flagship's
    batch-512 eval is faster flat (``PERF.md`` §6)."""
    got, want = config.load_config(), jax_config.load_config()
    named = config.load_config("super_resolution.yaml")
    assert got.TRAIN.pop("eval_tile") == named.TRAIN.pop("eval_tile") == 0 and "eval_tile" not in want.TRAIN
    assert got == want and got.TRAIN.VAL.valInterval == 200
    assert named == want


def _fp32_config():
    cfg = config.load_config()
    cfg.TRAIN.compute_dtype = "fp32"
    return cfg


@pytest.mark.parametrize("args_over,train_over,item", [
    ({"arch": "tsrn_c2f"}, {}, None),
    ({"arch": "sem_tsrn"}, {}, None),
    ({"tpg": "OPT"}, {}, None),
    ({"test_model": "SEED"}, {}, None),
    ({"demo": True, "test_model": "ASTER"}, {}, "queue 1 item 8"),  # the JAX demo() decodes by CTC
    ({"go_test": True, "test_model": "SEED"}, {}, None),
    ({"syn": True}, {}, None),
    ({"mixed": True}, {}, None),
    ({"ic15sr": True}, {}, None),
    ({"random_reso": True}, {}, None),
    ({}, {"n_devices": 2}, None),  # data parallelism: cli.main starts the ranks, TextSR is one of them
], ids=["tsrn_c2f", "sem_tsrn", "tpg", "test_model", "demo_aster", "go_test_seed", "syn", "mixed",
        "ic15sr", "random_reso", "n_devices"])
def test_what_is_not_ported_raises_naming_its_item(args_over, train_over, item):
    """Each raises ``NotImplementedError`` naming its ``ROADMAP.md`` item when
    ``TextSR`` is built, before anything runs.  The cases ported since
    (``item`` None: the last two archs, ``--tpg OPT`` and SEED as the eval
    recognizer, for val and ``--go_test``; the data flags, whose datasets
    and collates the next test holds) build ``TextSR``, its state and steps
    instead, with the model, teacher or recognizer they name; TRAIN.n_devices
    2 (queue 1 item 10, which raised before) builds them in this process, one
    rank of the two that ``cli.main`` starts (tests/test_torch_parallel_trainer.py)."""
    from tpgsr_tpu_torch.models.opt_tpg import OPTModel
    from tpgsr_tpu_torch.models.seed import SEEDModelBuilder
    from tpgsr_tpu_torch.models.tsrn import SEM_TSRN, TSRN_C2F

    cfg = _fp32_config()
    cfg.TRAIN.update(train_over)
    args = config.default_args(**{"arch": "tsrn_tl_cascade", **args_over})
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            trainer.TextSR(cfg, args, device="cpu")
        return
    mission = trainer.TextSR(cfg, args, config.tpg_opt(), device="cpu")
    state = mission.init_state()
    mission._build_steps(with_train=not args.get("go_test"))
    want = {"tsrn_c2f": TSRN_C2F, "sem_tsrn": SEM_TSRN}.get(args["arch"])
    assert want is None or isinstance(state.sr[0], want)
    assert isinstance(state.teacher, OPTModel) == (args["tpg"] == "OPT")
    assert isinstance(mission._eval_recognizer(), SEEDModelBuilder) == (args["test_model"] == "SEED")


@pytest.mark.parametrize("flag", ["syn", "mixed", "ic15sr", "random_reso"])
def test_each_data_flag_passes_check_ported_and_picks_the_jax_dataset_and_collate(tmp_path, flag):
    """``--syn``, ``--mixed``, ``--ic15sr`` and ``--random_reso`` (queue 1 item
    9, which raised before) build ``TextSR`` with the flagship's flags, and
    its train and val loaders read the dataset class and collate that the
    JAX ``TextSR`` picks (``_dataset_cls``, ``_collate``); ``--syn
    --random_reso`` under ``--go_test`` too.  Their batches equal JAX's
    (tests/test_torch_data_modes.py)."""
    from tests.torch_modes import make_ic15_tree, make_syn_lmdb

    d = {"syn": lambda p: make_syn_lmdb(p, [(100, 32), (57, 20)]), "ic15sr": make_ic15_tree}.get(
        flag, lambda p: make_textzoom_lmdb(p, 2))(str(tmp_path / "d"))
    runs = [{flag: True}]
    if flag == "syn":
        runs.append({"syn": True, "random_reso": True, "go_test": True})
    for flags in runs:
        args = config.default_args(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, gradient=True,
                                   sr_share=True, stu_iter=1, **flags)
        trainer.check_ported(_fp32_config(), args, torch.device("cpu"))
        cfg = _fp32_config()
        cfg.TRAIN.update(train_data_dir=[d], workers=0, batch_size=2)
        cfg.TRAIN.VAL.val_data_dir = [d]
        mission = trainer.TextSR(cfg, args, device="cpu")
        jax_mission = JaxTextSR(jax_config.load_config(), jax_config.default_args(**args))
        for train, loader in ((True, mission.get_train_data()), (False, mission.get_val_data()[0])):
            want_ds = jax_mission._dataset_cls(test=not train)(d, voc_type="all", max_len=100, test=not train)
            assert type(loader.dataset).__name__ == type(want_ds).__name__, (flags, train)
            assert loader.collate_fn.args[0].func.__name__ == jax_mission._collate(train).func.__name__, (flags, train)


def test_the_flagship_runs_with_an_fp32_yaml_only():
    """The flagship's flags and ``--test --rec crnn`` build ``TextSR`` with
    the packaged YAML as it is (``compute_dtype: bf16``) and with an fp32
    one; the train step takes the YAML's precision.  (The name is from before
    bf16 was ported, when the packaged YAML raised.)"""
    argv = _script_argv("train_TPGSR-TSRN.sh")
    args = config.AttrDict(vars(config.build_arg_parser().parse_args(argv)))
    for cfg, dtype in ((config.load_config(), "bf16"), (_fp32_config(), "fp32")):
        mission = trainer.TextSR(cfg, args, device="cpu")
        assert mission.config.TRAIN.compute_dtype == dtype
        trainer.TextSR(cfg, config.default_args(arch="tsrn_tl_cascade", test=True, rec="crnn"), device="cpu")


@pytest.mark.parametrize("dtype", ["fp16", "float32", ""])
def test_an_unknown_compute_dtype_raises(dtype):
    """TRAIN.compute_dtype is 'fp32' or 'bf16'; anything else raises
    ``ValueError`` when ``TextSR`` is built (the JAX package would run it as
    fp32)."""
    cfg = config.load_config()
    cfg.TRAIN.compute_dtype = dtype
    with pytest.raises(ValueError, match="compute_dtype"):
        trainer.TextSR(cfg, config.default_args(arch="tsrn_tl_cascade"), device="cpu")


def _allow_tf32(monkeypatch):
    """TF32 on for cuBLAS and cuDNN, as a caller may leave it; the flags are
    restored after the test."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)


def test_hidden_sizes_beyond_k1_raise_on_the_card_only(monkeypatch):
    """``--hd_u 12``: the CPU takes any hidden size; the card (CUDA patched
    in) raises before it builds anything, naming K1's sizes."""
    _allow_tf32(monkeypatch)
    args = config.default_args(arch="tsrn_tl_cascade", hd_u=12)
    trainer.TextSR(_fp32_config(), args, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match=r"\(8, 16, 32\).*queue 2 item 3"):
        trainer.TextSR(_fp32_config(), args)
    for h in (8, 16, 32):
        trainer.TextSR(_fp32_config(), config.default_args(arch="tsrn_tl_cascade", hd_u=h))


def test_textsr_turns_tf32_off_on_the_card_only(monkeypatch):
    """fp32 on the card is IEEE fp32: ``TextSR`` (CUDA patched in) turns off
    the TF32 that PyTorch allows cuDNN by default, and cuBLAS's, with an fp32
    YAML and with the packaged one (bf16, whose losses, BatchNorm, K1's state,
    clip, Adam and eval are fp32); on the CPU it leaves both flags as they
    are."""
    args = config.default_args(arch="tsrn_tl_cascade")
    for cfg in (_fp32_config(), config.load_config()):
        _allow_tf32(monkeypatch)
        trainer.TextSR(cfg, args, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        with monkeypatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: True)
            trainer.TextSR(cfg, args)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32


def test_ssim_loss_raises_when_training_starts(tmp_path, monkeypatch):
    """``--ssim_loss`` is read by the train step alone, and trains through
    ``TextSR``: two iterations of the flagship with it over the 16-pair LMDB,
    each adding the (1 - SSIM) x 10 term to ``loss_img`` alone (the train
    steps' parity with it is tests/test_torch_tl_simple.py's).  (The name is
    from before ``--ssim_loss`` was ported, when it raised.)"""
    monkeypatch.chdir(tmp_path)
    db = str(tmp_path / "db")
    make_textzoom_lmdb(db, 16)
    cfg = _fp32_config()
    t = cfg.TRAIN
    t.train_data_dir, t.VAL.val_data_dir, t.workers, t.epochs = [db], [db], 0, 1
    t.width, t.height, t.VAL.valInterval, t.saveInterval, t.displayInterval = 64, 32, 100, 100, 1
    runs = {}
    for ssim_loss in (False, True):
        args = config.default_args(arch="tsrn_tl_cascade", ssim_loss=ssim_loss, srb=2, hd_u=8, batch_size=8,
                                   mask=True, use_distill=True, stu_iter=1)
        mission = trainer.TextSR(cfg, args, device="cpu")
        state = mission.init_state()
        mission._build_steps()
        losses, step = [], mission._train_step

        def recorded(s, b):
            metrics = step(s, b)
            losses.append({k: float(v) for k, v in metrics.items()})
            return metrics

        mission._train_step = recorded
        mission.train()
        runs[ssim_loss] = losses
        assert state.step == 2
    first, ssim_first = runs[False][0], runs[True][0]
    assert ssim_first["loss_img_0"] == first["loss_img_0"] and ssim_first["loss_distill"] == first["loss_distill"]
    assert 0 < ssim_first["loss_img"] - first["loss_img"] <= 20
    assert all(np.isfinite(v) for m in runs[True] for v in m.values())


# ---------------------------------------------------------------- the modes on shared weights


@contextlib.contextmanager
def _in_dir(path):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(path)
        yield


def _relabelled_lmdb(root, teacher_path):
    """The 16-pair LMDB, with pairs 1, 4 and 9 relabelled by what the teacher
    reads on their HR, so that the accuracies are not all 0."""
    from tests.test_torch_data import _write_textzoom
    from tpgsr_tpu_torch.ops.ctc import decode_crnn
    from tpgsr_tpu_torch.train.priors import parse_crnn_data
    from tpgsr_tpu_torch.train.step import _nchw

    db = make_textzoom_lmdb(str(root / "plain"), n=16)
    teacher = CRNN(nclass=CTC_NUM_CLASSES)
    teacher.load_state_dict(torch.load(teacher_path, weights_only=True))
    teacher.eval()
    (loader,) = trainer.val_loaders([db], "tsrn_tl_cascade", mask=True, batch_size=16, height=2 * H, width=2 * W,
                                    workers=0, device="cpu")
    batch = next(iter(loader))
    with torch.no_grad():
        hr = batch["hr"].float() / 255.0
        reads = decode_crnn(teacher(_nchw(parse_crnn_data(hr, 2 * W))))
    words = [reads[i] if i in (0, 3, 8) else w for i, w in enumerate(batch["labels"])]
    return _write_textzoom(root / "relabelled", words)


@pytest.fixture(scope="module")
def modes(tmp_path_factory):
    """``--go_test``, ``--test --rec crnn`` and ``--demo``, each run by the JAX
    ``TextSR`` (one instance, its eval step compiled once per batch size) and
    by ``cli.main(..., device="cpu")`` resuming from the JAX weights."""
    root = tmp_path_factory.mktemp("modes")
    teacher_path = str(root / "crnn.pth")
    torch.save(init_torch_defaults_(CRNN(nclass=CTC_NUM_CLASSES), torch.Generator().manual_seed(7)).state_dict(),
               teacher_path)
    db = _relabelled_lmdb(root, teacher_path)
    demo_dir = root / "demo_imgs"
    demo_dir.mkdir()
    for i, w in enumerate(("abc", "scene", "xyz", "text")):
        render_word(w, (80 + 8 * i, 24), seed=i).save(demo_dir / f"{i}_{w}.png")
    (demo_dir / "notes.txt").write_text("not an image")

    jax_cfg = jax_config.load_config()
    t = jax_cfg.TRAIN
    t.train_data_dir, t.VAL.val_data_dir = [db], [db]
    t.width, t.height, t.batch_size, t.compute_dtype, t.n_devices = 2 * W, 2 * H, B, "fp32", 1
    t.VAL.crnn_pretrained = teacher_path
    t.ckpt_dir = str(root / "ckpt_jax")
    jax_args = jax_config.default_args(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, gradient=True,
                                       sr_share=True, stu_iter=1, srb=2, hd_u=8, batch_size=B, vis_dir="jax",
                                       go_test=True)
    (root / "jax").mkdir()
    with _in_dir(root / "jax"):
        jax_mission = JaxTextSR(jax_cfg, jax_args)
        state = jax_mission.init_state()
        variables = jax.tree_util.tree_map(np.asarray, unfreeze({"params": state.sr_params[0],
                                                                   "batch_stats": state.sr_stats[0]}))
        ckpt_dir = root / "ckpt_from_jax"
        ckpt_dir.mkdir()
        torch.save({"state_dict_G": from_jax.tsrn_tl_state_dict(variables, srb_nums=2)},
                   ckpt_dir / "model_best_0.pth")
        jax_mds = {}
        run_val = jax_mission._run_val
        jax_mission._run_val = lambda *a, **k: jax_mds.update(run_val(*a, **k)) or jax_mds
        jax_mission.train()
        jax_cfg.TEST.test_data_dir = db
        jax_mission.args.update(go_test=False, test=True, rec="crnn")
        jax_test = jax_mission.test()
        jax_mission.args.update(test=False, demo=True, demo_dir=str(demo_dir))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jax_mission.demo()
        jax_demo = [line for line in out.getvalue().splitlines() if ": LR=" in line]

    port_cfg = config.load_config()
    t = port_cfg.TRAIN
    t.train_data_dir, t.VAL.val_data_dir = [db], [db]
    t.width, t.height, t.compute_dtype, t.workers = 2 * W, 2 * H, "fp32", 0
    t.VAL.crnn_pretrained = teacher_path
    t.ckpt_dir = str(root / "ckpt_port")
    yaml_path = root / "port.yaml"
    yaml_path.write_text(yaml.safe_dump(json.loads(json.dumps(port_cfg))))
    argv = FLAGS + ["--config", str(yaml_path), "--vis_dir", "port", "--resume", str(ckpt_dir)]
    (root / "port").mkdir()
    with _in_dir(root / "port"):
        port_mds = cli.main(argv + ["--go_test"], device="cpu")
        port_test = cli.main(argv + ["--test", "--rec", "crnn", "--test_data_dir", db], device="cpu")
        port_demo = cli.main(argv + ["--demo", "--demo_dir", str(demo_dir)], device="cpu")
    return {"root": root, "jax": (jax_mds, jax_test, jax_demo), "port": (port_mds, port_test, port_demo)}


def _assert_metric_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k in ("psnr_avg", "ssim_avg"):
            np.testing.assert_allclose(got[k], v, rtol=PSNR_SSIM_RTOL, err_msg=k)
        elif k != "fps":
            assert got[k] == v, k


def test_go_test_matches_jax_and_writes_its_visualizations(modes):
    """``--go_test`` from a checkpoint dir (the best file preferred): the
    metric dict of each split equals JAX's (accuracies exactly, PSNR and
    SSIM at 1e-4), some accuracy above 0; the LR|SR|HR grids are the same
    files, named by the LR and SR reads and the label."""
    (jax_mds, _, _), (port_mds, _, _) = modes["jax"], modes["port"]
    assert list(port_mds) == list(jax_mds) == ["relabelled"]
    for name, want in jax_mds.items():
        _assert_metric_dicts_equal(port_mds[name], want)
    assert port_mds["relabelled"]["accuracy_hr"] > 0
    root = modes["root"]
    for sub in ("demo/{}/1", "display/{}"):
        got = sorted(os.listdir(root / "port" / sub.format("port")))
        assert got == sorted(os.listdir(root / "jax" / sub.format("jax")))
    assert os.listdir(root / "port" / "demo" / "port" / "1")  # one file a distinct name


def test_test_mode_matches_jax(modes):
    """``--test --rec crnn`` over TEST.test_data_dir (one warm batch, then the
    timed pass): JAX's metric dict, and a frame rate."""
    (_, jax_test, _), (_, port_test, _) = modes["jax"], modes["port"]
    _assert_metric_dicts_equal(port_test, jax_test)
    assert port_test["images"] == 16 and port_test["fps"] > 0


def test_demo_reads_what_jax_reads(modes):
    """``--demo`` over four PNGs of other sizes and a text file (skipped):
    the LR and SR strings equal the lines JAX prints."""
    (_, _, jax_demo), (_, _, port_demo) = modes["jax"], modes["port"]
    assert [f for f, _, _ in port_demo] == ["0_abc.png", "1_scene.png", "2_xyz.png", "3_text.png"]
    assert [f"{f}: LR='{lr}' SR='{sr}'" for f, lr, sr in port_demo] == jax_demo
