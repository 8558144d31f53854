"""The last three paths through the port's ``TextSR`` and CLI, held to the JAX
package's ``TextSR`` on the CPU: ``TextSR.train()`` for ``tsrn_c2f`` (with
its STN), ``sem_tsrn`` and the flagship with ``--tpg OPT`` over 2 iterations
with a val and a save, against the JAX ``TextSR`` from the same weights;
then ``--go_test --test_model SEED`` from the ``tsrn_c2f`` checkpoint
through ``cli.main``, against the JAX ``TextSR``'s val with the same SEED
weights; and each path through ``cli.main`` on the packaged YAML (bf16).

Sizes and bounds are tests/test_torch_zoo_trainer.py's (LR 16x32 -> HR
32x64, 2 SRBs at hidden 8, batch 8 over the 16-pair LMDB: 2 iterations an
epoch); the OPT models at 64 channels, read by both packages from one
``.pth`` of the port's seeded draw, as is the eval CRNN.  The OPT path's
losses are held at tests/test_torch_zoo_last_train.py's ``OPT_LOSS_RTOL``
at step 1; at step 2 its image losses at ``LOSS_RTOL``'s 1e-4 and its
distillation (and the total that carries it) at tests/test_torch_trainer.py's
``LATE_LOSS_RTOL``: step 1's updates of the OPT students already part from
JAX's by up to 43 % (tests/test_torch_zoo_last_train.py, fp32's noise
through their train-mode BatchNorm), and step 2's distillation by 0.56 %."""

import contextlib
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.test_torch_cli import _relabelled_lmdb
from tests.test_torch_train import LOSS_RTOL
from tests.test_torch_trainer import LATE_LOSS_RTOL, PSNR_SSIM_RTOL, VAL_RTOL
from tests.test_torch_zoo_last_train import OPT_LOSS_RTOL
from tests.torch_recognizers import seed_variables
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu import config as jax_config
from tpgsr_tpu.charset import AsterInfo as JaxAsterInfo
from tpgsr_tpu.models.aster import decode_aster_ids as jax_decode_aster_ids
from tpgsr_tpu.models.seed import SEEDModelBuilder as JaxSEED
from tpgsr_tpu.train.trainer import TextSR as JaxTextSR
from tpgsr_tpu_torch import cli, config
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.opt_tpg import OPTModel
from tpgsr_tpu_torch.models.seed import SEEDModelBuilder
from tpgsr_tpu_torch.train import trainer

ROOT = Path(__file__).resolve().parent.parent
H, W, B = 16, 32, 8
SMALL = ["--srb", "2", "--hd_u", "8", "--batch_size", str(B)]
OPT_CHANNELS = 64
ARGS = {
    "tsrn_c2f": dict(arch="tsrn_c2f", STN=True, mask=True, gradient=True),
    "sem_tsrn": dict(arch="sem_tsrn", mask=True, gradient=True),
    "opt": dict(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, gradient=True, sr_share=True,
                stu_iter=1, tpg="OPT"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _in_dir(path):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(path)
        yield


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """A seeded ``crnn.pth`` (the eval CRNN), a seeded OPT ``.pth`` of 64
    channels (the ``--tpg OPT`` teacher) and the relabelled 16-pair LMDB."""
    root = tmp_path_factory.mktemp("zoo_last_trainer")
    crnn_path, opt_path = str(root / "crnn.pth"), str(root / "opt.pth")
    torch.save(init_torch_defaults_(CRNN(nclass=CTC_NUM_CLASSES), torch.Generator().manual_seed(7)).state_dict(),
               crnn_path)
    torch.save(init_torch_defaults_(OPTModel(37, OPT_CHANNELS), torch.Generator().manual_seed(8)).state_dict(),
               opt_path)
    opt = config.tpg_opt()
    opt.update(output_channel=OPT_CHANNELS, saved_model=opt_path)
    return root, _relabelled_lmdb(root, crnn_path), crnn_path, opt


def _configure(cfg, db, crnn_path, ckpt_dir, dtype="fp32"):
    t = cfg.TRAIN
    t.train_data_dir, t.VAL.val_data_dir = [db], [db]
    t.width, t.height, t.batch_size, t.epochs, t.compute_dtype = 2 * W, 2 * H, B, 1, dtype
    t.VAL.valInterval, t.saveInterval, t.displayInterval = 2, 2, 2
    t.VAL.crnn_pretrained, t.ckpt_dir = crnn_path, str(ckpt_dir)
    return cfg


def _recorder(fn, log, to_numbers):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        log.append(to_numbers(out))
        return out
    return wrapped


@pytest.fixture(scope="module", params=list(ARGS))
def runs(request, shared):
    """``TextSR.train()`` of each package over 2 iterations (val and save at
    2) from the same weights, each step's losses and the val's metric dicts
    recorded."""
    path = request.param
    root, db, crnn_path, opt = shared
    args = dict(ARGS[path], srb=2, hd_u=8, batch_size=B, vis_dir=path)
    jax_cfg = _configure(jax_config.load_config(), db, crnn_path, root / f"ckpt_jax_{path}")
    jax_cfg.TRAIN.dispatch_chain, jax_cfg.TRAIN.n_devices = 1, 1
    jax_mission = JaxTextSR(jax_cfg, jax_config.default_args(**args), opt)
    (root / f"jax_{path}").mkdir()
    with _in_dir(root / f"jax_{path}"):
        state = jax_mission.init_state()
        sr_vars = jax.tree_util.tree_map(np.asarray, unfreeze({"params": state.sr_params[0],
                                                                "batch_stats": state.sr_stats[0]}))
        jax_mission._build_steps()
        jax_losses, jax_vals = [], []
        jax_mission._train_step = _recorder(jax_mission._train_step, jax_losses,
                                            lambda out: {k: float(v) for k, v in out[1].items()})
        jax_mission._run_val = _recorder(jax_mission._run_val, jax_vals, lambda out: out)
        jax_mission.train()

    port_cfg = _configure(config.load_config(), db, crnn_path, root / f"ckpt_port_{path}")
    port_cfg.TRAIN.workers = 0
    port = trainer.TextSR(port_cfg, config.default_args(**args), opt, device="cpu")
    (root / f"port_{path}").mkdir()
    with _in_dir(root / f"port_{path}"):
        port_state = port.init_state()
        port_state.sr[0].load_state_dict(from_jax.sr_state_dict(args["arch"], sr_vars, srb_nums=2))
        port._build_steps()
        port_losses, port_vals = [], []
        port._train_step = _recorder(port._train_step, port_losses, lambda out: {k: float(v) for k, v in out.items()})
        port._run_val = _recorder(port._run_val, port_vals, lambda out: out)
        port.train()
    return {"path": path, "jax": (jax_mission, jax_losses, jax_vals), "port": (port, port_losses, port_vals),
            "sr_vars": sr_vars}


def _assert_metric_dicts_equal(got, want, rtol=PSNR_SSIM_RTOL):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k in ("psnr_avg", "ssim_avg"):
            np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)
        else:
            assert got[k] == v, k


def test_train_losses_val_and_files_match_jax(runs):
    """Both iterations' losses at the module docstring's bounds; the val's metric dict
    (accuracies exactly, PSNR and SSIM at ``VAL_RTOL``); ``info.json``; the
    same checkpoint files, ``.pth`` for ``.msgpack`` (``recognizer_*`` the
    OPT students' only); the OPT path's students hold clova's keys and its
    val was read by a CRNN of its own, not the OPT teacher."""
    (jax_mission, want, jax_vals), (port, got, port_vals) = runs["jax"], runs["port"]
    path = runs["path"]
    assert len(got) == len(want) == 2
    for k, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for name in g:
            rtol = LOSS_RTOL[k]
            if path == "opt":
                rtol = OPT_LOSS_RTOL if k == 0 else LATE_LOSS_RTOL if name in ("loss_distill", "loss_total") else rtol
            np.testing.assert_allclose(g[name], w[name], rtol=rtol, err_msg=f"step {k + 1} {name}")
    if path != "opt":
        assert all(g["loss_distill"] == 0.0 for g in got)
    assert len(port_vals) == len(jax_vals) == 1
    _assert_metric_dicts_equal(port_vals[0]["relabelled"], jax_vals[0]["relabelled"], rtol=VAL_RTOL)
    with open(os.path.join(jax_mission.ckpt_dir, "info.json")) as f:
        info_want = json.load(f)
    with open(os.path.join(port.ckpt_dir, "info.json")) as f:
        info_got = json.load(f)
    for key in ("best_history_res", "iters", "epochs", "step", "arch", "batch_size", "voc_type", "up_scale_factor"):
        assert info_got[key] == info_want[key], key
    files = sorted(os.listdir(port.ckpt_dir))
    assert files == sorted(f.replace(".msgpack", ".pth") for f in os.listdir(jax_mission.ckpt_dir))
    assert any(f.startswith("recognizer_") for f in files) == (path == "opt")
    if path == "opt":
        assert isinstance(port._state.teacher, OPTModel) and isinstance(port._rec, CRNN)
        sd = torch.load(os.path.join(port.ckpt_dir, "recognizer_0.pth"), weights_only=True)
        assert sorted(sd) == sorted(OPTModel(37, OPT_CHANNELS).state_dict())
        assert port_vals[0]["relabelled"]["accuracy_hr"] > 0


def test_go_test_with_seed_matches_jax(shared, tmp_path):
    """``--go_test --test_model SEED`` for ``tsrn_c2f``: the JAX ``TextSR``'s
    val with a sharpened SEED, and ``cli.main(..., device="cpu")`` from a
    port checkpoint of the JAX SR weights with the same SEED
    (``trainer.eval_recognizer`` serving it): the same metric dict
    (accuracies exactly, PSNR and SSIM at 1e-4), and the same strings read
    by both on the first batch."""
    root, db, crnn_path, opt = shared
    args = dict(ARGS["tsrn_c2f"], srb=2, hd_u=8, batch_size=B, vis_dir="seed", go_test=True, test_model="SEED")
    info = JaxAsterInfo("all")
    seed_vars = seed_variables(SEEDModelBuilder(info.rec_num_classes, info.char2id[info.EOS]).init_from_(
        torch.Generator().manual_seed(9)), 9)
    jax_seed = JaxSEED(rec_num_classes=info.rec_num_classes, eos_id=info.char2id[info.EOS],
                       max_len_labels=info.max_len)
    jax_cfg = _configure(jax_config.load_config(), db, crnn_path, tmp_path / "ckpt_jax")
    jax_cfg.TRAIN.dispatch_chain, jax_cfg.TRAIN.n_devices = 1, 1
    jax_mission = JaxTextSR(jax_cfg, jax_config.default_args(**args), opt)
    jax_mission._eval_recognizer = lambda: (("SEED", jax_seed, seed_vars),
                                            lambda ids: jax_decode_aster_ids(ids, info))
    jax_vals = []
    (tmp_path / "jax").mkdir()
    with _in_dir(tmp_path / "jax"):
        state = jax_mission.init_state()
        jax_mission._run_val = _recorder(jax_mission._run_val, jax_vals, lambda out: out)
        jax_mission.train()
    sr_vars = jax.tree_util.tree_map(np.asarray, unfreeze({"params": state.sr_params[0],
                                                            "batch_stats": state.sr_stats[0]}))

    port_cfg = _configure(config.load_config(), db, crnn_path, tmp_path / "ckpt_port")
    port_cfg.TRAIN.workers = 0
    yaml_path = tmp_path / "fp32.yaml"
    yaml_path.write_text(json.dumps(port_cfg))  # JSON is YAML
    mission = trainer.TextSR(port_cfg, config.default_args(**{**args, "go_test": False}), opt, device="cpu")
    port_state = mission.init_state()
    port_state.sr[0].load_state_dict(from_jax.sr_state_dict("tsrn_c2f", sr_vars, srb_nums=2))
    info_dict = mission._info(0, 0, trainer.BestTracker(["relabelled"]))
    ckpt_dir = tmp_path / "ckpt_port" / "seed"
    trainer.ckpt.save_checkpoint(str(ckpt_dir), port_state, info_dict, True, [])
    port_seed = SEEDModelBuilder(info.rec_num_classes, info.char2id[info.EOS], max_len_labels=info.max_len)
    port_seed.load_state_dict(from_jax.seed_state_dict(seed_vars))
    real = trainer.eval_recognizer
    argv = ["--arch", "tsrn_c2f", "--STN", "--mask", "--gradient", *SMALL, "--vis_dir", "seed", "--config",
            str(yaml_path), "--go_test", "--test_model", "SEED", "--resume", str(ckpt_dir)]
    (tmp_path / "port").mkdir()
    with pytest.MonkeyPatch.context() as mp, _in_dir(tmp_path / "port"):
        mp.setattr(trainer, "eval_recognizer",
                   lambda kind, cfg, device=None: port_seed.eval() if kind == "SEED" else real(kind, cfg, device))
        got = cli.main(argv, device="cpu")
    assert list(got) == ["relabelled"] and len(jax_vals) == 1
    _assert_metric_dicts_equal(got["relabelled"], jax_vals[0]["relabelled"])
    assert got["relabelled"]["images"] == 16


FLAGS = {
    "tsrn_c2f": ["--arch", "tsrn_c2f", "--STN", "--mask", "--gradient"],
    "sem_tsrn": ["--arch", "sem_tsrn", "--mask", "--gradient"],
    "opt": ["--arch", "tsrn_tl_cascade", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
            "--stu_iter=1", "--tpg", "OPT"],
}


@pytest.mark.parametrize("path", list(FLAGS))
def test_cli_runs_each_path_on_the_packaged_yaml(shared, tmp_path, path):
    """``cli.main`` with the path's flags (at this file's size) and the
    packaged YAML (bf16): one epoch of 2 iterations with a val and a save,
    finite losses; then ``--go_test`` from that checkpoint gives the val's
    metric dict again.  The CLI passes ``config.tpg_opt()``, whose
    ``saved_model`` does not exist here: the OPT teacher is drawn."""
    root, db, crnn_path, _ = shared
    cfg = _configure(config.load_config(), db, crnn_path, tmp_path / "ckpt", dtype="bf16")
    cfg.TRAIN.workers = 0
    yaml_path = tmp_path / "packaged.yaml"
    yaml_path.write_text(json.dumps(cfg))  # JSON is YAML
    argv = FLAGS[path] + SMALL + ["--vis_dir", path, "--config", str(yaml_path)]
    vals, losses = [], []
    make, run_val = trainer.make_train_step, trainer.TextSR._run_val

    def recorded_make(*a, **k):
        assert k["compute_dtype"] == "bf16"
        step = make(*a, **k)

        def recorded(state, batch):
            metrics = step(state, batch)
            losses.append({n: float(v) for n, v in metrics.items()})
            return metrics

        return recorded

    def recorded_val(mission, *a, **k):
        vals.append(run_val(mission, *a, **k))
        return vals[-1]

    with pytest.MonkeyPatch.context() as mp, _in_dir(tmp_path):
        mp.setattr(trainer, "make_train_step", recorded_make)
        mp.setattr(trainer.TextSR, "_run_val", recorded_val)
        state = cli.main(argv, device="cpu")
        go_test = cli.main(argv + ["--go_test", "--resume", str(tmp_path / "ckpt" / path)], device="cpu")
    assert state.step == 2 and len(losses) == 2
    assert all(np.isfinite(v) for m in losses for v in m.values())
    assert len(state.stu) == (1 if path == "opt" else 0)
    assert isinstance(state.teacher, OPTModel) == (path == "opt")
    assert vals[-1] == go_test and list(go_test) == ["relabelled"]
