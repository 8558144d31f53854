"""The port's ``TextSR`` held to the JAX package's on the CPU: the train loop
over 3 epochs (losses, val, best tracking, checkpoints, the scalar log), its
checkpoints read by the JAX package, resume, the eval-only preference for
the best files, and ``BestTracker``.

Sizes are tests/test_torch_train.py's (2 SRBs, hidden 8, LR 16x32 -> HR
32x64, STN, mask, fp32) over the 16-pair LMDB of
``tests.fixtures.make_textzoom_lmdb``, batch 8 (2 iterations an epoch); the
SR weights cross through ``interop.from_jax``, the teacher through a
``crnn.pth`` both packages load."""

import contextlib
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.fixtures import make_textzoom_lmdb
from tests.test_torch_train import LOSS_RTOL
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu import config as jax_config
from tpgsr_tpu.interop.torch_import import restore_reference_checkpoint
from tpgsr_tpu.parallel import shard_params
from tpgsr_tpu.train.evaluate import evaluate as jax_evaluate
from tpgsr_tpu.train.trainer import BestTracker as JaxBestTracker
from tpgsr_tpu.train.trainer import TextSR as JaxTextSR
from tpgsr_tpu_torch import config
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.ops.ctc import decode_crnn
from tpgsr_tpu_torch.train import checkpoint as ckpt
from tpgsr_tpu_torch.train import trainer
from tpgsr_tpu_torch.train.evaluate import evaluate

H, W, B = 16, 32, 8
ARGS = dict(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, gradient=True, sr_share=True, stu_iter=1,
            srb=2, hd_u=8, batch_size=B)
# Steps 4-6: Adam's near-sign updates where a gradient is near 0 amplify the
# two frameworks' rounding about 7x a step here (relative differences
# measured at steps 4, 5, 6: loss_total 1e-4, 3e-4, 2.2e-3; loss_distill,
# 0.3 % of the total, 3e-4, 4e-3, 2e-2), so the late steps are held at 5e-2,
# inside the 0.15 cap of the JAX package's own chaos envelope for its
# whole-run parity (tests/test_reference_whole_run.py:541-557).  A
# systematic fault shows at steps 1-3, held at tests/test_torch_train.py's
# bounds.
LATE_LOSS_RTOL = 5e-2
# The val at iteration 4 follows 4 updates and reads the BatchNorm running
# statistics, which tests/test_torch_train.py holds at 1e-2 after 3 steps
# (measured here: PSNR 2.8e-4, SSIM 1.6e-3 to 1.8e-3 apart): PSNR and SSIM
# at 1e-2.  The same weights evaluate to 1e-4 in both packages
# (test_port_checkpoint_evaluates_the_same_in_jax).
VAL_RTOL = 1e-2
PSNR_SSIM_RTOL = 1e-4


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


def _configure(cfg, db, teacher_path, ckpt_dir, epochs=3, interval=4):
    t = cfg.TRAIN
    t.train_data_dir, t.VAL.val_data_dir = [db], [db]
    t.width, t.height, t.batch_size, t.epochs, t.compute_dtype = 2 * W, 2 * H, B, epochs, "fp32"
    t.VAL.valInterval, t.saveInterval, t.displayInterval = interval, interval, 2
    t.VAL.crnn_pretrained, t.ckpt_dir = teacher_path, str(ckpt_dir)
    return cfg


def _recorder(fn, log, to_numbers):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        log.append(to_numbers(out))
        return out
    return wrapped


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    teacher_path = str(root / "crnn.pth")
    torch.save(init_torch_defaults_(CRNN(nclass=CTC_NUM_CLASSES), torch.Generator().manual_seed(7)).state_dict(),
               teacher_path)
    return root, make_textzoom_lmdb(str(root / "tz"), n=16), teacher_path


@pytest.fixture(scope="module")
def runs(shared):
    """``TextSR.train()`` of each package over 3 epochs (6 iterations, val and
    save at 4) from the same weights, each step's losses and each val's
    metric dicts recorded by wrapping the trainer's own functions."""
    root, db, teacher_path = shared
    jax_cfg = _configure(jax_config.load_config(), db, teacher_path, root / "ckpt_jax")
    jax_cfg.TRAIN.dispatch_chain, jax_cfg.TRAIN.n_devices = 1, 1
    jax_mission = JaxTextSR(jax_cfg, jax_config.default_args(vis_dir="run", **ARGS))
    (root / "jax").mkdir()
    with _in_dir(root / "jax"):
        state = jax_mission.init_state()
        sr_vars = jax.tree_util.tree_map(np.asarray, unfreeze({"params": state.sr_params[0],
                                                                "batch_stats": state.sr_stats[0]}))
        jax_mission._build_steps()
        jax_losses, jax_vals = [], []
        jax_mission._train_step = _recorder(jax_mission._train_step, jax_losses,
                                            lambda out: {k: float(v) for k, v in out[1].items()})
        jax_mission._run_val = _recorder(jax_mission._run_val, jax_vals, lambda out: out)
        jax_mission.train()

    port_cfg = _configure(config.load_config(), db, teacher_path, root / "ckpt_port")
    port_cfg.TRAIN.workers = 0
    port = trainer.TextSR(port_cfg, config.default_args(vis_dir="run", **ARGS), device="cpu")
    (root / "port").mkdir()
    with _in_dir(root / "port"):
        port_state = port.init_state()
        port_state.sr[0].load_state_dict(from_jax.tsrn_tl_state_dict(sr_vars, srb_nums=2))
        port._build_steps()
        port_losses, port_vals = [], []
        port._train_step = _recorder(port._train_step, port_losses, lambda out: {k: float(v) for k, v in out.items()})
        port._run_val = _recorder(port._run_val, port_vals, lambda out: out)
        port.train()
    return {"root": root, "db": db, "jax": (jax_mission, jax_losses, jax_vals),
            "port": (port, port_losses, port_vals)}


def _assert_metric_dicts_equal(got, want, rtol=PSNR_SSIM_RTOL):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k in ("psnr_avg", "ssim_avg"):
            np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)
        else:
            assert got[k] == v, k


def test_train_losses_match_jax(runs):
    """Every iteration's losses: steps 1-3 at tests/test_torch_train.py's
    per-step bounds, steps 4-6 at ``LATE_LOSS_RTOL``."""
    (_, want, _), (_, got, _) = runs["jax"], runs["port"]
    assert len(got) == len(want) == 6
    for k, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        rtol = LOSS_RTOL[k] if k < len(LOSS_RTOL) else LATE_LOSS_RTOL
        for name in ("loss_total", "loss_img", "loss_distill"):
            np.testing.assert_allclose(g[name], w[name], rtol=rtol, err_msg=f"step {k + 1} {name}")


def test_val_metrics_and_info_match_jax(runs):
    """The val at iteration 4: each split's metric dict (accuracies exactly,
    PSNR and SSIM at ``VAL_RTOL``); ``info.json``'s ``best_history_res``,
    ``iters``, ``epochs``, ``step`` and the rest of the info dict."""
    (jax_mission, _, jax_vals), (port, _, port_vals) = runs["jax"], runs["port"]
    assert len(port_vals) == len(jax_vals) == 1
    assert list(port_vals[0]) == list(jax_vals[0]) == ["tz"]
    _assert_metric_dicts_equal(port_vals[0]["tz"], jax_vals[0]["tz"], rtol=VAL_RTOL)
    with open(os.path.join(jax_mission.ckpt_dir, "info.json")) as f:
        want = json.load(f)
    with open(os.path.join(port.ckpt_dir, "info.json")) as f:
        got = json.load(f)
    for key in ("best_history_res", "iters", "epochs", "step", "arch", "batch_size", "voc_type", "up_scale_factor"):
        assert got[key] == want[key], key
    assert got["iters"] == got["step"] == 4 and port._state.step == 6


def test_scalar_log_and_checkpoint_files_match_jax(runs):
    """``scalars.jsonl``: the same tags at the same steps (losses at 5, eval at
    4), the accuracies equal and the rest at ``LATE_LOSS_RTOL``; the
    checkpoint directories hold the same files, ``.pth`` for ``.msgpack``."""
    (jax_mission, _, _), (port, _, _) = runs["jax"], runs["port"]
    root = runs["root"]

    def log(pkg):
        with open(root / pkg / "tensorboard" / "run" / "scalars.jsonl") as f:
            return [json.loads(line) for line in f]

    got, want = log("port"), log("jax")
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    assert {r["tag"] for r in got} == {"loss/total", "loss/SR", "loss/distill", "eval/psnr_avg_tz",
                                       "eval/ssim_avg_tz", "eval/accuracy_tz"}
    for g, w in zip(got, want):
        if g["tag"].startswith("eval/accuracy_"):
            assert g["value"] == w["value"], g["tag"]
        else:
            np.testing.assert_allclose(g["value"], w["value"], rtol=LATE_LOSS_RTOL, err_msg=g["tag"])
    assert sorted(os.listdir(port.ckpt_dir)) == sorted(f.replace(".msgpack", ".pth")
                                                       for f in os.listdir(jax_mission.ckpt_dir))


def test_port_checkpoint_evaluates_the_same_in_jax(runs, tmp_path):
    """A best save of the trained port state, read by the JAX package's
    ``restore_reference_checkpoint`` into the JAX state: ``evaluate`` over
    the val LMDB gives the port's metric dict (PSNR and SSIM at 1e-4,
    accuracies equal) and the first batch's SR reads the same strings."""
    (jax_mission, _, _), (port, _, _) = runs["jax"], runs["port"]
    info = port._info(6, 2, trainer.BestTracker(["tz"]))
    ckpt.save_checkpoint(str(tmp_path), port._state, info, True, [])
    assert {"model_best_0.pth", "recognizer_best_0.pth"} <= set(os.listdir(tmp_path))
    restored = restore_reference_checkpoint(str(tmp_path), jax_mission._state, "tsrn_tl_cascade", srb_nums=2)
    restored = shard_params(jax_mission.mesh, restored)
    (jax_loader,) = jax_mission.get_val_data()
    want = jax_evaluate(jax_mission._eval_step, restored, jax_loader, mesh=jax_mission.mesh)
    (loader,) = port.get_val_data()
    models = port._eval_models(port._state)
    _assert_metric_dicts_equal(evaluate(port._eval_step, models, loader), want)
    batch = next(iter(loader))
    ref_batch = next(iter(jax_loader))
    _, outs = port._eval_step(models, batch)
    _, ref_outs = jax_mission._eval_step(restored, {k: ref_batch[k] for k in ("hr", "lr")})
    ref_strings = decode_crnn(torch.from_numpy(np.array(ref_outs["logits_sr"])))
    assert decode_crnn(outs["logits_sr"]) == ref_strings


def _resume_cfg(shared, ckpt_dir, epochs, workers):
    root, db, teacher_path = shared
    cfg = _configure(config.load_config(), db, teacher_path, ckpt_dir, epochs=epochs, interval=2)
    cfg.TRAIN.workers = workers
    cfg.TRAIN.VAL.valInterval = 1000
    return cfg


def _run(cfg, cwd, calls=1, **args):
    """(labels of each step's batch, each step's losses, final state_dicts,
    state) of ``calls`` ``train()`` calls on one ``TextSR``."""
    mission = trainer.TextSR(cfg, config.default_args(vis_dir="resume", **{**ARGS, **args}), device="cpu")
    seen = []
    with _in_dir(cwd):
        mission._build_steps()
        step = mission._train_step

        def recorded(state, batch):
            metrics = step(state, batch)
            seen.append((list(batch["labels"]), {k: float(v) for k, v in metrics.items()}))
            return metrics

        mission._train_step = recorded
        for _ in range(calls):
            state = mission.train()
    return seen, [m.state_dict() for m in (*state.sr, *state.stu)], state


@pytest.mark.parametrize("workers", [0, 2])
def test_resume_equals_an_uninterrupted_run(shared, tmp_path, workers):
    """One run of two epochs equals, bit for bit on the CPU, two ``train()``
    calls of one epoch each on one ``TextSR``, and one epoch, a save, then a
    new ``TextSR`` with ``--resume`` for one more: the batches (global epoch
    2's shuffle in the second epoch), every loss, every weight and BN
    statistic; the resume takes Adam's state and the step from the files."""
    whole, whole_sd, whole_state = _run(_resume_cfg(shared, tmp_path / "a", 2, workers), tmp_path)
    chunked, chunked_sd, chunked_state = _run(_resume_cfg(shared, tmp_path / "c", 1, workers), tmp_path, calls=2)
    first, _, _ = _run(_resume_cfg(shared, tmp_path / "b", 1, workers), tmp_path)
    second, second_sd, second_state = _run(_resume_cfg(shared, tmp_path / "b", 1, workers), tmp_path,
                                           resume=str(tmp_path / "b" / "resume"))
    assert len(whole) == 4 and chunked == whole and first + second == whole
    assert [s[0] for s in whole[:2]] != [s[0] for s in whole[2:]]  # epochs 1 and 2 shuffle apart
    assert whole_state.step == chunked_state.step == second_state.step == 4
    for sds in (chunked_sd, second_sd):
        for got, want in zip(sds, whole_sd):
            assert sorted(got) == sorted(want)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    with open(tmp_path / "b" / "resume" / "info.json") as f:
        assert json.load(f)["step"] == 4


def test_eval_only_resume_prefers_the_best_files(shared, tmp_path):
    """A checkpoint dir whose periodic files differ from its best ones: a
    training resume takes the periodic files, Adam's state and the step; an
    eval-only one (``--go_test``, ``--test``, ``--demo``) the best files,
    and neither Adam's state nor the step."""
    cfg = _resume_cfg(shared, tmp_path / "ckpt", 1, 0)
    mission = trainer.TextSR(cfg, config.default_args(vis_dir="best", **ARGS), device="cpu")
    state = mission.init_state()
    info = mission._info(2, 0, trainer.BestTracker(["tz"]))
    ckpt.save_checkpoint(mission.ckpt_dir, state, info, True, [])
    best = [{k: v.clone() for k, v in m.state_dict().items()} for m in (*state.sr, *state.stu)]
    with torch.no_grad():
        for m in (*state.sr, *state.stu):
            for p in m.parameters():
                p.add_(1.0)
    state.step = 7
    ckpt.save_checkpoint(mission.ckpt_dir, state, info, False, [])
    periodic = [m.state_dict() for m in (*state.sr, *state.stu)]

    for flags, want, step in (({}, periodic, 7), ({"go_test": True}, best, 0), ({"demo": True}, best, 0),
                              ({"test": True, "rec": "crnn"}, best, 0)):
        args = config.default_args(vis_dir="best", resume=mission.ckpt_dir, **{**ARGS, **flags})
        got = trainer.TextSR(_resume_cfg(shared, tmp_path / "ckpt", 1, 0), args, device="cpu").init_state()
        assert got.step == step, flags
        for m, sd in zip((*got.sr, *got.stu), want):
            for k, v in m.state_dict().items():
                assert torch.equal(v, sd[k]), (flags, k)


def test_best_tracker_matches_jax():
    """A hand-made sequence of evals over three splits: ties, one split rising
    while the sum falls, a new best whose PSNR and SSIM go to the last split
    only (the reference's loop-variable quirk)."""
    splits = ["easy", "medium", "hard"]

    def mds(accs, base):
        return {s: {"accuracy": a, "psnr_avg": base + i, "ssim_avg": base / 100 + i / 10}
                for i, (s, a) in enumerate(zip(splits, accs))}

    sequence = [(0.0, 0.0, 0.0), (0.1, 0.2, 0.0), (0.1, 0.2, 0.0), (0.5, 0.0, 0.0), (0.2, 0.3, 0.4),
                (0.6, 0.1, 0.1), (0.2, 0.3, 0.4)]
    got, want = trainer.BestTracker(splits), JaxBestTracker(splits)
    for epoch, accs in enumerate(sequence):
        evals = mds(accs, 10.0 + epoch)
        assert got.update(evals, epoch) == want.update(evals, epoch), epoch
        assert got.best_history_acc == want.best_history_acc
        assert got.best_model_info == want.best_model_info
        assert got.best_sum == want.best_sum
