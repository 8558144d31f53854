"""``--syn``, ``--mixed`` and ``--ic15sr`` train through the port's ``TextSR``
and CLI on the CPU.

``--syn``: ``TextSR.train()`` with the flagship's flags over a synthetic
single-image LMDB (16 words at TextZoom's and other native sizes, batch 8,
one epoch of 2 iterations, a val and a save at 2), each step's batch
(``collate_syn``'s float32 HR and LR with the mask channel) and the state
after it recorded; the JAX package's train step from the same weights on
the same batches is held to it under tests/test_torch_train.py's rules:
the losses at ``LOSS_RTOL``, Adam's moments at ``MOMENT_RTOL``, the
BatchNorm statistics at ``STATS_RTOL``, every parameter within 2.5 lr a
step of the JAX one.  The val reads ``collate_syn``'s batches through the
fp32 eval step.

``--mixed`` and ``--ic15sr``: ``cli.main`` with the flagship's flags over a
TextZoom LMDB (HR as LR half the time) and over an IC15 PGM tree, 2
iterations with a val and a save: the step count, finite losses, the
``eval/`` scalars and the checkpoint files.  Their batches equal the JAX
package's (tests/test_torch_data_modes.py), so they run no JAX step of
their own.

Sizes: tests/test_torch_train.py's (2 SRBs, hidden 8, LR 16x32 -> HR
32x64, STN, mask, fp32)."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.fixtures import make_textzoom_lmdb
from tests.test_torch_train import LOSS_RTOL, LR, MOMENT_RTOL, PRE_BN_BIAS, STATS_RTOL, _rel
from tests.torch_modes import make_ic15_tree, make_syn_lmdb
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu import config as jax_config
from tpgsr_tpu.interop import torch_import as ti
from tpgsr_tpu.models.crnn import CRNN as JaxCRNN
from tpgsr_tpu.models.registry import ARCHS as JAX_ARCHS
from tpgsr_tpu.models.tsrn import TSRN_TL as JaxTSRN_TL
from tpgsr_tpu.train.state import create_train_state as jax_create_train_state
from tpgsr_tpu.train.step import make_train_step as jax_make_train_step
from tpgsr_tpu_torch import cli, config
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES
from tpgsr_tpu_torch.interop import from_jax
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.train import trainer

H, W, B = 16, 32, 8
ARGS = dict(arch="tsrn_tl_cascade", STN=True, mask=True, use_distill=True, gradient=True, sr_share=True, stu_iter=1,
            srb=2, hd_u=8, batch_size=B)
FLAGS = ["--arch", "tsrn_tl_cascade", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
         "--stu_iter=1", "--srb", "2", "--hd_u", "8", "--batch_size", str(B)]
# native sizes (width, height) of the synthetic words: TextZoom's HR and
# others, which collate_syn resizes
SYN_SIZES = [(128, 32), (100, 32), (57, 20), (140, 36)] * 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The data of the three flags, a seeded ``crnn.pth`` both packages load
    as the teacher, and the fp32 YAML (one epoch, a val and a save at 2)."""
    root = tmp_path_factory.mktemp("modes_trainer")
    crnn_path = str(root / "crnn.pth")
    torch.save(init_torch_defaults_(CRNN(nclass=CTC_NUM_CLASSES), torch.Generator().manual_seed(7)).state_dict(),
               crnn_path)
    dirs = {"syn": make_syn_lmdb(str(root / "syn"), SYN_SIZES), "mixed": make_textzoom_lmdb(str(root / "tz"), n=16),
            "ic15sr": make_ic15_tree(str(root / "ic15"), n_train=16, n_test=6)}
    return root, dirs, crnn_path


def _config(root, data_dir, crnn_path):
    cfg = config.load_config()
    t = cfg.TRAIN
    t.train_data_dir, t.VAL.val_data_dir = [data_dir], [data_dir]
    t.width, t.height, t.batch_size, t.epochs, t.compute_dtype, t.workers = 2 * W, 2 * H, B, 1, "fp32", 0
    t.VAL.valInterval, t.saveInterval, t.displayInterval = 2, 2, 1
    t.VAL.crnn_pretrained, t.ckpt_dir = crnn_path, str(root / "ckpt")
    return cfg


def _snapshot(state):
    """Each trained model's state_dict and Adam's moments, by parameter name."""
    out = []
    for kind, models in (("sr", state.sr), ("stu", state.stu)):
        for i, m in enumerate(models):
            named = dict(m.named_parameters())
            moments = {n: {k: v.clone() for k, v in state.optimizer.state[p].items() if k != "step"}
                       for n, p in named.items()}
            out.append((kind, i, {k: v.clone() for k, v in m.state_dict().items()}, moments))
    return out


@pytest.fixture(scope="module")
def syn_run(shared):
    """The port's ``--syn`` run: its initial state_dicts, each step's batch,
    losses and state after it, and the val's metric dict."""
    root, dirs, crnn_path = shared
    port = trainer.TextSR(_config(root, dirs["syn"], crnn_path), config.default_args(syn=True, vis_dir="syn", **ARGS),
                          device="cpu")
    state = port.init_state()
    init = {k: v.numpy().copy() for k, v in state.sr[0].state_dict().items()}
    port._build_steps()
    steps, vals, step, run_val = [], [], port._train_step, port._run_val

    def recorded(s, batch):
        metrics = step(s, batch)
        steps.append(({k: batch[k].numpy() for k in ("hr", "lr")}, {k: float(v) for k, v in metrics.items()},
                      _snapshot(s)))
        return metrics

    port._train_step = recorded
    port._run_val = lambda *a, **k: vals.append(run_val(*a, **k)) or vals[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        port.train()
    return port, init, steps, vals


def _jax_to_sd(kind, params, stats):
    v = jax.tree_util.tree_map(np.asarray, unfreeze({"params": params, "batch_stats": stats}))
    return from_jax.tsrn_tl_state_dict(v, srb_nums=2) if kind == "sr" else from_jax.crnn_state_dict(v)


def test_syn_trains_and_matches_jax(shared, syn_run):
    """Two ``--syn`` steps: collate_syn's batches (float32, 4 channels, no
    CTC labels) and the JAX step's losses, moments, statistics and
    parameters from the same weights, as the module docstring says."""
    root, dirs, crnn_path = shared
    port, init, steps, _ = syn_run
    assert len(steps) == 2 and port._state.step == 2
    args = jax_config.default_args(syn=True, **ARGS)
    cfg = jax_config.load_config()
    cfg.TRAIN.width, cfg.TRAIN.height, cfg.TRAIN.batch_size, cfg.TRAIN.compute_dtype = 2 * W, 2 * H, B, "fp32"
    sr_model = JaxTSRN_TL(scale_factor=2, width=2 * W, height=2 * H, stn=True, mask=True, srb_nums=2, hidden_units=8)
    stu_model = JaxCRNN(nclass=CTC_NUM_CLASSES)
    state = jax_create_train_state(jax.random.PRNGKey(0), sr_model, (), stu_model=stu_model, n_stu=1,
                                   teacher_variables=ti.import_crnn(ti.load_torch_state_dict(crnn_path)),
                                   sr_init_variables=ti.import_tsrn(init, srb_nums=2))
    jax_step = jax_make_train_step("tsrn_tl_cascade", JAX_ARCHS["tsrn_tl_cascade"], sr_model, stu_model, args, cfg,
                                   donate=False)
    for k, (batch, got, models) in enumerate(steps):
        assert batch["hr"].dtype == np.float32 and batch["hr"].shape == (B, 2 * H, 2 * W, 4)
        assert batch["lr"].shape == (B, H, W, 4)
        state, ref = jax_step(state, batch)
        assert sorted(got) == sorted(ref)
        for name in got:
            np.testing.assert_allclose(got[name], float(ref[name]), rtol=LOSS_RTOL[k], err_msg=f"step {k + 1} {name}")
        adam = state.opt_state[0]
        for kind, i, sd, moments in models:
            params = (state.sr_params if kind == "sr" else state.stu_params)[i]
            stats = (state.sr_stats if kind == "sr" else state.stu_stats)[i]
            ref_sd = _jax_to_sd(kind, params, stats)
            tracked = [n for n in moments if not PRE_BN_BIAS.search(n)]
            for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                ref_m = _jax_to_sd(kind, getattr(adam, moment)[kind][i], stats)
                err = _rel([(moments[n][key], ref_m[n]) for n in tracked])
                assert err <= MOMENT_RTOL[k], (kind, i, k, moment, err)
            running = [n for n in sd if "running" in n]
            assert _rel([(sd[n], ref_sd[n]) for n in running]) <= STATS_RTOL[k], (kind, i, k)
            for n in moments:
                reach = float((sd[n] - ref_sd[n]).abs().max())
                assert reach <= 2.5 * LR * (k + 1), (kind, i, k, n, reach)


def test_syn_validates_and_saves(shared, syn_run):
    """The ``--syn`` val at iteration 2 over the LMDB (collate_syn's batches,
    16 images), its ``eval/`` scalars and the checkpoint files."""
    root, _, _ = shared
    port, _, _, vals = syn_run
    (md,) = [v["syn"] for v in vals]
    assert md["images"] == len(SYN_SIZES) and 0 < md["psnr_avg"] < 100 and 0 < md["ssim_avg"] <= 1
    _check_files(root, "syn", port.ckpt_dir)


def _check_files(root, vis_dir, ckpt_dir):
    with open(root / "tensorboard" / vis_dir / "scalars.jsonl") as f:
        records = [json.loads(line) for line in f]
    name = [r["tag"] for r in records if r["tag"].startswith("eval/accuracy_")]
    assert len(name) == 1
    split = name[0][len("eval/accuracy_"):]
    assert {r["tag"] for r in records} >= {f"eval/{k}_{split}" for k in ("psnr_avg", "ssim_avg", "accuracy")}
    assert all(np.isfinite(r["value"]) for r in records)
    assert {"checkpoint_0.pth", "recognizer_0.pth", "opt_state.pth", "info.json"} <= set(os.listdir(ckpt_dir))
    with open(os.path.join(ckpt_dir, "info.json")) as f:
        assert json.load(f)["step"] == 2


@pytest.mark.parametrize("flag", ["mixed", "ic15sr"])
def test_flag_trains_and_validates_through_the_cli(shared, monkeypatch, flag):
    """``cli.main`` with the flag: 2 iterations (an epoch of the 16 train
    pairs), finite losses of the cascade, a val over the split (the IC15
    tree's test split of 6) and a save."""
    root, dirs, crnn_path = shared
    cfg = _config(root, dirs[flag], crnn_path)
    path = root / f"{flag}.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    monkeypatch.chdir(root)
    losses, vals, make, run_val = [], [], trainer.make_train_step, trainer.TextSR._run_val

    def recorded_make(*a, **k):
        step = make(*a, **k)

        def recorded(state, batch):
            metrics = step(state, batch)
            losses.append({n: float(v) for n, v in metrics.items()})
            return metrics

        return recorded

    monkeypatch.setattr(trainer, "make_train_step", recorded_make)
    monkeypatch.setattr(trainer.TextSR, "_run_val", lambda m, *a, **k: vals.append(run_val(m, *a, **k)) or vals[-1])
    state = cli.main(FLAGS + [f"--{flag}", "--vis_dir", flag, "--config", str(path)], device="cpu")
    assert state.step == 2 and len(losses) == 2
    assert all(sorted(m) == ["loss_distill", "loss_img", "loss_img_0", "loss_total"] for m in losses)
    assert all(np.isfinite(v) for m in losses for v in m.values())
    (md,) = [next(iter(v.values())) for v in vals]
    assert md["images"] == (6 if flag == "ic15sr" else 16) and np.isfinite(md["psnr_avg"])
    _check_files(root, flag, os.path.join(str(root / "ckpt"), flag))
