"""``TextSR`` data-parallel through ``tpgsr_tpu_torch.cli.main`` on the CPU,
two gloo ranks, by each launch route: TRAIN.n_devices 2 (``main`` spawns the
ranks) and torchrun's environment (each process joins the group).  Held to
the one-process run of the same command: the checkpoint's files and keys,
the parameters within Adam's reach, the val's metric dicts, and rank 0 the
only rank that writes.

Sizes are tests/test_torch_train.py's (2 SRBs, hidden 8, LR 16x32 -> HR
32x64, STN, mask, fp32) over an 8-pair LMDB of
``tests.fixtures.make_textzoom_lmdb``, global batch 8 (four rows a rank),
two epochs of one iteration, a val and a save at the second."""

import json
import multiprocessing
import os

import numpy as np
import pytest
import torch
import yaml

from tests import torch_parallel as tp
from tests.fixtures import make_textzoom_lmdb
from tests.test_torch_train import LR, STATS_RTOL, _rel
from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu_torch import cli, config
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_

B = 8
FLAGS = ["--arch", "tsrn_tl_cascade", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
         "--stu_iter=1", "--srb", "2", "--hd_u", "8", "--batch_size", str(B), "--vis_dir", "dp"]
GROUP_TIMEOUT_S = 120
# a save's files (the random weights read no word, so no val is a best)
SAVED = ["checkpoint_0.pth", "info.json", "opt_state.pth", "recognizer_0.pth"]
# the val after two steps reads BatchNorm statistics that the two runs
# moved by sums in other orders (tests/test_torch_train.py holds them at
# 2e-3 a model after two steps; measured here: SSIM 1.8e-4 apart): PSNR and
# SSIM at tests/test_torch_trainer.py's 1e-2 for a val after updates
VAL_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _one_thread_a_rank(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _yaml(path, db, teacher, ckpt_dir, n_devices):
    cfg = config.load_config()
    t = cfg.TRAIN
    t.train_data_dir, t.VAL.val_data_dir = [db], [db]
    t.width, t.height, t.epochs, t.compute_dtype, t.workers, t.n_devices = 64, 32, 2, "fp32", 0, n_devices
    t.VAL.valInterval, t.saveInterval, t.displayInterval = 2, 2, 1
    t.VAL.crnn_pretrained, t.ckpt_dir = teacher, str(ckpt_dir)
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return str(path)


def _scalars(workdir):
    with open(os.path.join(workdir, "tensorboard", "dp", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same training run (2 iterations, a val and a save at the second)
    with TRAIN.n_devices 2 and 1, each in its own working directory."""
    root = tmp_path_factory.mktemp("dp")
    teacher = str(root / "crnn.pth")
    torch.save(init_torch_defaults_(CRNN(nclass=CTC_NUM_CLASSES), torch.Generator().manual_seed(7)).state_dict(),
               teacher)
    db = make_textzoom_lmdb(str(root / "tz"), n=B)
    out = {"root": root, "db": db, "teacher": teacher}
    for n in (2, 1):
        work = root / f"n{n}"
        work.mkdir()
        argv = FLAGS + ["--config", _yaml(root / f"n{n}.yaml", db, teacher, work / "ckpt", n)]
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(work)
            state = cli.main(argv, device="cpu")
        out[n] = {"work": str(work), "state": state, "scalars": _scalars(work)}
    return out


def test_n_devices_two_trains_as_one_process_and_rank_zero_writes(runs):
    """``cli.main`` with TRAIN.n_devices 2 runs two ranks and returns rank 0's
    state on the CPU: two steps taken, the checkpoint's files and keys those
    of the one-process run, every parameter within 2.5 lr a step of it, the
    BatchNorm statistics at 2e-3 a model (relative L2;
    tests/test_torch_train.py's bounds after two steps); the
    scalar log's tags and steps the one-process run's, each once (a second
    writer would repeat them), its losses at rtol 1e-4 and its val's PSNR
    and SSIM at 1e-2, the accuracies equal."""
    two, one = runs[2], runs[1]
    assert two["state"].step == one["state"].step == 2
    for n in (2, 1):
        assert sorted(os.listdir(os.path.join(runs[n]["work"], "ckpt", "dp"))) == SAVED
    for name in ("checkpoint_0.pth", "recognizer_0.pth"):
        got, want = (torch.load(os.path.join(r["work"], "ckpt", "dp", name), weights_only=True) for r in (two, one))
        got, want = (d["state_dict_G"] if "state_dict_G" in d else d for d in (got, want))
        assert list(got) == list(want)
        running = [k for k in want if "running" in k]
        assert _rel([(got[k], want[k]) for k in running]) <= STATS_RTOL[1], name
        for k in want:
            if k.endswith("num_batches_tracked"):
                assert int(got[k]) == int(want[k]) == 2
            elif k not in running:
                assert float((got[k] - want[k]).abs().max()) <= 2 * 2.5 * LR, (name, k)
    got, want = two["scalars"], one["scalars"]
    assert [(s["tag"], s["step"]) for s in got] == [(s["tag"], s["step"]) for s in want]
    assert len({(s["tag"], s["step"]) for s in got}) == len(got)
    for g, w in zip(got, want):
        if "accuracy" in g["tag"]:
            assert g["value"] == w["value"], g["tag"]
        else:
            np.testing.assert_allclose(g["value"], w["value"], rtol=VAL_RTOL if g["tag"].startswith("eval") else 1e-4,
                                       err_msg=g["tag"])


def test_torchrun_environment_joins_and_go_test_evaluates_as_one_process(runs, tmp_path, monkeypatch):
    """Two processes as torchrun starts them (RANK, LOCAL_RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT; rank 0 this one, rank 1 a spawned one; the
    group's store held here, at a port the OS gave it, as torchrun's agent
    holds it), each in its own working directory, run ``--go_test`` from the two-rank run's
    checkpoint: each joins the group and returns the one-process
    ``--go_test``'s metric dicts (accuracies and image counts equal, PSNR
    and SSIM at rtol 1e-6), and leaves it; rank 0 alone writes the scalar
    log and the visualizations, and rank 1's directory stays empty."""
    ckpt_dir = os.path.join(runs[2]["work"], "ckpt", "dp")
    cfg = _yaml(tmp_path / "go.yaml", runs["db"], runs["teacher"], tmp_path / "ckpt", 2)
    argv = FLAGS + ["--config", cfg, "--go_test", "--resume", ckpt_dir]
    dirs = [tmp_path / f"rank{r}" for r in range(2)]
    for d in dirs:
        d.mkdir()
    store = torch.distributed.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    port = store.port
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    other = ctx.Process(target=tp.torchrun_rank, args=(1, 2, port, str(dirs[1]), argv, results))
    other.start()
    try:
        with monkeypatch.context() as mp:
            for k, v in tp.torchrun_env(0, 2, port).items():
                mp.setenv(k, v)
            mp.chdir(dirs[0])
            got = {0: cli.main(argv, device="cpu")}
        assert not torch.distributed.is_initialized()
        rank, ok, value = results.get(timeout=GROUP_TIMEOUT_S)
        assert ok and rank == 1, value
        got[1] = value
    finally:
        other.join(timeout=30)
        if other.is_alive():
            other.kill()
            other.join()
        del store
    one_cfg = _yaml(tmp_path / "go1.yaml", runs["db"], runs["teacher"], tmp_path / "ckpt", 1)
    (tmp_path / "one").mkdir()
    with monkeypatch.context() as mp:
        mp.chdir(tmp_path / "one")
        want = cli.main(FLAGS + ["--config", one_cfg, "--go_test", "--resume", ckpt_dir], device="cpu")
    for rank in (0, 1):
        assert sorted(got[rank]) == sorted(want)
        for split, md in want.items():
            assert sorted(got[rank][split]) == sorted(md)
            for k, v in md.items():
                if k.startswith(("accuracy", "images")):
                    assert got[rank][split][k] == v, (rank, k)
                else:
                    np.testing.assert_allclose(got[rank][split][k], v, rtol=1e-6, err_msg=k)
    assert os.listdir(dirs[1]) == []
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(tmp_path / "one")) == ["demo", "display", "tensorboard"]
    for sub in ("demo", "display", "tensorboard"):
        assert (sorted(f for _, _, fs in os.walk(dirs[0] / sub) for f in fs)
                == sorted(f for _, _, fs in os.walk(tmp_path / "one" / sub) for f in fs))
