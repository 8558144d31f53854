"""The slice as a whole: the port's acceptance run (``python -m
tpgsr_tpu_torch.accept_real``) on the CPU against the JAX package's
``tools/accept_real.py`` (loaded by path, unchanged), on the same LMDBs,
built by the port's ``create_paired_dataset`` from rendered words as
``--dry-run`` builds its splits (some words relabelled as the teacher reads
them), and the same files in the original's
layout (a ``crnn.pth`` and a ``model_best_0.pth`` with ``state_dict_G``,
drawn by the port).  CRNN scoring at ``--srb 2``: each split's metric dict
at the bounds of the other ``--go_test`` parity tests (accuracies equal,
PSNR and SSIM at 1e-4), and the table's text equal to the JAX tool's."""

import contextlib
import importlib.util
import io
import json
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_suite import port_test_module  # noqa: F401  (the run's compile cache, no TensorBoard)
from tpgsr_tpu_torch import accept_real, config
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES
from tpgsr_tpu_torch.data.create_lmdb import create_paired_dataset, render_word
from tpgsr_tpu_torch.data.datasets import TextZoomDataset
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.layers import init_torch_defaults_
from tpgsr_tpu_torch.models.registry import build_model
from tpgsr_tpu_torch.ops.ctc import decode_crnn
from tpgsr_tpu_torch.train import trainer
from tpgsr_tpu_torch.train.priors import parse_crnn_data
from tpgsr_tpu_torch.utils.cost import param_count

ROOT = Path(__file__).resolve().parent.parent
PSNR_SSIM_RTOL = 1e-4  # tests/test_torch_cli.py's --go_test bound
BATCH = 8
SIZES = (5, 8, 6)  # pairs of easy, medium, hard: a short batch and a full one
WORDS = ("scene", "text", "zoom", "prior", "super", "res42", "tpgsr", "crnn")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other port modules run: the suite's
    workers share the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tool():
    spec = importlib.util.spec_from_file_location("jax_accept_real_tool", ROOT / "tools" / "accept_real.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_splits(root: Path, labels=None):
    """easy/medium/hard of rendered words (HR 24 to 48 pixels high), by the
    port's ``create_paired_dataset``; ``labels`` replaces the words."""
    dirs = []
    for i, (split, n) in enumerate(zip(accept_real.SPLITS, SIZES)):
        hr = [render_word(WORDS[(i + j) % len(WORDS)], (4 * (24 + 4 * ((i + j) % 7)), 24 + 4 * ((i + j) % 7)),
                          seed=100 * i + j) for j in range(n)]
        words = labels[i] if labels else [WORDS[(i + j) % len(WORDS)] for j in range(n)]
        dirs.append(str(root / split))
        create_paired_dataset(dirs[-1], hr, words)
    return dirs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("accept")
    gen = torch.Generator().manual_seed(7)
    teacher = init_torch_defaults_(CRNN(nclass=CTC_NUM_CLASSES), gen)
    crnn_path = str(root / "crnn.pth")
    torch.save(teacher.state_dict(), crnn_path)
    a, cfg = config.registry_dicts(config.load_config(), config.default_args(STN=True, mask=True, srb=2))
    sr = init_torch_defaults_(build_model("tsrn_tl_cascade", a, cfg)[0], gen)
    ckpt_path = str(root / "model_best_0.pth")
    torch.save({"state_dict_G": sr.state_dict(), "info": {"arch": "tsrn_tl_cascade"}}, ckpt_path)

    # some words relabelled with what the teacher reads on the HR, so that
    # accuracies are not all 0
    dirs = _write_splits(root / "tz")
    labels = []
    teacher.eval()
    for i, d in enumerate(dirs):
        (loader,) = trainer.val_loaders([d], mask=True, batch_size=16, workers=0, device="cpu")
        batch = next(iter(loader))
        with torch.no_grad():
            reads = decode_crnn(teacher(parse_crnn_data(batch["hr"].float() / 255.0).permute(0, 3, 1, 2)))
        labels.append([r if (j + i) % 3 == 0 and r else w for j, (r, w) in enumerate(zip(reads, batch["labels"]))])
    dirs = _write_splits(root / "tz", labels)

    argv = ["--textzoom", str(root / "tz"), "--ckpt", ckpt_path, "--crnn", crnn_path, "--moran", crnn_path,
            "--aster", str(root / "no-such.pth.tar"), "--recognizers", "crnn", "--srb", "2", "--batch", str(BATCH),
            "--workers", "0", "--device", "cpu", "--json", str(root / "port.json")]
    out = io.StringIO()
    (root / "port").mkdir()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.chdir(root / "port")
        port = accept_real.main(argv)

    tool = _tool()
    ns = types.SimpleNamespace(arch="tsrn_tl_cascade", mask=True, stn=True, stu_iter=1, ckpt=ckpt_path, srb=2,
                               batch=BATCH, vis_dir="accept_real", crnn=crnn_path, aster="", moran="")
    (root / "jax").mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root / "jax")
        want = tool._run_go_test(ns, dirs, "crnn")
    return {"root": root, "port": port, "out": out.getvalue(), "jax": want, "tool": tool, "sr": sr,
            "teacher": teacher}


def test_accept_real_matches_the_jax_tool(runs):
    """Each split's metric dict equals the JAX tool's ``--go_test``'s
    (accuracies and counts exactly, PSNR and SSIM at 1e-4), some accuracy
    above 0; ``--json`` holds the returned dicts."""
    port, want = runs["port"]["crnn"], runs["jax"]
    assert list(port) == list(want) == list(accept_real.SPLITS)
    for split, md in want.items():
        assert sorted(port[split]) == sorted(md)
        for k, v in md.items():
            if k in ("psnr_avg", "ssim_avg"):
                np.testing.assert_allclose(port[split][k], v, rtol=PSNR_SSIM_RTOL, err_msg=f"{split} {k}")
            else:
                assert port[split][k] == v, f"{split} {k}"
    assert [port[s]["images"] for s in accept_real.SPLITS] == list(SIZES)
    assert max(md["accuracy_hr"] for md in port.values()) > 0
    with open(runs["root"] / "port.json") as f:
        assert json.load(f) == {"crnn": port}


def test_the_table_and_the_import_report(runs):
    """The port's table is the JAX tool's ``_print_table`` text for the same
    results, and the run printed it; each file is reported by its own
    loader with its model's parameter count, the wrong and the missing
    one as failures."""
    results = {"crnn": runs["port"]["crnn"], "aster": runs["jax"]}
    texts = []
    for print_table in (accept_real.print_table, runs["tool"]._print_table):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            print_table(results, "1-stage")
        texts.append(buf.getvalue())
    assert texts[0] == texts[1] and "(paper 61%)" in texts[0]
    out, root = runs["out"], runs["root"]
    assert os.path.isfile(root / "port" / "tensorboard" / "accept_real" / "scalars.jsonl")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        accept_real.print_table({"crnn": runs["port"]["crnn"]}, "1-stage")
    assert buf.getvalue() in out
    assert f"  [ok]   crnn: {root / 'crnn.pth'} ({param_count(runs['teacher']):,} params)" in out
    assert f"  [ok]   generator: {root / 'model_best_0.pth'} ({param_count(runs['sr']):,} params)" in out
    assert f"  [FAIL] aster: {root / 'no-such.pth.tar'} does not exist" in out
    assert f"  [FAIL] moran: {root / 'crnn.pth'}: RuntimeError" in out


def test_dry_run_splits_read_back(tmp_path):
    """``--dry-run``'s splits: easy/medium/hard of ``DRY_RUN_PAIRS`` rendered
    words each, found by ``find_split_dirs`` from the root or its parent's
    ``test``."""
    root = tmp_path / "test"
    dirs = accept_real.make_dry_run_splits(str(root))
    assert accept_real.find_split_dirs(str(root)) == accept_real.find_split_dirs(str(tmp_path)) == dirs
    for i, d in enumerate(dirs):
        ds = TextZoomDataset(d, voc_type="all")
        assert len(ds) == accept_real.DRY_RUN_PAIRS
        assert [ds[j][2] for j in range(len(ds))] == [accept_real.DRY_RUN_WORDS[(i + j) % 6] for j in range(len(ds))]
        assert ds[0][1].size == (ds[0][0].size[0] // 2, ds[0][0].size[1] // 2)
    with pytest.raises(SystemExit, match="could not find"):
        accept_real.find_split_dirs(str(tmp_path / "nowhere"))
