"""``python -m tpgsr_tpu_torch.accept_real``: the acceptance run on real data,
TextZoom's three test splits and the published checkpoints, on the card
(counterpart of tools/accept_real.py).

Given the easy/medium/hard LMDBs and the original's files (the TPGSR
generator ``model_best_0.pth`` and the eval recognizers ``crnn.pth``,
``aster_demo.pth.tar`` and ``moran_demo.pth``, interfaces/base.py:634-718), it

1. loads every file into its model through the port's own loaders and
   reports each ``[ok]``, ``[FAIL]`` or ``[skip]`` with the model's
   parameter count: the recognizers by
   ``checkpoint.load_recognizer_state_dict``, the generator's
   ``state_dict_G`` as ``--resume`` reads a file;
2. runs ``--go_test`` over the three splits through ``cli.main`` once for
   each recognizer asked for (``--test_model``; the reference's test_bible,
   interfaces/super_resolution.py:540-1347);
3. prints the accuracy table beside the paper's targets (BASELINE.md;
   arXiv:2106.15368, the CRNN rows) and each split's PSNR and SSIM, as
   the JAX tool prints them, and with ``--json`` writes the metric dicts.

Usage::

    python -m tpgsr_tpu_torch.accept_real --textzoom /data/TextZoom/test \\
        --ckpt /ckpts/model_best_0.pth --crnn /ckpts/crnn.pth \\
        --aster /ckpts/aster_demo.pth.tar --moran /ckpts/moran_demo.pth \\
        --recognizers crnn,aster,moran

``--textzoom`` is the directory that holds easy/medium/hard, or the TextZoom
root that holds test/easy and the rest.  The run is on the card;
``--device cpu`` runs it on the CPU.  ``--dry-run`` needs no file: it
renders three small splits with PIL, writes them with
``data.create_lmdb.create_paired_dataset`` in a temporary directory and
runs every step on them with drawn weights.

The packaged YAML's settings hold (``--config`` names another), with the
splits, the files, ``--batch`` and ``--workers`` over them; with
TRAIN.n_devices above 1 ``cli.main`` runs each pass on that many ranks,
rank 0 prints and writes, and the table is this process's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from tpgsr_tpu_torch import cli
from tpgsr_tpu_torch.charset import CTC_NUM_CLASSES, AsterInfo
from tpgsr_tpu_torch.config import default_args, load_config, registry_dicts
from tpgsr_tpu_torch.data.create_lmdb import create_paired_dataset, render_word
from tpgsr_tpu_torch.device import resolve_device
from tpgsr_tpu_torch.models import aster, moran
from tpgsr_tpu_torch.models.crnn import CRNN
from tpgsr_tpu_torch.models.registry import build_model
from tpgsr_tpu_torch.train.checkpoint import load_generator_state_dict, load_recognizer_state_dict
from tpgsr_tpu_torch.utils.cost import param_count

# Paper targets (BASELINE.md "Paper-sourced targets", approximate; re-verify
# against arXiv:2106.15368 before gating a release on them)
PAPER_TARGETS_CRNN = {
    "1-stage": {"easy": 0.61, "medium": 0.50, "hard": 0.37},
    "3-stage": {"easy": 0.63, "medium": 0.52, "hard": 0.39},
}

SPLITS = ("easy", "medium", "hard")
REC_KEY = {"crnn": "CRNN", "aster": "ASTER", "moran": "MORAN"}
# --dry-run: pairs a split, and the words they show
DRY_RUN_PAIRS = 6
DRY_RUN_WORDS = ("scene", "text", "zoom", "prior", "super", "res42")


def find_split_dirs(root: str) -> List[str]:
    """easy/medium/hard under ``root`` or under ``root``/test."""
    for base in (root, os.path.join(root, "test")):
        dirs = [os.path.join(base, s) for s in SPLITS]
        if all(os.path.isdir(d) for d in dirs):
            return dirs
    raise SystemExit(f"--textzoom: could not find easy/medium/hard under {root!r} "
                     f"(tried {root}/<split> and {root}/test/<split>)")


def check_import(label: str, path: str, load: Callable[[str], torch.nn.Module]) -> bool:
    """Load one file into its model; report it and never stop the run."""
    if not path:
        print(f"  [skip] {label}: no path given")
        return False
    if not os.path.exists(path):
        print(f"  [FAIL] {label}: {path} does not exist")
        return False
    try:
        n = param_count(load(path))
        print(f"  [ok]   {label}: {path} ({n:,} params)")
        return True
    except Exception as e:  # noqa: BLE001 -- reported, the run goes on
        print(f"  [FAIL] {label}: {path}: {type(e).__name__}: {e}")
        return False


def _recognizer(model: torch.nn.Module, constants: tuple = ()) -> Callable[[str], torch.nn.Module]:
    """Load a recognizer file into ``model``, strictly, without the entries
    the original keeps as buffers of constants (``trainer.eval_recognizer``)."""
    def load(path: str) -> torch.nn.Module:
        sd = load_recognizer_state_dict(path)
        model.load_state_dict({k: v for k, v in sd.items() if not k.startswith(constants)})
        return model
    return load


def _generator(ns, config) -> Callable[[str], torch.nn.Module]:
    def load(path: str) -> torch.nn.Module:
        model = build_model(ns.arch, *registry_dicts(config, default_args(STN=ns.stn, mask=ns.mask, srb=ns.srb)))[0]
        model.load_state_dict(load_generator_state_dict(path))
        return model
    return load


def report_imports(ns, config) -> None:
    print("checkpoint imports:")
    info = AsterInfo(config.TRAIN.voc_type)
    check_import("crnn", ns.crnn, _recognizer(CRNN(nclass=CTC_NUM_CLASSES)))
    check_import("aster", ns.aster, _recognizer(
        aster.RecognizerBuilder(info.rec_num_classes, info.char2id[info.EOS], max_len_labels=info.max_len),
        aster.ORIGINAL_CONSTANTS))
    check_import("moran", ns.moran, _recognizer(moran.MORAN(), moran.ORIGINAL_CONSTANTS))
    if ns.ckpt and os.path.isdir(ns.ckpt):
        print(f"  [info] generator: {ns.ckpt} (directory; loaded for each stage at init)")
    elif ns.ckpt:
        check_import("generator", ns.ckpt, _generator(ns, config))
    else:
        print("  [info] generator: none given; drawn weights (dry-run/plumbing mode)")


def go_test_config(ns, split_dirs: Sequence[str], path: str) -> str:
    """The YAML of the runs (JSON is YAML), written to ``path``: the packaged
    one (or ``--config``) with the splits, batch, workers and files."""
    config = load_config(ns.config)
    t = config.TRAIN
    t.batch_size = ns.batch
    if ns.workers is not None:
        t.workers = ns.workers
    t.VAL.val_data_dir = list(split_dirs)
    t.VAL.n_vis = 0
    for key, value in (("crnn_pretrained", ns.crnn), ("rec_pretrained", ns.aster), ("moran_pretrained", ns.moran)):
        if value:
            t.VAL[key] = value
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def go_test_argv(ns, rec: str, config_path: str) -> List[str]:
    """``main.py``'s flags of one ``--go_test`` pass with eval recognizer
    ``rec`` (the JAX tool's ``_run_go_test``: distillation, gradient prior,
    one shared SR model)."""
    argv = ["--arch", ns.arch, "--go_test", "--sr_share", "--stu_iter", str(ns.stu_iter), "--use_distill",
            "--gradient", "--test_model", REC_KEY[rec], "--srb", str(ns.srb), "--batch_size", str(ns.batch),
            "--vis_dir", ns.vis_dir, "--config", config_path]
    argv += ["--mask"] if ns.mask else []
    argv += ["--STN"] if ns.stn else []
    argv += ["--resume", ns.ckpt] if ns.ckpt else []
    return argv


def run_go_test(ns, split_dirs: Sequence[str], rec: str, device) -> Dict[str, Dict[str, float]]:
    """One ``--go_test`` pass with eval recognizer ``rec`` through
    ``cli.main``; {split: metric_dict}."""
    with tempfile.TemporaryDirectory(prefix="accept_real-") as tmp:
        config_path = go_test_config(ns, split_dirs, os.path.join(tmp, "accept_real.yaml"))
        return cli.main(go_test_argv(ns, rec, config_path), device=device)


def print_table(results: Dict[str, Dict[str, Dict[str, float]]], stages_label: str) -> None:
    """The accuracy table of ``results`` {rec: {split: metric_dict}}, the
    CRNN's cells beside the paper's targets, then each split's PSNR and SSIM
    from the last recognizer's pass."""
    tgt = PAPER_TARGETS_CRNN.get(stages_label, {})
    print("\n=== acceptance table (accuracy on SR output) ===")
    print(f"{'recognizer':<10}" + "".join(f"{s:>18}" for s in SPLITS) + f"{'avg':>10}")
    for rec, mds in results.items():
        cells, accs = [], []
        for s in SPLITS:
            md = mds.get(s) or mds.get(os.path.basename(s)) or {}
            a = float(md.get("accuracy", float("nan")))
            accs.append(a)
            cell = f"{a*100:6.2f}%"
            if rec == "crnn" and s in tgt:
                cell += f" (paper {tgt[s]*100:.0f}%)"
            cells.append(f"{cell:>18}")
        avg = sum(accs) / len(accs) if accs else float("nan")
        print(f"{rec:<10}" + "".join(cells) + f"{avg*100:9.2f}%")
    print("\npsnr/ssim (recognizer-independent; from the last recognizer pass):")
    last = next(reversed(results.values()))
    for s in SPLITS:
        md = last.get(s) or {}
        print(f"  {s:<8} psnr={float(md.get('psnr_avg', float('nan'))):6.2f} dB   "
              f"ssim={float(md.get('ssim_avg', float('nan'))):.4f}")
    print("\nPaper targets are approximate (BASELINE.md); PSNR ≈20–22 dB and "
          "SSIM ≈0.75–0.80 are the expected TSRN-family bands.")


def make_dry_run_splits(root: str) -> List[str]:
    """easy/medium/hard under ``root``: ``DRY_RUN_PAIRS`` rendered words
    each, HR 24 to 48 pixels high, the LR bicubic at half size."""
    dirs = []
    for i, s in enumerate(SPLITS):
        words = [DRY_RUN_WORDS[(i + j) % len(DRY_RUN_WORDS)] for j in range(DRY_RUN_PAIRS)]
        hr = [render_word(w, (4 * (24 + 4 * ((i + j) % 7)), 24 + 4 * ((i + j) % 7)), seed=100 * i + j)
              for j, w in enumerate(words)]
        d = os.path.join(root, s)
        create_paired_dataset(d, hr, words)
        dirs.append(d)
    return dirs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--textzoom", help="TextZoom test root (easy/medium/hard)")
    p.add_argument("--ckpt", default="", help="TPGSR generator checkpoint: the original's .pth file or a ckpt dir")
    p.add_argument("--crnn", default="", help="crnn.pth (teacher and CRNN eval)")
    p.add_argument("--aster", default="", help="aster_demo.pth.tar")
    p.add_argument("--moran", default="", help="moran_demo.pth")
    p.add_argument("--recognizers", default="crnn", help="comma list from crnn,aster,moran")
    p.add_argument("--arch", default="tsrn_tl_cascade")
    p.add_argument("--stu_iter", type=int, default=1)
    p.add_argument("--srb", type=int, default=5)
    p.add_argument("--batch", type=int, default=48)
    p.add_argument("--mask", action="store_true", default=True)
    p.add_argument("--no-mask", dest="mask", action="store_false")
    p.add_argument("--stn", action="store_true", default=True)
    p.add_argument("--vis_dir", default="accept_real")
    p.add_argument("--config", default=None, help="the YAML (the packaged one by default)")
    p.add_argument("--workers", type=int, default=None, help="loader workers (the YAML's by default)")
    p.add_argument("--device", default=None, help="'cpu' for the CPU; the card by default")
    p.add_argument("--dry-run", action="store_true", help="rendered splits and drawn weights; plumbing only")
    p.add_argument("--json", help="also write the raw metric dicts here")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, Dict[str, float]]]:
    """The run of ``argv``; returns {rec: {split: metric_dict}}."""
    ns = build_parser().parse_args(argv)
    device = resolve_device(ns.device)
    recs = [r.strip() for r in ns.recognizers.split(",") if r.strip()]
    bad = [r for r in recs if r not in REC_KEY]
    if bad:
        raise SystemExit(f"unknown recognizers {bad}; pick from {sorted(REC_KEY)}")

    with contextlib.ExitStack() as stack:
        if ns.dry_run:
            print("[dry-run] building three small TextZoom LMDBs from rendered words ...")
            split_dirs = make_dry_run_splits(stack.enter_context(tempfile.TemporaryDirectory(prefix="accept_dry_")))
            ns.batch = DRY_RUN_PAIRS
        elif not ns.textzoom:
            raise SystemExit("--textzoom is required (or use --dry-run)")
        else:
            split_dirs = find_split_dirs(ns.textzoom)
        report_imports(ns, load_config(ns.config))
        results = {}
        for rec in recs:
            print(f"\n--- go_test with eval recognizer {rec.upper()} ---")
            t0 = time.time()
            results[rec] = run_go_test(ns, split_dirs, rec, device)
            print(f"  ({time.time() - t0:.1f}s)")

    print_table(results, "3-stage" if ns.stu_iter >= 3 else "1-stage")
    if ns.json:
        with open(ns.json, "w") as f:
            json.dump({r: {s: dict(md) for s, md in mds.items()} for r, mds in results.items()}, f, indent=2,
                      default=float)
        print(f"raw metrics -> {ns.json}")
    return results


if __name__ == "__main__":
    main()
