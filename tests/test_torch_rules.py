"""Rules of the port: it imports nothing of JAX or the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

from tpgsr_tpu_torch import device as port_device
from tpgsr_tpu_torch import cli, entry
from tpgsr_tpu_torch.config import default_args, load_config
from tpgsr_tpu_torch.data.loader import make_loader
from tpgsr_tpu_torch.train import trainer
from tpgsr_tpu_torch.train.step import make_eval_step, make_train_step

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "tpgsr_tpu")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((ROOT / "tpgsr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("call", [
    lambda: entry.flagship(),
    lambda: entry.flagship_train(),
    lambda: make_eval_step({"stu_iter": 1}),
    lambda: make_train_step({"stu_iter": 1}),
    lambda: make_loader(list(range(4)), 2, None),
    lambda: trainer.train_loader(["no-such-lmdb"]),
    lambda: trainer.val_loaders(["no-such-lmdb"]),
    lambda: trainer.TextSR(load_config(), default_args(arch="tsrn_tl_cascade")),
    lambda: cli.main(["--arch", "tsrn_tl_cascade"]),
    lambda: port_device.resolve_device(),
    lambda: port_device.resolve_device("cuda:0"),
])
def test_entry_points_default_to_the_card(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_cpu_is_taken_only_when_asked():
    assert port_device.resolve_device("cpu") == torch.device("cpu")
