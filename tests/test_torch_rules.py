"""Rules of the port: it imports nothing of JAX or the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

from tpgsr_tpu_torch import device as port_device
from tpgsr_tpu_torch import cli, entry, profile_zoo
from tpgsr_tpu_torch.config import default_args, load_config
from tpgsr_tpu_torch.data.loader import make_loader
from tpgsr_tpu_torch.models.registry import NOT_PORTED, PORTED_ARCHS
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
    lambda: make_eval_step({"arch": "srcnn", "stu_iter": 1}),
    lambda: make_train_step({"arch": "rdn", "stu_iter": 1}),
    lambda: trainer.TextSR(load_config(), default_args(arch="tsrn_tl_cascade")),
    lambda: trainer.TextSR(load_config(), default_args(arch="srresnet_tl", stu_iter=3)),
    lambda: cli.main(["--arch", "tsrn_tl_cascade"]),
    lambda: cli.main(["--arch", "tsrn", "--STN", "--mask"]),
    lambda: profile_zoo.mission(["--arch", "rdn_tl", "--mask"]),
    lambda: trainer.eval_recognizer("ASTER", load_config()),
    lambda: trainer.eval_recognizer("MORAN", load_config()),
    lambda: trainer.TextSR(load_config(), default_args(arch="tsrn_tl_cascade", test=True, rec="aster")),
    lambda: cli.main(["--arch", "srcnn", "--go_test", "--test_model", "MORAN"]),
    lambda: port_device.resolve_device(),
    lambda: port_device.resolve_device("cuda:0"),
])
def test_entry_points_default_to_the_card(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_cpu_is_taken_only_when_asked():
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_the_zoo_is_the_jax_package_s():
    """The port's archs and the ones it raises for are the JAX package's, and
    the eight ported are the repo's train scripts' (train_*.sh)."""
    from tpgsr_tpu.models.registry import ARCHS

    assert sorted(PORTED_ARCHS + NOT_PORTED) == sorted(ARCHS)
    assert sorted(PORTED_ARCHS) == sorted(["tsrn_tl_cascade", "tsrn", "srcnn", "srcnn_tl", "srres", "srresnet_tl",
                                           "rdn", "rdn_tl", "tsrn_tl", "tsrn_tl_wmask", "textzoom_net", "vdsr",
                                           "vdsr_tl", "edsr", "lapsrn", "esrgan", "esrgan_tl", "bicubic"])
    assert sorted(NOT_PORTED) == ["sem_tsrn", "tsrn_c2f"]


def _entry_points():
    """What a run reaches an arch through: (name, call of the arch)."""
    from tpgsr_tpu_torch.models.registry import build_model
    from tpgsr_tpu_torch.train import step

    dicts = ({"STN": False, "mask": True, "srb": 2, "hd_u": 8}, {"scale_factor": 2, "width": 128, "height": 32})
    return {
        "check_ported": lambda a: trainer.check_ported(load_config(), default_args(arch=a), torch.device("cpu")),
        "TextSR": lambda a: trainer.TextSR(load_config(), default_args(arch=a), device="cpu"),
        "build_model": lambda a: build_model(a, *dicts),
        "train_wire_keys": lambda a: step.train_wire_keys(a),
        "make_train_step": lambda a: step.make_train_step({"arch": a}, device="cpu"),
        "make_eval_step": lambda a: step.make_eval_step({"arch": a}, device="cpu"),
    }


@pytest.mark.parametrize("entry", ["check_ported", "TextSR", "build_model", "train_wire_keys", "make_train_step",
                                   "make_eval_step"])
@pytest.mark.parametrize("arch", NOT_PORTED)
def test_check_ported_raises_for_each_arch_not_ported(arch, entry):
    """``check_ported`` (what ``TextSR`` runs first) raises
    ``NotImplementedError`` naming the arch and its ``ROADMAP.md`` item, as
    does every other way in to the arch."""
    with pytest.raises(NotImplementedError, match=rf"'{arch}'.*ROADMAP.md queue 1 item 7"):
        _entry_points()[entry](arch)


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_check_ported_accepts_each_ported_arch(arch):
    trainer.check_ported(load_config(), default_args(arch=arch, srb=6), torch.device("cpu"))


@pytest.mark.parametrize("arch", ["tsrn_tl_cascade", "srcnn"])
@pytest.mark.parametrize("over", [{"test": True, "rec": "aster"}, {"test": True, "rec": "moran"},
                                  {"test": True}, {"go_test": True, "test_model": "ASTER"},
                                  {"test_model": "MORAN"}],
                         ids=["test_aster", "test_moran", "test_rec_default", "go_test_aster", "val_moran"])
def test_check_ported_accepts_the_aster_and_moran_evals(arch, over):
    """``--test`` with ``--rec aster`` (the default) or ``moran``, and
    ``--test_model ASTER|MORAN`` for val and ``--go_test``, for the flagship
    and a plain arch."""
    trainer.check_ported(load_config(), default_args(arch=arch, **over), torch.device("cpu"))
