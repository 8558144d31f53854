"""Build and load the port's CUDA kernels (route (b): nvcc -> .so -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), under a file name keyed by a hash of the source and flags,
so an edited source is rebuilt and an unchanged one is reused; the
compiler's log (``-Xptxas -v``: registers, spills) is kept beside it.
Nothing is built when a module is imported: the CPU tests import every
module, and only the CUDA path of a wrapper calls ``load``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> List[Tuple[str, str]]:
    """Compile the named sources that are not built yet, all ``nvcc``
    processes started together.  Returns ``(name, compiler log)`` for each
    source compiled now; raises if any compilation fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, tmp, proc))
    logs, failed = [], []
    for name, target, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            target.with_suffix(".log").write_text(log)
            os.replace(tmp, target)
        else:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
        logs.append((name, log))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def build_log(name: str) -> str:
    """The compiler's log of the built ``csrc/<name>.cu``."""
    return _target(name).with_suffix(".log").read_text()


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib
