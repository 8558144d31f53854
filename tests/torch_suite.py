"""What every port test module that runs the JAX package shares, to keep the
suite inside its time: imported by each ``tests/test_torch_*.py`` module
(``from tests.torch_suite import port_test_module  # noqa: F401``), whose
namespace then holds the autouse fixture below.

* **One compile of each XLA program for the whole run.**  Most of a port
  test's seconds are XLA compiling the JAX package's steps, ``TextSR``s
  and their initializers, and each module builds them anew (its own
  ``jit`` objects), so a program the suite compiles in several modules
  (the flagship's train and eval steps, the eager initializers of every
  ``TextSR``'s models) is compiled again in each.  While a port module runs,
  JAX's persistent compilation cache is on, in one directory for the whole
  run under pytest's base temporary directory, which every pytest-xdist
  worker of the run shares: a program another module or worker compiled
  is read back, bit for bit the executable a compile gives.  It is off
  again for the modules of the JAX package itself.
* **No TensorFlow import.**  ``torch.utils.tensorboard`` imports TensorFlow
  where it is installed, over 10 s of a CPU process's start.  The scalar
  loggers of both packages take their path without TensorBoard while a port
  module runs (both treat the package as optional); the tests read
  ``scalars.jsonl``, which they write either way.

Nothing here changes a test's inputs, steps, sizes or tolerances.  The card's
tests (tests/test_torch_kernels.py, run without JAX and without this
module's conftest) do not use it.
"""

import contextlib
import os
import sys

import pytest

# compiles shorter than this are not written to the cache (JAX's default)
MIN_COMPILE_SECONDS = 1.0


@contextlib.contextmanager
def persistent_compile_cache(path: str):
    """JAX's persistent compilation cache in ``path`` while the block runs;
    the previous setting (none, in this suite) after it."""
    import jax
    from jax._src import compilation_cache

    before = (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", MIN_COMPILE_SECONDS)
    compilation_cache.reset_cache()  # the cache reads its directory once
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", before[1])
        compilation_cache.reset_cache()


def run_cache_dir(tmp_path_factory) -> str:
    """The run's cache directory: under the base temporary directory that a
    pytest-xdist run's workers share (each worker's own base is one level
    below it), which pytest's retention of past runs removes in time."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / "jax-compile-cache"
    path.mkdir(exist_ok=True)
    return str(path)


@pytest.fixture(autouse=True, scope="module")
def port_test_module(tmp_path_factory):
    """The compile cache of the run and no TensorBoard, for one port module."""
    with persistent_compile_cache(run_cache_dir(tmp_path_factory)), pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # its import raises ImportError
        yield
