"""Model cost reports and profiling (counterpart of tpgsr_tpu/utils/cost.py;
the reference prints ptflops' MACs and parameters at model init,
interfaces/base.py:372-381, 638-643, 684-689).

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over one
forward pass: the convolutions and matrix products, each 2 FLOPs a
multiply-add.  K1's recurrence on the card is a CUDA kernel reached through
ctypes, which the counter cannot see, so each of its launches adds the
2·T·2N·3H·H FLOPs of its recurrent products (``gru_seq.LAUNCH_SHAPES``) at
the real hidden size H, and takes off what a padded H (``gru_seq.bigru``)
adds to the input projection the counter sees; on the CPU the plain
version runs those products as ``baddbmm``s at the real size, which the
counter counts, so the card and the CPU report the same number.

The count differs from the JAX package's by design: XLA's
``cost_analysis`` counts every operation of the compiled program,
elementwise work and reductions included, where ``FlopCounterMode`` counts
only the convolutions and matrix products.  The parameter counts agree.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Iterable, Tuple, Union

import torch
from torch.utils.flop_counter import FlopCounterMode

from tpgsr_tpu_torch.ops import gru_seq


def param_count(model: Union[torch.nn.Module, Iterable[torch.Tensor]]) -> int:
    """Elements of a module's parameters (its buffers, such as BatchNorm's
    running statistics, not counted), or of the tensors given."""
    params = model.parameters() if isinstance(model, torch.nn.Module) else model
    return sum(int(p.numel()) for p in params)


def recurrence_flops(n: int, t: int, h: int) -> int:
    """FLOPs of K1's recurrent products over one launch: both directions'
    h·W_hhᵀ ([N, H] x [H, 3H]) at each of T steps."""
    return 2 * t * 2 * n * 3 * h * h


def cost_analysis(fn: Callable, *example_args) -> Dict[str, float]:
    """Run ``fn(*example_args)`` once with gradients off and count its FLOPs:
    {"flops": the total, "k1_flops": the part added for K1's kernel launches
    (0 on the CPU, where the counter sees the plain recurrence's products)}."""
    counter = FlopCounterMode(display=False)
    gru_seq.LAUNCH_SHAPES = shapes = []
    try:
        with counter, torch.no_grad():
            fn(*example_args)
    finally:
        gru_seq.LAUNCH_SHAPES = None
    k1 = sum(recurrence_flops(n, t, h) for n, t, h, _ in shapes)
    padding = sum(extra for *_, extra in shapes)
    return {"flops": float(counter.get_total_flops() - padding + k1), "k1_flops": float(k1)}


def model_cost_report(model: torch.nn.Module, example_inputs: Tuple[torch.Tensor, ...],
                      name: str = "model") -> Dict[str, float]:
    """Print ``::::: <name>: <G> GFLOPs, <M> M params`` for ``model``'s eval
    forward on ``example_inputs`` (the JAX package's line) and return
    {"flops", "k1_flops", "params"}; the model's train or eval mode is
    restored after."""
    training = model.training
    model.eval()
    try:
        cost = cost_analysis(model, *example_inputs)
    finally:
        model.train(training)
    n_params = param_count(model)
    print(f"::::: {name}: {cost['flops'] / 1e9:.4f} GFLOPs, {n_params / 1e6:.4f} M params", flush=True)
    return {**cost, "params": float(n_params)}


@contextlib.contextmanager
def profile_trace(log_dir: str = "torch-trace"):
    """``torch.profiler`` over the block, the CPU's and (where there is one)
    the card's activity; the Chrome trace goes to ``<log_dir>/trace.json``
    (under the working directory by default).  Yields the profiler, whose
    ``key_averages()`` tabulates the time by operator."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
