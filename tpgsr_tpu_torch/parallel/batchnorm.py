"""BatchNorm over the global batch of a process group (counterpart of the
global view that ``TorchBatchNorm``, tpgsr_tpu/models/layers.py:122-175,
gets from a batch-sharded array: its statistics cover every rank's rows).

``GlobalBatchNorm`` takes the place of each train-mode ``nn.BatchNorm1d``
/ ``nn.BatchNorm2d`` of a data-parallel run's trainable models
(``globalize_batchnorm``), with the same parameters, buffers and
``state_dict`` keys.  In train mode inside a group of several ranks it is
two-pass, as the JAX module (:158-167): the per-channel sums and the count
all-reduced, then the centred squares; statistics and normalization in
fp32 whatever the input's dtype (the bf16 rule of
tpgsr_tpu_torch/models/layers.py), the output cast back.  Running
statistics: momentum 0.1, eps 1e-5, the variance with Bessel's factor of
the global count.  Anywhere else (eval mode, a world of one) it is
``nn.BatchNorm2d``'s own forward, bit for bit.

``nn.SyncBatchNorm`` is not used: it rejects CPU tensors, where the tests
hold this module to ``nn.BatchNorm2d`` over the whole batch.

The gradient: the all-reduces are ``torch.distributed.nn.functional``'s,
whose backward sums the incoming gradients over the ranks.  Each rank's
loss is the mean over its rows, so the global loss is the ranks' mean,
L = (1/W) sum_r L_r.  On rank r the backward then gives x_r the gradient of
sum_r' L_r' = W L (its own rows' direct term plus every rank's term through
the shared statistics), and each parameter's gradients summed over the
ranks make W dL/dtheta; the step's gradient mean (``mesh.average_gradients``)
divides by W, so the factor is 1 and nothing else rescales.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn as nn
from torch.nn.modules.batchnorm import _BatchNorm


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class GlobalBatchNorm(_BatchNorm):
    """``nn.BatchNorm1d``/``2d`` whose train-mode statistics cover the
    global batch; [N, C], [N, C, L] or [N, C, H, W]."""

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 3, 4):
            raise ValueError(f"expected a 2D, 3D or 4D input, got {x.dim()}D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or _world() == 1:
            return super().forward(x)
        self._check_input_dim(x)
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        count = xf.new_full((1,), x.numel() // x.shape[1])
        sums = dist_nn.all_reduce(torch.cat([xf.sum(dims), count]))
        n = sums[-1]
        mean = sums[:-1] / n
        centred = xf - mean.view(shape)
        var = dist_nn.all_reduce((centred * centred).sum(dims)) / n
        y = centred * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        if self.track_running_stats and self.running_mean is not None:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                f = 1.0 / float(self.num_batches_tracked) if self.momentum is None else self.momentum
                self.running_mean.mul_(1 - f).add_(mean.detach(), alpha=f)
                self.running_var.mul_(1 - f).add_((var * n / (n - 1)).detach(), alpha=f)
        return y.to(x.dtype)


def globalize_batchnorm(model: nn.Module) -> nn.Module:
    """Replace every ``nn.BatchNorm1d``/``2d`` of ``model`` in place by a
    ``GlobalBatchNorm`` that holds the same parameter and buffer tensors (an
    optimizer over them stays valid; the ``state_dict`` keeps its keys).
    Returns ``model``."""
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, (nn.BatchNorm1d, nn.BatchNorm2d)) and not isinstance(child, GlobalBatchNorm):
                bn = GlobalBatchNorm(child.num_features, child.eps, child.momentum, child.affine,
                                     child.track_running_stats, device="meta")
                for key, p in child.named_parameters(recurse=False):
                    setattr(bn, key, p)
                for key, b in child.named_buffers(recurse=False):
                    bn.register_buffer(key, b)
                bn.train(child.training)
                setattr(parent, name, bn)
    return model


def plain_batchnorms(models) -> list:
    """The names of the BatchNorm modules of ``models`` that are not
    ``GlobalBatchNorm``: in a data-parallel train step they would normalize
    each rank's rows alone."""
    return [f"{i}.{name}" for i, m in enumerate(models) for name, mod in m.named_modules()
            if isinstance(mod, _BatchNorm) and not isinstance(mod, GlobalBatchNorm)]
