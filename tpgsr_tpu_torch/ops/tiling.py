"""Batch tiling: a per-sample function over a large batch, run tile by tile
(counterpart of tpgsr_tpu/ops/tiling.py).

The JAX package runs its eval step over tiles of ``TRAIN.eval_tile`` rows
(64 unless set) because XLA's TPU convolutions change layout at large
batch (tpgsr_tpu/ops/tiling.py).  On the H100 the flagship's batch 512
evaluates faster flat, so the port tiles only where ``TRAIN.eval_tile`` is
set: the tiles bound the eval step's memory to one tile's.  Each tile's
outputs are joined along their batch axis: every output of the eval step is
per-sample (eval mode couples no rows), so the joined result equals the
flat one up to the rounding of a convolution at another batch size.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

# the JAX package's default tile (64 divides every power-of-two batch >= 64);
# the port's eval step tiles only when told to
DEFAULT_TILE = 64


def _join(parts: list, batch_dim: Callable[[str], int], key: str = "") -> Any:
    """Tiles' outputs (tensors, or tuples, lists and mappings of them) joined
    along ``batch_dim(key)``, ``key`` the mapping key above a tensor."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, dim=batch_dim(key))
    if isinstance(first, Mapping):
        return {k: _join([p[k] for p in parts], batch_dim, k) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_join([p[i] for p in parts], batch_dim, key) for i in range(len(first)))
    raise TypeError(f"cannot join tiles of {type(first).__name__}")


def tiled_apply(fn: Callable, batch: Mapping[str, Any], tile: int = DEFAULT_TILE,
                batch_dim: Callable[[str], int] = lambda key: 0) -> Any:
    """``fn(batch)`` over row tiles of ``tile``: ``batch`` maps names to
    arrays or tensors with a leading batch axis of B rows (entries without a
    shape are dropped, as the JAX package drops them).  With ``tile`` set,
    B > tile and tile dividing B, ``fn`` runs on B / tile tiles in order and
    their outputs are joined, each along ``batch_dim`` of its mapping key;
    otherwise ``fn`` runs once on the whole batch."""
    arrays = {k: v for k, v in batch.items() if hasattr(v, "shape")}
    b = len(next(iter(arrays.values()))) if arrays else 0
    if not tile or b <= tile or b % tile:
        return fn(arrays)
    return _join([fn({k: v[i : i + tile] for k, v in arrays.items()}) for i in range(0, b, tile)], batch_dim)
