"""Data parallelism of the port: one process a card over ``torch.distributed``
(``mesh``), BatchNorm over the global batch (``batchnorm``)."""

from tpgsr_tpu_torch.parallel.batchnorm import GlobalBatchNorm, globalize_batchnorm, plain_batchnorms
from tpgsr_tpu_torch.parallel.mesh import (average_gradients, barrier, gather_rows, init, is_primary, join_env,
                                           local_rows, n_ranks, pad_to_multiple, rank_and_world, rank_device,
                                           reduce_metrics, replicate, shutdown, spawn, under_torchrun)

__all__ = ["GlobalBatchNorm", "average_gradients", "barrier", "gather_rows", "globalize_batchnorm", "init",
           "is_primary", "join_env", "local_rows", "n_ranks", "pad_to_multiple", "plain_batchnorms",
           "rank_and_world", "rank_device", "reduce_metrics", "replicate", "shutdown", "spawn", "under_torchrun"]
