"""PyTorch/CUDA port of tpgsr_tpu for one NVIDIA Hopper (H100) card.

The JAX package ``tpgsr_tpu`` is the reference; this package imports torch,
numpy, PIL (the TextZoom data path, ``data/``) and PyYAML (``config``).
Modules are NCHW and carry the original TPGSR's
``state_dict`` keys; the public step functions keep the JAX package's NHWC
batch layouts so the two packages compare like with like.

Every entry point takes ``device=``; ``None`` means the CUDA card (see
``device.resolve_device``).  The one TPU kernel of the main path, the
bidirectional GRU recurrence, is the hand-written CUDA kernel in
``csrc/bigru_seq.cu`` and its backward in ``csrc/bigru_seq_bwd.cu``
(wrapper ``ops.gru_seq``).  ``python -m tpgsr_tpu_torch.cli`` runs
``main.py``'s command line through ``train.trainer.TextSR``.
"""
