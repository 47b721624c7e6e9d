"""convtasnet_tpu_torch — the Conv-TasNet serving path in PyTorch, with the
TCN block as a hand-written CUDA kernel for NVIDIA Hopper (sm_90a).

A port of ``convtasnet_tpu`` (JAX on a TPU), which stays the reference.
The layout mirrors it (``ops/``, ``models/``, ``data/``, ``infer/``,
``train/``, ``utils/``, ``cli.py``) and keeps its channels-last tensors and
parameter names. The model config is the JAX package's own
``convtasnet_tpu.config`` (pure dataclasses); nothing here imports jax.
"""

__version__ = "0.1.0"

from convtasnet_tpu.config import ConvTasNetConfig  # noqa: F401
