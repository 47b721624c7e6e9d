"""convtasnet_tpu_torch — the Conv-TasNet serving and training paths in
PyTorch, with the TCN block's forward and backward as hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``convtasnet_tpu`` (JAX on a TPU), which stays the reference.
The layout mirrors it (``ops/``, ``models/``, ``losses/``, ``data/``,
``infer/``, ``train/``, ``utils/``, ``cli.py``) and keeps its
channels-last tensors and parameter names. The configs are the JAX
package's own ``convtasnet_tpu.config`` (pure dataclasses), re-exported
here; nothing here imports jax.
"""

__version__ = "0.1.0"

from convtasnet_tpu.config import ConvTasNetConfig, SolverConfig  # noqa: F401
