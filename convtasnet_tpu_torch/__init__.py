"""convtasnet_tpu_torch — Conv-TasNet in PyTorch: the TCN serving and
training paths and the dual-path (DPT) serving path, with the TCN block's
forward and backward and the DPT sublayer forwards as hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``convtasnet_tpu`` (JAX on a TPU), which stays the reference.
The layout mirrors it (``ops/``, ``models/``, ``losses/``, ``data/``,
``infer/``, ``train/``, ``utils/``, ``cli.py``) and keeps its
channels-last tensors and parameter names. ``config.py`` is the port's own
copy of the reference's configuration dataclasses, re-exported here;
nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"

from convtasnet_tpu_torch.config import ConvTasNetConfig, SolverConfig  # noqa: F401
