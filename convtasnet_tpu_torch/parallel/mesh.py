"""Where the shards of a tensor-parallel model run.

Counterpart of ``convtasnet_tpu/parallel/mesh.py::make_mesh`` for the
model axis. The port is single-controller, as the JAX package is: one
process drives a list of shard devices, shard s of the hidden width on
``devices[s]``. Shards wrap round the visible cards, so one card runs all
m shards in turn, the counterpart of the virtual CPU devices JAX's tests
use: a way to run the sharded program, not a faster one. Data parallelism
(the JAX mesh's data axis, ROADMAP A8c) is not ported; the data axis is 1.
"""

from __future__ import annotations

from typing import List

import torch


def shard_devices(n_model: int, device="cuda") -> List[torch.device]:
    """The devices of ``n_model`` shards: ``cuda:(s mod visible cards)``
    for shard s on a CUDA ``device``, ``device`` itself for every shard
    otherwise."""
    if n_model < 1:
        raise ValueError(f"n_model must be at least 1, got {n_model}")
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_model
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run the shards on the CPU")
    return [torch.device("cuda", s % n_cards) for s in range(n_model)]


def describe_placement(devices: List[torch.device]) -> str:
    """One line naming each shard's device."""
    where = ", ".join(f"shard {s} on {d}" for s, d in enumerate(devices))
    return f"tensor parallel over {len(devices)} shards: {where}"
