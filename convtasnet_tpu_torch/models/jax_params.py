"""Weight bridge from the JAX package's flax variables to this package.

The JAX model keeps its weights as ``{'params': {...}, 'batch_stats':
{...}}`` nested dicts whose leaves have the same names and shapes as this
package's state_dict entries (``models/conv_tasnet.py``), so the bridge
joins the nested names with dots and copies each leaf. It reads the leaves
through numpy (a bfloat16 leaf, which ``train/flax_msgpack.py`` returns as
a torch tensor, through torch) and does not import jax.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet


def _flatten(tree: Mapping, prefix: str, out: Dict[str, Any]) -> None:
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            _flatten(value, name + ".", out)
        else:
            out[name] = value


def flatten_tree(tree: Mapping) -> Dict[str, Any]:
    """A nested dict's leaves under their dotted names (``a.b.c``)."""
    out: Dict[str, Any] = {}
    _flatten(tree, "", out)
    return out


def leaf_tensor(value) -> torch.Tensor:
    """A leaf (numpy array, scalar or torch tensor) as a float32 CPU
    tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu()
    return torch.from_numpy(np.array(value, dtype=np.float32))


def state_dict_from_jax(variables: Dict[str, Any],
                        cfg: ConvTasNetConfig) -> Dict[str, torch.Tensor]:
    """flax variables (leaves as numpy arrays, or anything ``np.asarray``
    takes) -> this package's ``ConvTasNet(cfg)`` state_dict, float32.

    Raises ``KeyError`` naming the missing or unexpected keys when the tree
    does not describe ``cfg``'s model.
    """
    leaves = flatten_tree(variables.get("params", {}))
    leaves.update(flatten_tree(variables.get("batch_stats", {})))
    sd = {k: leaf_tensor(v) for k, v in leaves.items()}
    want = ConvTasNet(cfg).state_dict()
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    if missing or unexpected:
        raise KeyError(f"flax variables do not match the config: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")
    for k, v in want.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(sd[k].shape)}, the config "
                             f"wants {tuple(v.shape)}")
    return sd
