"""Weight bridge from the JAX package's flax variables to this package.

The JAX model keeps its weights as ``{'params': {...}, 'batch_stats':
{...}}`` nested dicts whose leaves have the same names and shapes as this
package's state_dict entries (``models/conv_tasnet.py``), so the bridge
joins the nested names with dots and copies each leaf. It reads the leaves
through numpy and does not import jax.
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


def state_dict_from_jax(variables: Dict[str, Any],
                        cfg: ConvTasNetConfig) -> Dict[str, torch.Tensor]:
    """flax variables (leaves as numpy arrays, or anything ``np.asarray``
    takes) -> this package's ``ConvTasNet(cfg)`` state_dict, float32.

    Raises ``KeyError`` naming the missing or unexpected keys when the tree
    does not describe ``cfg``'s model.
    """
    leaves: Dict[str, Any] = {}
    _flatten(variables.get("params", {}), "", leaves)
    _flatten(variables.get("batch_stats", {}), "", leaves)
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in leaves.items()}
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
