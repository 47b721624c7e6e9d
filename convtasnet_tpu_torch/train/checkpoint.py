"""Self-describing inference packages.

Counterpart of ``convtasnet_tpu/train/checkpoint.py`` for serving: one
``torch.save`` file holding the JAX package's JSON metadata (format_version,
the model config, epoch, losses) and the model's state_dict, so
``separate`` rebuilds the model with no other config. Saves are atomic
(tmp + rename). The JAX package's msgpack ``.ckpt`` files are not read
here yet (ROADMAP queue A, "JAX-checkpoint reading").
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from convtasnet_tpu.config import ConvTasNetConfig

FORMAT = "convtasnet_tpu_torch"
JAX_MAGIC = b"CTTPU1\x00\x00"  # first bytes of a JAX package checkpoint


def save_inference_package(
    path: str,
    cfg: ConvTasNetConfig,
    state_dict: Dict[str, torch.Tensor],
    epoch: int = 0,
    tr_loss=None,
    cv_loss=None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write ``{format, meta (JSON), state_dict}`` to ``path`` atomically."""
    meta = {
        "format_version": 1,
        "model": cfg.to_dict(),
        "epoch": int(epoch),
        "tr_loss": [float(x) for x in (tr_loss or [])],
        "cv_loss": [float(x) for x in (cv_loss or [])],
        "extra": extra or {},
    }
    package = {
        "format": FORMAT,
        "meta": json.dumps(meta),
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(package, tmp)
    os.replace(tmp, path)


def load_params_for_inference(
        path: str, device="cpu") -> Tuple[ConvTasNetConfig,
                                          Dict[str, torch.Tensor]]:
    """-> (model config, state_dict on ``device``) for ``ConvTasNet``."""
    with open(path, "rb") as f:
        if f.read(len(JAX_MAGIC)) == JAX_MAGIC:
            raise NotImplementedError(
                f"{path} is a JAX package checkpoint; reading those needs "
                "flax/msgpack and is not ported yet (ROADMAP queue A, "
                "'JAX-checkpoint reading'). Convert it with "
                "models.jax_params.state_dict_from_jax and "
                "save_inference_package where JAX is installed.")
    package = torch.load(path, map_location=device, weights_only=True)
    if not isinstance(package, dict) or package.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} inference package: {path}")
    meta = json.loads(package["meta"])
    return ConvTasNetConfig.from_dict(meta["model"]), package["state_dict"]
