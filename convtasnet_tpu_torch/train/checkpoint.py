"""Self-describing packages: inference packages and training checkpoints.

Counterpart of ``convtasnet_tpu/train/checkpoint.py``: one ``torch.save``
file holding the JAX package's JSON metadata (format_version, the model
config, epoch, the loss history, ``extra``) and the model's state_dict, so
``separate`` rebuilds the model with no other config. A training
checkpoint adds the optimizer's state and the step count, and
``load_params_for_inference`` reads it as it reads an inference package.
Saves are atomic (tmp + rename), so a preempted write never corrupts the
previous file. The JAX package's msgpack ``.ckpt`` files are not read here
yet (ROADMAP queue A, "JAX-checkpoint reading").
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from convtasnet_tpu_torch.config import ConvTasNetConfig

FORMAT = "convtasnet_tpu_torch"
JAX_MAGIC = b"CTTPU1\x00\x00"  # first bytes of a JAX package checkpoint


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _write(path: str, cfg: ConvTasNetConfig,
           state_dict: Dict[str, torch.Tensor], epoch: int, tr_loss,
           cv_loss, extra: Optional[Dict[str, Any]], **more) -> None:
    meta = {
        "format_version": 1,
        "model": cfg.to_dict(),
        "epoch": int(epoch),
        "tr_loss": [float(x) for x in (tr_loss or [])],
        "cv_loss": [float(x) for x in (cv_loss or [])],
        "extra": extra or {},
    }
    package = {"format": FORMAT, "meta": json.dumps(meta),
               "state_dict": _to_cpu(dict(state_dict)), **_to_cpu(more)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(package, tmp)
    os.replace(tmp, path)


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
    _write(path, cfg, state_dict, epoch, tr_loss, cv_loss, extra)


def save_checkpoint(path: str, state, model_cfg: ConvTasNetConfig,
                    epoch: int, tr_loss=None, cv_loss=None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """A training checkpoint of ``state`` (``train_step.TrainState``): the
    inference package plus ``optimizer`` (its state_dict) and ``step``."""
    _write(path, model_cfg, state.model.state_dict(), epoch, tr_loss,
           cv_loss, extra, optimizer=state.optimizer.state_dict(),
           step=int(state.step))


def load_checkpoint(path: str, device="cpu"
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """-> (package, meta); the package's tensors on ``device``."""
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
        raise ValueError(f"not a {FORMAT} inference package or checkpoint: "
                         f"{path}")
    return package, json.loads(package["meta"])


def restore_state(state, package: Dict[str, Any]):
    """Load a training checkpoint's model, optimizer and step into
    ``state``; returns it."""
    state.model.load_state_dict(package["state_dict"])
    state.optimizer.load_state_dict(package["optimizer"])
    state.step = int(package["step"])
    return state


def load_params_for_inference(
        path: str, device="cpu") -> Tuple[ConvTasNetConfig,
                                          Dict[str, torch.Tensor]]:
    """-> (model config, state_dict on ``device``) for ``ConvTasNet``, from
    an inference package or a training checkpoint."""
    package, meta = load_checkpoint(path, device)
    return ConvTasNetConfig.from_dict(meta["model"]), package["state_dict"]
