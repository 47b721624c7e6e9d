"""Self-describing packages: inference packages and training checkpoints.

Counterpart of ``convtasnet_tpu/train/checkpoint.py``: one ``torch.save``
file holding the JAX package's JSON metadata (format_version, the model
config, epoch, the loss history, ``extra``) and the model's state_dict, so
``separate`` rebuilds the model with no other config. A training
checkpoint adds the optimizer's state and the step count, and
``load_params_for_inference`` reads it as it reads an inference package.
Saves are atomic (tmp + rename), so a preempted write never corrupts the
previous file.

The JAX package's ``.ckpt`` files (``JAX_MAGIC``, a ``<Q`` length, the
JSON meta, then a flax msgpack payload) are read too, with the port's own
decoder (``train/flax_msgpack.py``; no flax or msgpack): ``separate`` and
``evaluate`` serve them (``load_params_for_inference`` maps ``params``
and ``batch_stats`` through ``models.jax_params.state_dict_from_jax``), and
a JAX training checkpoint resumes (``restore_state``): its step count, its
optimizer's moments (optax Adam's ``mu``/``nu``/``count``, SGD's momentum
``trace``) and its learning rate, which the solver may have halved. An
orbax checkpoint directory is refused, naming orbax.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
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
    """-> (package, meta); the package's tensors on ``device``. For a JAX
    ``.ckpt`` the package is the decoded flax tree (nested dicts of numpy
    arrays, ``is_jax_tree``)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint of the JAX package "
            "(or not a checkpoint). The port reads only single-file "
            "checkpoints; re-save it with the JAX package's msgpack backend "
            "(save_checkpoint(..., backend='msgpack')) where orbax is "
            "installed")
    with open(path, "rb") as f:
        if f.read(len(JAX_MAGIC)) == JAX_MAGIC:
            return _load_jax(path, f.read())
    package = torch.load(path, map_location=device, weights_only=True)
    if not isinstance(package, dict) or package.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} inference package or checkpoint: "
                         f"{path}")
    return package, json.loads(package["meta"])


def _load_jax(path: str, rest: bytes) -> Tuple[Dict[str, Any],
                                               Dict[str, Any]]:
    from convtasnet_tpu_torch.train.flax_msgpack import msgpack_restore

    head = len(JAX_MAGIC) + 8
    if len(rest) < 8:
        raise ValueError(f"{path}: JAX checkpoint truncated in its header "
                         f"(offset {len(JAX_MAGIC) + len(rest)})")
    (meta_len,) = struct.unpack("<Q", rest[:8])
    if 8 + meta_len > len(rest):
        raise ValueError(f"{path}: JAX checkpoint meta of {meta_len} bytes "
                         f"runs past the end of the file (offset {head})")
    meta = json.loads(rest[8:8 + meta_len].decode("utf-8"))
    try:
        tree = msgpack_restore(rest[8 + meta_len:], base=head + meta_len)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: the JAX checkpoint holds no params")
    return tree, meta


def is_jax_tree(package: Dict[str, Any]) -> bool:
    """Whether ``load_checkpoint`` read ``package`` from a JAX ``.ckpt``."""
    return package.get("format") != FORMAT


def _jax_variables(tree: Dict[str, Any]) -> Dict[str, Any]:
    variables = {"params": tree["params"]}
    if tree.get("batch_stats"):
        variables["batch_stats"] = tree["batch_stats"]
    return variables


def _jax_optimizer(inner: Dict[str, Any]) -> Tuple[str, Dict[str, Any]]:
    """(description, state) of the JAX optimizer: optax's chain of clip,
    [add_decayed_weights,] then Adam or SGD, whose state is the last."""
    base = inner[str(len(inner) - 1)]["0"]
    kind = ("adam" if "mu" in base else
            "sgd with momentum" if "trace" in base else "sgd")
    return kind + (" with l2" if len(inner) == 3 else ""), base


def _torch_optimizer(opt: torch.optim.Optimizer) -> str:
    group = opt.param_groups[0]
    if isinstance(opt, torch.optim.Adam):
        kind = "adam"
    else:
        kind = "sgd with momentum" if group.get("momentum") else "sgd"
    return kind + (" with l2" if group.get("weight_decay") else "")


def _restore_jax(state, tree: Dict[str, Any]):
    from convtasnet_tpu_torch.models.jax_params import (
        flatten_tree,
        leaf_tensor,
        state_dict_from_jax,
    )

    model = state.model
    model.load_state_dict(state_dict_from_jax(_jax_variables(tree),
                                              model.cfg))
    opt_state = tree.get("opt_state")
    if not opt_state:
        raise ValueError("the JAX checkpoint holds no optimizer state (an "
                         "inference checkpoint): it serves, but does not "
                         "resume training")
    have, base = _jax_optimizer(opt_state["inner_state"])
    want = _torch_optimizer(state.optimizer)
    if have != want:
        raise ValueError(f"the JAX checkpoint's optimizer is {have}; the "
                         f"solver's config asks for {want}")
    moments = {"mu": "exp_avg", "nu": "exp_avg_sq",
               "trace": "momentum_buffer"}
    flat = {torch_key: flatten_tree(base[jax_key])
            for jax_key, torch_key in moments.items() if jax_key in base}
    names = [name for name, _ in model.named_parameters()]
    for torch_key, leaves in flat.items():
        if set(leaves) != set(names):
            raise ValueError(
                f"the JAX optimizer state does not match the model: missing "
                f"{sorted(set(names) - set(leaves))[:5]}, unexpected "
                f"{sorted(set(leaves) - set(names))[:5]}")
    sd = state.optimizer.state_dict()
    order = sd["param_groups"][0]["params"]
    sd["state"] = {}
    for idx, name in zip(order, names):
        entry = {k: leaf_tensor(v[name]) for k, v in flat.items()}
        if "count" in base:
            entry["step"] = torch.tensor(float(base["count"]))
        if entry:
            sd["state"][idx] = entry
    lr = float(np.float32(opt_state["hyperparams"]["learning_rate"]))
    for group in sd["param_groups"]:
        group["lr"] = lr
    state.optimizer.load_state_dict(sd)
    state.step = int(tree["step"])
    return state


def restore_state(state, package: Dict[str, Any]):
    """Load a training checkpoint's model, optimizer and step into
    ``state``; returns it. A JAX training checkpoint's optimizer must be
    the one ``state``'s was built as (Adam or SGD, with momentum or
    without, with L2 or without): otherwise this raises, naming both."""
    if is_jax_tree(package):
        return _restore_jax(state, package)
    state.model.load_state_dict(package["state_dict"])
    state.optimizer.load_state_dict(package["optimizer"])
    state.step = int(package["step"])
    return state


def params_from_package(package: Dict[str, Any], meta: Dict[str, Any],
                        device="cpu") -> Tuple[ConvTasNetConfig,
                                               Dict[str, torch.Tensor]]:
    """(model config, state_dict on ``device``) of what ``load_checkpoint``
    returned."""
    cfg = ConvTasNetConfig.from_dict(meta["model"])
    if is_jax_tree(package):
        from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax

        sd = state_dict_from_jax(_jax_variables(package), cfg)
        return cfg, {k: v.to(device) for k, v in sd.items()}
    return cfg, package["state_dict"]


def load_params_for_inference(
        path: str, device="cpu") -> Tuple[ConvTasNetConfig,
                                          Dict[str, torch.Tensor]]:
    """-> (model config, state_dict on ``device``) for ``ConvTasNet``, from
    an inference package, a training checkpoint or a JAX ``.ckpt``."""
    return params_from_package(*load_checkpoint(path, device), device)
