"""Reference PyTorch checkpoints in and out of the port.

Counterpart of ``convtasnet_tpu/models/torch_import.py``. The reference
repo saves a self-describing "package" with ``torch.save``: the
hyperparameters N, L, B, H, P, X, R, C, norm_type, causal and
mask_nonlinear, the model's ``state_dict`` and its optimizer's. This
module turns such a package, or a bare reference-layout ``state_dict``,
into the port's state_dict (the JAX package's names and channels-last
shapes, ``models/conv_tasnet.py``), so a trained reference model such as
the published wsj0-2mix one serves on the card; and turns a TCN of the
port back into the reference layout.

Layout (torch ``[out, in, k]`` conv weights and ``[1, C, 1]`` norm affines
against the port's channels-last matmul weights and ``[C]`` vectors)::

    encoder.conv1d_U.weight          [N, 1, L]  encoder.w                 [L, N]
    decoder.basis_signals.weight     [L, N]     decoder.w                 [N, L]
    separator.network.0.{gamma,beta} [1, N, 1]  separator.input_norm.*    [N]
    separator.network.1.weight       [B, N, 1]  separator.bottleneck      [N, B]
    separator.network.2.<r>.<x>.net.0.weight    .block_r<r>_x<x>.conv1x1  [B, H]
      .net.1.weight (PReLU, [1])                .prelu1                   ()
      .net.2.{gamma,beta | weight,bias,         .norm1.{gamma,beta
              running_mean,running_var}                 | + mean, var}
      .net.3.net.0.weight          [H, 1, P]    .dwconv                   [P, H]
      .net.3.net.<k>.weight (PReLU)             .prelu2
      .net.3.net.<k+1>.*                        .norm2.*
      .net.3.net.<k+2>.weight      [B, H, 1]    .pwconv                   [H, B]
    separator.network.3.weight       [C*N, B, 1] separator.mask_conv      [B, C*N]

<k> is 2 for a non-causal block and 3 for a causal one, whose stack puts
a Chomp module before the PReLU. A ``module.`` prefix (a DataParallel
save) is stripped. BN's running statistics go to the port's ``mean`` and
``var`` buffers. The dual-path separator has no reference layout, so its
export raises.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Tuple

import numpy as np
import torch

from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax

HYPER_KEYS = ("N", "L", "B", "H", "P", "X", "R", "C", "norm_type", "causal",
              "mask_nonlinear")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().astype(np.float32)
    return np.asarray(t, np.float32)


def _norm_params(sd: Dict[str, Any], prefix: str, norm_type: str):
    """-> (params, running statistics or None) of one norm layer."""
    if norm_type in ("gLN", "cLN"):
        return ({"gamma": _np(sd[prefix + ".gamma"]).reshape(-1),
                 "beta": _np(sd[prefix + ".beta"]).reshape(-1)}, None)
    return ({"gamma": _np(sd[prefix + ".weight"]).reshape(-1),
             "beta": _np(sd[prefix + ".bias"]).reshape(-1)},
            {"mean": _np(sd[prefix + ".running_mean"]).reshape(-1),
             "var": _np(sd[prefix + ".running_var"]).reshape(-1)})


def _variables(sd: Dict[str, Any], cfg: ConvTasNetConfig) -> Dict[str, Any]:
    """Reference-layout state_dict -> the JAX package's nested variables."""
    params: Dict[str, Any] = {
        "encoder": {"w": _np(sd["encoder.conv1d_U.weight"])[:, 0, :].T},
        "decoder": {"w": _np(sd["decoder.basis_signals.weight"]).T}}
    sep: Dict[str, Any] = {
        "input_norm": _norm_params(sd, "separator.network.0", "cLN")[0],
        "bottleneck": _np(sd["separator.network.1.weight"])[:, :, 0].T,
        "mask_conv": _np(sd["separator.network.3.weight"])[:, :, 0].T}
    stats: Dict[str, Any] = {}
    k = 3 if cfg.causal else 2
    for r in range(cfg.num_repeats):
        for x in range(cfg.num_blocks):
            t = f"separator.network.2.{r}.{x}.net"
            name = f"block_r{r}_x{x}"
            norm1, stats1 = _norm_params(sd, f"{t}.2", cfg.norm_type)
            norm2, stats2 = _norm_params(sd, f"{t}.3.net.{k}", cfg.norm_type)
            sep[name] = {
                "conv1x1": _np(sd[f"{t}.0.weight"])[:, :, 0].T,
                "prelu1": _np(sd[f"{t}.1.weight"]).reshape(()),
                "norm1": norm1,
                "dwconv": _np(sd[f"{t}.3.net.0.weight"])[:, 0, :].T,
                "prelu2": _np(sd[f"{t}.3.net.{k - 1}.weight"]).reshape(()),
                "norm2": norm2,
                "pwconv": _np(sd[f"{t}.3.net.{k + 1}.weight"])[:, :, 0].T}
            if stats1 is not None:
                stats[name] = {"norm1": stats1, "norm2": stats2}
    params["separator"] = sep
    variables: Dict[str, Any] = {"params": params}
    if cfg.norm_type == "BN":
        variables["batch_stats"] = {"separator": stats}
    return variables


def convert_state_dict(sd: Dict[str, Any],
                       cfg: ConvTasNetConfig) -> Dict[str, torch.Tensor]:
    """Reference-layout torch ``state_dict`` -> the port's ``ConvTasNet(cfg)``
    state_dict (float32). Raises ``KeyError`` on a missing reference key or
    one the port's model lacks."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    return state_dict_from_jax(_variables(sd, cfg), cfg)


def load_torch_package(path: str) -> Tuple[ConvTasNetConfig,
                                           Dict[str, torch.Tensor]]:
    """A reference ``torch.save`` package -> (config, the port's
    state_dict). It is read with ``torch.load(weights_only=True)``; a
    package that needs unsafe unpickling raises and is not loaded another
    way."""
    try:
        package = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} needs unsafe unpickling (objects beyond tensors and "
            "plain containers); it is not loaded: re-save its hyperparameters "
            "and state_dict as plain values") from e
    if not isinstance(package, dict) or "state_dict" not in package:
        raise ValueError(f"{path} is not a reference package (no state_dict)")
    missing = [k for k in HYPER_KEYS if k not in package]
    if missing:
        raise ValueError(f"{path}: the package lacks the hyperparameters "
                         f"{missing}")
    cfg = ConvTasNetConfig(
        n_filters=int(package["N"]), kernel_size=int(package["L"]),
        bottleneck=int(package["B"]), hidden=int(package["H"]),
        conv_kernel=int(package["P"]), num_blocks=int(package["X"]),
        num_repeats=int(package["R"]), num_speakers=int(package["C"]),
        norm_type=str(package["norm_type"]), causal=bool(package["causal"]),
        mask_nonlinear=str(package["mask_nonlinear"]))
    return cfg, convert_state_dict(package["state_dict"], cfg)


def import_to_checkpoint(torch_path: str, out_path: str) -> ConvTasNetConfig:
    """A reference package -> the port's inference package at
    ``out_path`` (``extra={"imported_from": torch_path}``)."""
    from convtasnet_tpu_torch.train.checkpoint import save_inference_package

    cfg, sd = load_torch_package(torch_path)
    save_inference_package(out_path, cfg, sd, epoch=0,
                           extra={"imported_from": torch_path})
    return cfg


def export_state_dict(state_dict: Dict[str, torch.Tensor],
                      cfg: ConvTasNetConfig) -> Dict[str, torch.Tensor]:
    """The port's TCN state_dict -> the reference layout (the inverse of
    ``convert_state_dict``), for reference-compatible PyTorch tooling."""
    if cfg.separator != "tcn":
        raise ValueError(
            "torch export targets the reference TCN layout; the dual-path "
            "separator has no reference-side equivalent to export to")

    def t(name: str) -> torch.Tensor:
        return state_dict[name].detach().float().cpu()

    def c(x: torch.Tensor) -> torch.Tensor:
        return x.contiguous().clone()

    sd = {"encoder.conv1d_U.weight": c(t("encoder.w").T[:, None, :]),
          "decoder.basis_signals.weight": c(t("decoder.w").T)}
    for part in ("gamma", "beta"):
        sd[f"separator.network.0.{part}"] = c(
            t(f"separator.input_norm.{part}").reshape(1, -1, 1))
    sd["separator.network.1.weight"] = c(t("separator.bottleneck").T[:, :, None])
    sd["separator.network.3.weight"] = c(t("separator.mask_conv").T[:, :, None])

    def norm_entries(prefix: str, port: str) -> None:
        if cfg.norm_type in ("gLN", "cLN"):
            sd[prefix + ".gamma"] = c(t(port + ".gamma").reshape(1, -1, 1))
            sd[prefix + ".beta"] = c(t(port + ".beta").reshape(1, -1, 1))
            return
        sd[prefix + ".weight"] = c(t(port + ".gamma"))
        sd[prefix + ".bias"] = c(t(port + ".beta"))
        sd[prefix + ".running_mean"] = c(t(port + ".mean"))
        sd[prefix + ".running_var"] = c(t(port + ".var"))
        sd[prefix + ".num_batches_tracked"] = torch.tensor(0)

    k = 3 if cfg.causal else 2
    for r in range(cfg.num_repeats):
        for x in range(cfg.num_blocks):
            blk = f"separator.block_r{r}_x{x}"
            pre = f"separator.network.2.{r}.{x}.net"
            sd[f"{pre}.0.weight"] = c(t(f"{blk}.conv1x1").T[:, :, None])
            sd[f"{pre}.1.weight"] = c(t(f"{blk}.prelu1").reshape(1))
            norm_entries(f"{pre}.2", f"{blk}.norm1")
            sd[f"{pre}.3.net.0.weight"] = c(t(f"{blk}.dwconv").T[:, None, :])
            sd[f"{pre}.3.net.{k - 1}.weight"] = c(
                t(f"{blk}.prelu2").reshape(1))
            norm_entries(f"{pre}.3.net.{k}", f"{blk}.norm2")
            sd[f"{pre}.3.net.{k + 1}.weight"] = c(
                t(f"{blk}.pwconv").T[:, :, None])
    return sd


def export_to_torch(ckpt_path: str, out_path: str) -> None:
    """The port's package or checkpoint, or a JAX ``.ckpt`` -> a
    reference-style ``torch.save`` package (its hyperparameter keys, the
    state_dict, an empty ``optim_dict`` and the epoch)."""
    from convtasnet_tpu_torch.train.checkpoint import (
        load_checkpoint,
        params_from_package,
    )

    package, meta = load_checkpoint(ckpt_path)
    cfg, state_dict = params_from_package(package, meta)
    package = {
        "N": cfg.n_filters, "L": cfg.kernel_size, "B": cfg.bottleneck,
        "H": cfg.hidden, "P": cfg.conv_kernel, "X": cfg.num_blocks,
        "R": cfg.num_repeats, "C": cfg.num_speakers,
        "norm_type": cfg.norm_type, "causal": cfg.causal,
        "mask_nonlinear": cfg.mask_nonlinear,
        "state_dict": export_state_dict(state_dict, cfg),
        "optim_dict": {}, "epoch": meta.get("epoch", 0),
    }
    torch.save(package, out_path)
