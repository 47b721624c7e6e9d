"""Whether a configuration's blocks and sublayers run the CUDA kernels.

Each kernel's rule is a pure function of the widths beside its wrapper
(``shape_refusal`` in ``tcn_block.py``, ``tcn_block_pair.py``,
``tcn_block_tp.py``, ``dpt_attention.py``, ``dpt_intra.py``,
``dpt_ffn.py``), which the wrapper raises on a CUDA tensor. Here the rules
are applied to a ``ConvTasNetConfig`` (and m shards), so that a model
whose kernels are in use (``use_pallas=None`` on a CUDA device, or
``True``) refuses, before it launches anything, a configuration whose
widths some kernel does not take: one error names every refused kind and
the rule it breaks. Such a configuration runs the plain ops only where the
caller asks for them (``use_pallas=False``); nothing routes a block around
its kernel on the card.

The kinds: ``"block"`` (a TCN block: B1, and B2 or B3 in training),
``"pair"`` (a TCN block pair: B4, B5, with ``CONVTASNET_PAIR_FUSION=1``),
``"stage2"`` (TP stage 2 of a gLN block over m shards: B6), and the DPT's
``"intra"`` (B9, B10), ``"inter"`` (B7, B8) and ``"ffn"`` (B11, B12),
in partial mode over m > 1 shards.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.ops.cuda import (
    dpt_attention,
    dpt_ffn,
    dpt_intra,
    tcn_block,
    tcn_block_pair,
    tcn_block_tp,
)

LABELS = {"block": "TCN blocks (B1-B3)", "pair": "TCN block pairs (B4, B5)",
          "stage2": "TP stage 2 (B6)",
          "intra": "DPT intra-chunk attention (B9, B10)",
          "inter": "DPT inter-chunk attention (B7, B8)",
          "ffn": "DPT FFN (B11, B12)"}


def refusals(cfg: ConvTasNetConfig, n_model: int = 1,
             pairs: bool = False) -> Dict[str, str]:
    """The kinds of block or sublayer the configuration runs through the
    kernels over ``n_model`` shards whose kernels refuse its widths, each
    with the rule it breaks. ``pairs``: the TCN runs blocks as pairs
    (``pair_fusion_enabled()``), so the pair kernels' rule applies too."""
    out: Dict[str, Optional[str]] = {}
    B, P, causal = cfg.bottleneck, cfg.conv_kernel, cfg.causal
    if cfg.separator == "dpt":
        m, h = n_model, cfg.dpt_num_heads
        if h % m or B % m:
            fits = dpt_attention.fitting_shards(B, h)
            out["intra"] = out["inter"] = (
                f"the partial kernels need a shard count m that divides the "
                f"{h} heads and B={B}, got m={m}; shard counts that fit: "
                f"{fits}")
        else:
            Bq, heads, S = B // m, h // m, cfg.dpt_chunk
            out["intra"] = dpt_intra.shape_refusal(B, S, Bq, heads,
                                                   cfg.compute_dtype)
            out["inter"] = dpt_attention.shape_refusal(
                "inter", B, S, Bq, heads, cfg.compute_dtype)
        out["ffn"] = dpt_ffn.shape_refusal(B)
    elif n_model > 1:
        if cfg.norm_type == "gLN":
            out["stage2"] = tcn_block_tp.shape_refusal(
                cfg.hidden // n_model, B, P, causal)
    else:
        out["block"] = tcn_block.shape_refusal(B, cfg.hidden, P, causal)
        if pairs and cfg.norm_type in ("gLN", "cLN"):
            out["pair"] = tcn_block_pair.shape_refusal(B, cfg.hidden, P,
                                                       causal)
    return {k: v for k, v in out.items() if v}


def refusal_message(refused: Dict[str, str]) -> str:
    """The error that names each refused kind and the rule it breaks."""
    return ("the CUDA kernels do not take this configuration (use_pallas="
            "False runs the plain ops): " + "; ".join(
                f"{LABELS[k]}: {refused[k]}" for k in sorted(refused)))


def use_kernels(cfg: ConvTasNetConfig, use_pallas: Optional[bool],
                device: torch.device, n_model: int = 1,
                pairs: bool = False) -> bool:
    """Whether a forward on inputs on ``device`` runs the CUDA kernels:
    ``use_pallas`` as the model's (None: on a CUDA device; True, or None
    with ``cfg.use_pallas``: always; False: never). With the kernels in
    use, raises if any refuses the configuration's widths (``refusals``),
    and then if the inputs are not on a CUDA device."""
    if use_pallas is None and cfg.use_pallas:
        use_pallas = True
    on_cuda = device.type == "cuda"
    if not (on_cuda if use_pallas is None else use_pallas):
        return False
    refused = refusals(cfg, n_model, pairs)
    if refused:
        raise ValueError(refusal_message(refused))
    if not on_cuda:
        raise ValueError("use_pallas=True runs the CUDA kernels and needs "
                         f"CUDA tensors; the mixture is on {device}")
    return True
