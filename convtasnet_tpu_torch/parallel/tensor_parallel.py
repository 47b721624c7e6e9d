"""Tensor (channel) parallelism: the TCN's hidden width split over shards.

Counterpart of ``convtasnet_tpu/parallel/tensor_parallel.py``. The split
is the Megatron pattern on each TCN block:

- ``W_in [B, H]`` split by columns, so each shard computes its own
  ``Hs = H / m`` hidden channels;
- PReLU and the depthwise conv act per channel, so they stay on the shard,
  with the dwconv taps and the norms' gamma/beta (and BN statistics) split
  by channel;
- the norms' statistics reduce over the whole width: the shards' partial
  sums are summed (two scalars per sample for gLN, one row sum per frame
  for cLN);
- ``W_out [H, B]`` split by rows: the shards' partial products are summed
  before the residual add;
- everything on the B-wide path (residual stream, bottleneck, mask head,
  encoder and decoder, the input norm) and the PReLU slopes are
  replicated.

The port is single-controller (``parallel/mesh.py``): one process drives
the m shard devices. The replicated path runs once, on shard 0's device,
where JAX runs it on every device of the model axis, and each shard gets
its copy of the residual stream at each block. ``all_reduce`` is JAX's
``psum`` over the model axis: a sum in shard order on shard 0's device.
It is made of ``.to()`` and additions, so autograd sends each cotangent
back to every shard: the backward's collectives come without extra code.
The forward slices the canonical parameters (``shard_variables``) each
call, so autograd gives gradients, and the optimizer keeps its state, in
the canonical layout; checkpoints are unchanged.

gLN blocks run the stage-split decomposition (``_tp_forward_gln``, the
counterpart of ``_tp_shard_forward_gln``): stage 1, the summed gLN-1
statistics, stage 2 per shard (kernel B6, ``ops/cuda/tcn_block_tp.py``,
where the kernels are in use), one combined sum of (z, the gLN-2 sums,
g2 @ W_out, b2 @ W_out), the epilogue. cLN blocks, and BN blocks with
their running statistics, run the per-norm decomposition in plain ops
(``_tp_forward_generic``, the counterpart of ``_tp_shard_forward``), as
in JAX, whose B6 is gLN only. Every norm runs in the model's compute
dtype, as the unsharded model does (JAX's per-norm path keeps the
mixture's f32).

``tp_forward`` sends the dual-path family to ``dpt_tp.dpt_tp_forward``
(heads and FFN hidden width split, the partial kernels), as JAX's does;
the train and eval steps here run either family through ``tp_forward``.

Not ported (ROADMAP "Do not port"): the probe, race and degrade machinery
around the fused stage 2 (``ensure_probed_tcn_tp`` and the train step's
retrace on failure), since here B6 runs or raises, and the GSPMD entries
(``make_gspmd_forward``, ``demote_pallas_for_model_parallel``). Data
parallelism is ROADMAP A8c and raises.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import torch

from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.functional import (
    block_names,
    decode_frames,
    encode_frames,
    mask_from_scores,
    separator_forward,
)
from convtasnet_tpu_torch.ops.conv import depthwise_conv1d, pointwise_conv, prelu
from convtasnet_tpu_torch.ops.cuda import shapes
from convtasnet_tpu_torch.ops.cuda.tcn_block_tp import (
    fused_tp_stage2,
    stats_from_sums,
    tp_epilogue,
    tp_stage1,
    tp_stage2_ad,
    tp_stage2_reference,
)
from convtasnet_tpu_torch.ops.frames import frame_signal, overlap_and_add
from convtasnet_tpu_torch.ops.norm import (
    EPS,
    batch_norm,
    channelwise_layer_norm,
)
from convtasnet_tpu_torch.train.train_step import (
    TrainState,
    _clip_by_global_norm,
    weighted_loss,
)

Variables = Mapping[str, torch.Tensor]


def param_shard_dims(cfg: ConvTasNetConfig) -> Dict[str, Optional[int]]:
    """The counterpart of ``param_partition_specs`` for the TCN: for each
    block leaf of the state_dict, the dimension split over the shards
    (None: replicated). Leaves not listed are replicated."""
    dims = {"conv1x1": 1, "dwconv": 1, "pwconv": 0,
            "prelu1": None, "prelu2": None}
    for norm in ("norm1", "norm2"):
        for leaf in ("gamma", "beta", "mean", "var"):
            dims[f"{norm}.{leaf}"] = 0
    return {f"separator.{name}.{leaf}": dim for name, _ in block_names(cfg)
            for leaf, dim in dims.items()}


def shard_variables(cfg: ConvTasNetConfig, variables: Variables,
                    devices: Sequence[torch.device]
                    ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Each shard's block leaves, ``[{block name: {leaf: tensor}}]``, cut
    from the canonical ``variables`` (a state_dict; its tensors may be
    Parameters) by ``param_shard_dims`` and moved to the shard's device.
    Slicing and ``.to()`` are differentiable, so gradients reach the
    canonical leaves."""
    m = len(devices)
    if cfg.hidden % m:
        raise ValueError(f"the hidden width H={cfg.hidden} does not split "
                         f"into {m} shards")
    hs = cfg.hidden // m
    dims = param_shard_dims(cfg)
    shards = []
    for s, dev in enumerate(devices):
        cut = slice(s * hs, (s + 1) * hs)
        blocks: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, dim in dims.items():
            if key not in variables:
                continue   # BN statistics exist only for BN
            t = variables[key]
            t = t[cut] if dim == 0 else t[:, cut] if dim == 1 else t
            _, name, leaf = key.split(".", 2)
            blocks.setdefault(name, {})[leaf] = t.to(dev)
        shards.append(blocks)
    return shards


def all_reduce(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' tensors summed in shard order, in f32, on shard 0's
    device, returned in their dtype (``psum`` over the model axis)."""
    dst = parts[0].device
    acc = parts[0].float()
    for t in parts[1:]:
        acc = acc + t.to(dst).float()
    return acc.to(parts[0].dtype)


def _cln_full(y: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor) -> torch.Tensor:
    """cLN over the full (replicated) channel axis, f32 statistics."""
    return channelwise_layer_norm(y.float(), gamma.float(),
                                  beta.float()).to(y.dtype)


def _norm_tp(hs: List[torch.Tensor], leaves: List[Dict[str, torch.Tensor]],
             norm: str, cfg: ConvTasNetConfig) -> List[torch.Tensor]:
    """One norm over the channel-split hidden width: ``hs[s]`` [M, K, Hs]
    on shard s's device, ``leaves[s]`` its block leaves, ``norm`` "norm1"
    or "norm2". gLN sums two scalars per sample over the shards, cLN a row
    sum per frame; BN (eval) uses each shard's slice of the running
    statistics."""
    hf = [h.float() for h in hs]
    g = [lv[f"{norm}.gamma"] for lv in leaves]
    b = [lv[f"{norm}.beta"] for lv in leaves]
    if cfg.norm_type == "BN":
        return [batch_norm(t, gi, bi, lv[f"{norm}.mean"],
                           lv[f"{norm}.var"]).to(h.dtype)
                for h, t, gi, bi, lv in zip(hs, hf, g, b, leaves)]
    gln = cfg.norm_type == "gLN"
    dims = (1, 2) if gln else (-1,)
    s1 = all_reduce([t.sum(dim=dims) for t in hf])
    s2 = all_reduce([(t * t).sum(dim=dims) for t in hf])
    n = (hf[0].shape[1] * hf[0].shape[2] if gln else hf[0].shape[-1]) * len(hf)
    mean = s1 / n
    rs = torch.rsqrt(s2 / n - mean * mean + EPS)
    mean, rs = (v[:, None, None] if gln else v[..., None] for v in (mean, rs))
    return [((t - mean.to(t.device)) * rs.to(t.device) * gi + bi).to(h.dtype)
            for h, t, gi, bi in zip(hs, hf, g, b)]


def _encode(cfg: ConvTasNetConfig, variables: Variables,
            mixture: torch.Tensor) -> torch.Tensor:
    x = mixture.to(getattr(torch, cfg.compute_dtype))
    return encode_frames({"w": variables["encoder.w"]},
                         frame_signal(x, cfg.kernel_size, cfg.stride))


def _decode(cfg: ConvTasNetConfig, variables: Variables, w: torch.Tensor,
            mask: torch.Tensor, T: int) -> torch.Tensor:
    out = overlap_and_add(decode_frames({"w": variables["decoder.w"]}, w,
                                        mask), cfg.stride)
    if out.shape[-1] < T:
        out = torch.nn.functional.pad(out, (0, T - out.shape[-1]))
    return out.float()


def _tp_forward_gln(cfg, variables, shards, devices, mixture, stage2):
    """The gLN decomposition (``_tp_shard_forward_gln``): per block,
    stage 1 on every shard, the gLN-1 partials summed, stage 2 on every
    shard (``stage2``: B6, its autograd Function or its twin), one
    combined sum of (z, the gLN-2 sums, g2 @ W_out, b2 @ W_out), the
    epilogue. Returns f32 [M, C, T]."""
    w = _encode(cfg, variables, mixture)
    y = _cln_full(w, variables["separator.input_norm.gamma"],
                  variables["separator.input_norm.beta"])
    y = pointwise_conv(y, variables["separator.bottleneck"].to(y.dtype))
    n = y.shape[1] * cfg.hidden
    for name, dilation in block_names(cfg):
        blks = [sh[name] for sh in shards]
        stage1 = [tp_stage1(y.to(dev), b["conv1x1"], b["prelu1"])
                  for b, dev in zip(blks, devices)]
        stats1 = stats_from_sums(all_reduce([s for _, s in stage1]), n)
        parts = []
        for (h, _), b, dev in zip(stage1, blks, devices):
            z, sums2 = stage2(
                h, stats1.to(dev), b["dwconv"], b["pwconv"], b["prelu2"],
                b["norm1.gamma"], b["norm1.beta"], b["norm2.gamma"],
                dilation=dilation, causal=cfg.causal)
            w_f = b["pwconv"].float()
            parts.append((z, sums2, b["norm2.gamma"].float() @ w_f,
                          b["norm2.beta"].float() @ w_f))
        z, sums2, w1, w0 = (all_reduce(col) for col in zip(*parts))
        y = tp_epilogue(y, z, stats_from_sums(sums2, n), w1, w0)
    score = pointwise_conv(y, variables["separator.mask_conv"].to(y.dtype))
    return _decode(cfg, variables, w, mask_from_scores(cfg, score),
                   mixture.shape[-1])


def _tp_forward_generic(cfg, variables, shards, devices, mixture):
    """The per-norm decomposition (``_tp_shard_forward``) for cLN and BN:
    each block as ``block_forward`` runs it, per shard, with the norms'
    statistics summed over the shards and the partial out products summed
    before the residual add. Plain ops. Returns f32 [M, C, T]."""

    def run_block(name: str, dilation: int, y: torch.Tensor) -> torch.Tensor:
        blks = [sh[name] for sh in shards]
        dt = y.dtype
        hs = [prelu(pointwise_conv(y.to(dev), b["conv1x1"].to(dt)),
                    b["prelu1"].to(dt)) for b, dev in zip(blks, devices)]
        hs = _norm_tp(hs, blks, "norm1", cfg)
        hs = [prelu(depthwise_conv1d(h, b["dwconv"].to(dt), dilation,
                                     cfg.causal), b["prelu2"].to(dt))
              for h, b in zip(hs, blks)]
        hs = _norm_tp(hs, blks, "norm2", cfg)
        return y + all_reduce([pointwise_conv(h, b["pwconv"].to(dt))
                               for h, b in zip(hs, blks)])

    w = _encode(cfg, variables, mixture)
    mask = separator_forward(
        cfg, {"bottleneck": variables["separator.bottleneck"],
              "mask_conv": variables["separator.mask_conv"]}, w,
        input_norm=lambda v: _cln_full(
            v, variables["separator.input_norm.gamma"],
            variables["separator.input_norm.beta"]),
        run_block=run_block)
    return _decode(cfg, variables, w, mask, mixture.shape[-1])


def tp_forward(cfg: ConvTasNetConfig, variables: Variables,
               mixture: torch.Tensor, devices: Sequence[torch.device],
               use_pallas: Optional[bool] = None) -> torch.Tensor:
    """The separator's forward with its hidden width (the TCN's) or its
    heads and FFN width (the dual-path family's, ``dpt_tp_forward``) split
    over ``devices`` (``mesh.shard_devices``): mixture [M, T] ->
    est_source [M, C, T] in f32 on shard 0's device, as ``ConvTasNet``
    returns it.

    ``variables`` is a state_dict of the canonical model (for training,
    ``model.state_dict(keep_vars=True)``). ``use_pallas`` as the model's:
    None runs the kernels (B6 for gLN; the DPT's partial kernels) for CUDA
    tensors, True (or None with ``cfg.use_pallas``) insists on them, False
    runs the plain ops. gLN with gradients runs B6 through
    ``tp_stage2_ad``.
    """
    if cfg.separator == "dpt":
        from convtasnet_tpu_torch.parallel.dpt_tp import dpt_tp_forward

        return dpt_tp_forward(cfg, variables, mixture, devices, use_pallas)
    if cfg.separator != "tcn":
        raise ValueError(f"unsupported separator family: {cfg.separator}")
    mixture = mixture.to(devices[0])
    use_kernel = shapes.use_kernels(cfg, use_pallas, mixture.device,
                                    len(devices))
    shards = shard_variables(cfg, variables, devices)
    if cfg.norm_type != "gLN":
        return _tp_forward_generic(cfg, variables, shards, devices, mixture)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in variables.values())
    stage2 = (tp_stage2_reference if not use_kernel
              else tp_stage2_ad if needs_grad else fused_tp_stage2)
    return _tp_forward_gln(cfg, variables, shards, devices, mixture, stage2)


def tp_loss_and_grads(cfg: ConvTasNetConfig, model: torch.nn.Module, batch,
                      devices: Sequence[torch.device]) -> torch.Tensor:
    """The loss of one batch through ``tp_forward`` with the model's
    canonical parameters, its gradients left in their ``.grad``
    (``train_step._loss_and_grads`` without chunking)."""
    model.zero_grad(set_to_none=True)
    est = tp_forward(cfg, model.state_dict(keep_vars=True), batch[0],
                     devices, use_pallas=model.use_pallas)
    loss = weighted_loss(est, batch)
    loss.backward()
    return loss.detach()


def make_tcn_tp_train_step(cfg: ConvTasNetConfig,
                           devices: Sequence[torch.device]):
    """The TCN's train step through ``tp_forward``
    (``make_tp_train_step``). gLN trains through ``tp_stage2_ad`` (B6
    forward) where the kernels are in use, cLN through the plain per-norm
    path. BN is refused, as in JAX: its running statistics are updated by
    the model's own forward. The dual-path family is refused too, as in
    JAX: it has ``dpt_tp.make_dpt_tp_train_step``."""
    if cfg.separator != "tcn":
        raise ValueError("make_tcn_tp_train_step is the TCN's; the dual-path "
                         "family has dpt_tp.make_dpt_tp_train_step")
    if cfg.norm_type == "BN":
        raise ValueError("BN running-stat updates are not supported by the "
                         "TP train step; use gLN/cLN or train on one shard")
    return make_tp_train_step(cfg, devices)


def make_tp_train_step(cfg: ConvTasNetConfig,
                       devices: Sequence[torch.device]):
    """The train step through ``tp_forward``, for either family:
    ``(state, batch) -> (state, {"loss", "grad_norm"})`` with
    ``train_step.make_train_step``'s contract (the same loss, clipping and
    optimizer), plus ``.multi``, several steps in turn with
    ``make_multi_train_step``'s contract. Parameters, gradients and
    optimizer state keep the canonical layout."""

    def step(state: TrainState, batch):
        model = state.model
        model.train()
        loss = tp_loss_and_grads(cfg, model, batch, devices)
        params = [p for p in model.parameters() if p.grad is not None]
        grad_norm = _clip_by_global_norm(params, state.max_grad_norm)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    def multi(state: TrainState, batches):
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in ("loss", "grad_norm")}

    step.multi = multi
    return step


def make_tp_eval_step(cfg: ConvTasNetConfig,
                      devices: Sequence[torch.device]):
    """``(state, batch) -> loss`` through ``tp_forward`` without gradients
    (``train_step.make_eval_step``'s contract), for either family; so the
    cv pass launches the TP kernels (B6, the DPT's partial kernels) as the
    train steps do."""

    def step(state: TrainState, batch) -> torch.Tensor:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                est = tp_forward(cfg, model.state_dict(), batch[0], devices,
                                 use_pallas=model.use_pallas)
                return weighted_loss(est, batch)
        finally:
            model.train(was_training)

    return step
