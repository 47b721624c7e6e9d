"""The training step.

Counterpart of ``convtasnet_tpu/train/train_step.py``: forward, uPIT loss
weighted over the real rows, backward, the global gradient norm, clipping
by that norm, then L2 and Adam (or SGD with momentum), in the optax order
of the JAX ``make_optimizer`` (clip -> add_decayed_weights -> adam).

- Clipping is optax's ``clip_by_global_norm``: gradients are scaled by
  max_norm / norm when the norm reaches max_norm, with no epsilon (unlike
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6).
- L2 is ``weight_decay`` of ``torch.optim.Adam``/``SGD``, which adds
  l2 * param to the gradient before the moments, as ``add_decayed_weights``
  does (AdamW's decoupled decay would not match). Adam's eps 1e-8 sits
  outside the square root on both sides.
- The learning rate lives in the optimizer's parameter groups and changes
  in place (``set_lr``), as the JAX package injects it into its state.
- The model runs in ``cfg.compute_dtype`` with explicit casts (no
  autocast); the loss is float32.

``metrics["grad_norm"]`` is the norm before clipping. Losses and norms stay
on the device until the caller reads them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from convtasnet_tpu_torch.config import ConvTasNetConfig, SolverConfig
from convtasnet_tpu_torch.losses.pit import pit_si_snr
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass
class TrainState:
    """The model, its optimizer, the clipping norm and the step count."""

    model: ConvTasNet
    optimizer: torch.optim.Optimizer
    max_grad_norm: float
    step: int = 0


def make_optimizer(cfg: SolverConfig,
                   params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """Adam or SGD (momentum) with L2 as coupled weight decay."""
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.l2)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               weight_decay=cfg.l2)
    raise ValueError(f"unsupported optimizer: {cfg.optimizer}")


def get_lr(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_lr(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def create_train_state(
    model_cfg: ConvTasNetConfig,
    solver_cfg: SolverConfig,
    seed: int = 0,
    device="cpu",
    use_pallas: Optional[bool] = None,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
) -> TrainState:
    """A model initialised from ``seed`` (or loaded from ``state_dict``) on
    ``device``, with a fresh optimizer."""
    model = ConvTasNet(model_cfg, use_pallas=use_pallas,
                       generator=torch.Generator().manual_seed(seed),
                       device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.train()
    return TrainState(model, make_optimizer(solver_cfg, model.parameters()),
                      solver_cfg.max_grad_norm)


def weighted_loss(est: torch.Tensor, batch: Batch) -> torch.Tensor:
    """The loss of the estimates ``est`` [B, C, T] of ``batch``'s mixtures:
    -(sum of max_snr * weight) / max(sum of weights, 1), so padding rows
    (weight 0) contribute nothing."""
    _, lengths, sources, weights = batch
    max_snr, _ = pit_si_snr(sources, est, lengths)
    w = weights.float()
    return -(max_snr * w).sum() / w.sum().clamp_min(1.0)


def _weighted_loss(model: ConvTasNet, batch: Batch) -> torch.Tensor:
    return weighted_loss(model(batch[0]), batch)


def _loss_and_grads(model: ConvTasNet, batch: Batch,
                    batch_chunk: int) -> torch.Tensor:
    """Loss of one batch, with its gradients left in ``.grad``.

    ``batch_chunk`` > 0 runs forward and backward over that many rows at a
    time and accumulates: the weighted-sum loss is additive over rows and
    the weight normaliser is batch-constant, so the numbers are the
    full-batch ones. Skipped for BN (its batch statistics span the whole
    batch) and when the batch does not divide evenly, as in the JAX step.
    """
    model.zero_grad(set_to_none=True)
    B = batch[0].shape[0]
    if (not batch_chunk or B <= batch_chunk or B % batch_chunk
            or model.cfg.norm_type == "BN"):
        loss = _weighted_loss(model, batch)
        loss.backward()
        return loss.detach()
    wsum = batch[3].float().sum().clamp_min(1.0)
    lsum = torch.zeros((), device=batch[0].device)
    for i in range(0, B, batch_chunk):
        mixture, lengths, sources, weights = (t[i:i + batch_chunk]
                                              for t in batch)
        max_snr, _ = pit_si_snr(sources, model(mixture), lengths)
        chunk_loss = -(max_snr * weights.float()).sum()
        (chunk_loss / wsum).backward()
        lsum = lsum + chunk_loss.detach()
    return lsum / wsum


def _clip_by_global_norm(params: Sequence[torch.nn.Parameter],
                         max_norm: float) -> torch.Tensor:
    """Scale the gradients by min(1, max_norm / norm) in place; returns the
    norm before clipping (optax ``global_norm`` and
    ``clip_by_global_norm``)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = (max_norm / norm).clamp(max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def make_train_step(batch_chunk: int = 0
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``(state, batch) -> (state, {"loss", "grad_norm"})``; updates the
    state in place and returns it. ``batch`` is (mixture [B, T], lengths
    [B], sources [B, C, T], weights [B]) on the model's device."""

    def step(state: TrainState, batch: Batch):
        model = state.model
        model.train()
        loss = _loss_and_grads(model, batch, batch_chunk)
        params = [p for p in model.parameters() if p.grad is not None]
        grad_norm = _clip_by_global_norm(params, state.max_grad_norm)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step


def make_multi_train_step(batch_chunk: int = 0):
    """Several optimizer steps per call: ``(state, batches) -> (state,
    metrics)`` with ``metrics["loss"]`` stacked over the steps. A plain
    loop of ``make_train_step`` (the JAX package scans to save dispatches;
    the numbers are the same)."""
    step = make_train_step(batch_chunk)

    def multi(state: TrainState, batches: Sequence[Batch]):
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in ("loss", "grad_norm")}

    return multi


def make_eval_step() -> Callable[[TrainState, Batch], torch.Tensor]:
    """``(state, batch) -> loss``: no gradients, BN with its running
    statistics (eval mode); the model's previous mode is restored."""

    def step(state: TrainState, batch: Batch) -> torch.Tensor:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                return _weighted_loss(model, batch)
        finally:
            model.train(was_training)

    return step
