"""Training orchestration: epochs, validation, LR schedule, checkpoints.

Counterpart of ``convtasnet_tpu/train/solver.py``:

- the epoch loop: a train pass, then a cross-validation pass;
- LR halving after ``lr_patience`` epochs without improvement (the flag
  re-arms every epoch after), early stop after ``stop_patience`` when
  enabled;
- the best-validation model saved to ``save_folder/model_path``, and
  per-epoch checkpoints when enabled, each with the loss history;
- resume (``continue_from``) restoring model, optimizer, epoch, the loss
  curves and the LR state machine, and continuing to the configured epoch
  count;
- on SIGTERM/SIGINT a checkpoint (``preempted.ckpt``) at the next batch
  boundary, then a clean stop;
- per-iteration prints of loss, running average and ms per batch; the
  loss is read back every ``print_freq`` steps, not after each step.

With ``cfg.mesh.model_axis`` m > 1 the model trains and validates split
over m shards, as the JAX solver routes it: the dual-path family with its
heads and FFN width split (``parallel/dpt_tp.py``), the TCN with its
hidden width split (``parallel/tensor_parallel.py``), gLN and cLN through
the TP step, BN through the ordinary step with a warning (its running
statistics). Parameters, optimizer state and checkpoints keep the
canonical layout either way.

The JAX solver's probe/autotune block is not ported (a TPU-relay device,
ROADMAP "Do not port"): on the card the kernels run or raise.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

from convtasnet_tpu_torch.config import TrainConfig
from convtasnet_tpu_torch.parallel.dpt_tp import make_dpt_tp_train_step
from convtasnet_tpu_torch.parallel.mesh import shard_devices
from convtasnet_tpu_torch.parallel.tensor_parallel import (
    make_tcn_tp_train_step,
    make_tp_eval_step,
)
from convtasnet_tpu_torch.train import checkpoint as ckpt
from convtasnet_tpu_torch.train.train_step import (
    create_train_state,
    get_lr,
    make_eval_step,
    make_train_step,
    set_lr,
)
from convtasnet_tpu_torch.utils.metrics import MetricsLogger, StepProfiler


class Solver:
    """``Solver(cfg, tr_loader, cv_loader, device, use_pallas).train()``.

    The loaders yield ``(mixture, lengths, sources, weights)`` tensors on
    ``device``; ``use_pallas`` is the model's (None: the CUDA kernels on a
    CUDA device)."""

    def __init__(self, cfg: TrainConfig, tr_loader, cv_loader, device="cpu",
                 use_pallas: Optional[bool] = None,
                 logger: Optional[MetricsLogger] = None):
        self.cfg = cfg
        self.tr_loader = tr_loader
        self.cv_loader = cv_loader
        # An empty cv loader would score 0.0 every epoch and early-stop the
        # run quietly; refuse to start instead.
        if len(tr_loader) == 0:
            raise ValueError(
                "training loader is empty — no utterances survived batch "
                "planning (check segment length vs utterance lengths and "
                "sample_rate)")
        if len(cv_loader) == 0:
            raise ValueError(
                "cv loader is empty — every utterance was dropped (check "
                "cv_maxlen vs utterance lengths and sample_rate)")
        s = cfg.solver
        n_model = cfg.mesh.model_axis
        if n_model > 1 and (cfg.model.separator == "dpt"
                            or cfg.model.norm_type != "BN"):
            # a model split: the dual-path head-group split, or the TCN's
            # stage-split (gLN) or per-norm (cLN) decomposition; canonical
            # parameter layout
            if s.train_batch_chunk:
                print("warning: --train-batch-chunk is ignored by the TP "
                      "train step (full-batch gradients)", file=sys.stderr)
            devices = shard_devices(n_model, device)
            self.train_step = (make_dpt_tp_train_step
                               if cfg.model.separator == "dpt" else
                               make_tcn_tp_train_step)(cfg.model, devices)
            self.eval_step = make_tp_eval_step(cfg.model, devices)
        else:
            if n_model > 1:
                print("warning: mesh model axis > 1 with BN running stats "
                      "— the solver trains on one shard (use gLN/cLN for "
                      "tensor-parallel training)", file=sys.stderr)
            self.train_step = make_train_step(s.train_batch_chunk)
            self.eval_step = make_eval_step()
        self.logger = logger or MetricsLogger(log_dir=s.save_folder)
        self.state = create_train_state(cfg.model, s, seed=s.seed,
                                        device=device, use_pallas=use_pallas)

        # LR / early-stop state machine
        self.start_epoch = 0
        self.tr_loss: List[float] = []
        self.cv_loss: List[float] = []
        self.prev_val_loss = float("inf")
        self.best_val_loss = float("inf")
        self.val_no_impv = 0
        self.halving = False

        self._interrupted = False
        if s.continue_from:
            self._resume(s.continue_from)

    # -- checkpoint/resume -------------------------------------------------
    def _resume(self, path: str) -> None:
        package, meta = ckpt.load_checkpoint(path)
        ckpt.restore_state(self.state, package)
        self.start_epoch = int(meta.get("epoch", 0))
        self.tr_loss = list(meta.get("tr_loss", []))[: self.start_epoch]
        self.cv_loss = list(meta.get("cv_loss", []))[: self.start_epoch]
        extra = meta.get("extra", {})
        self.prev_val_loss = extra.get("prev_val_loss", float("inf"))
        self.best_val_loss = extra.get("best_val_loss", float("inf"))
        self.val_no_impv = extra.get("val_no_impv", 0)
        self.logger.print(f"Resumed from {path} at epoch {self.start_epoch}")

    def _save(self, path: str, epoch: int) -> None:
        ckpt.save_checkpoint(
            path, self.state, self.cfg.model, epoch,
            tr_loss=self.tr_loss, cv_loss=self.cv_loss,
            extra={
                "prev_val_loss": self.prev_val_loss,
                "best_val_loss": self.best_val_loss,
                "val_no_impv": self.val_no_impv,
                "lr": get_lr(self.state),
                "solver": self.cfg.solver.to_dict(),
                "data": self.cfg.data.to_dict(),
            })

    # -- epoch passes ------------------------------------------------------
    def _run_train_epoch(self, epoch: int) -> float:
        self.tr_loader.set_epoch(epoch)
        s = self.cfg.solver
        start = time.time()
        losses: List[float] = []
        pending = []  # device scalars, read back every print_freq steps
        # profile steady-state steps of the first epoch trained (step 0
        # builds the kernels)
        profiler = StepProfiler(
            s.profile_dir, start_step=1, num_steps=s.profile_steps,
            enabled=bool(s.profile_dir) and epoch == self.start_epoch)
        i = 0
        for batch in self.tr_loader:
            if self._interrupted:
                break
            profiler.step(i)
            self.state, metrics = self.train_step(self.state, batch)
            pending.append(metrics["loss"])
            i += 1
            if i % s.print_freq == 0 and pending:
                losses.extend(float(x) for x in pending)
                pending.clear()
                self.logger.log_iter(epoch, i - 1, {
                    "loss": losses[-1], "avg_loss": float(np.mean(losses)),
                    "ms_per_batch": 1000 * (time.time() - start) / i})
        profiler.close()
        losses.extend(float(x) for x in pending)
        return float(np.mean(losses)) if losses else float("nan")

    def _run_cv_epoch(self, epoch: int) -> float:
        total, count = 0.0, 0
        for batch in self.cv_loader:
            if self._interrupted:
                break
            total += float(self.eval_step(self.state, batch))
            count += 1
        return total / max(count, 1)

    # -- main loop ---------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        os.makedirs(self.cfg.solver.save_folder, exist_ok=True)
        prev_handlers = {}

        def _on_signal(signum, frame):
            self.logger.print(
                f"Received signal {signum}: checkpointing and stopping.")
            self._interrupted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, _on_signal)
            except ValueError:  # not the main thread
                pass
        try:
            return self._train_loop()
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)

    def _stop_on_interrupt(self, epoch: int, where: str) -> bool:
        if not self._interrupted:
            return False
        path = os.path.join(self.cfg.solver.save_folder, "preempted.ckpt")
        self._save(path, epoch)
        self.logger.print(f"Interrupted {where} of epoch {epoch + 1}; state "
                          f"saved to {path} (resume with continue_from)")
        return True

    def _train_loop(self) -> Dict[str, Any]:
        s = self.cfg.solver
        for epoch in range(self.start_epoch, s.epochs):
            t0 = time.time()
            tr_avg = self._run_train_epoch(epoch)
            if self._stop_on_interrupt(epoch, "during the train pass"):
                break
            self.logger.log_epoch(epoch, "train", tr_avg, time.time() - t0)
            self.tr_loss.append(tr_avg)

            if s.enable_checkpoint:
                path = os.path.join(s.save_folder, "checkpoint_models",
                                    f"epoch{epoch + 1}.ckpt")
                self._save(path, epoch + 1)
                self.logger.print(f"Saved checkpoint to {path}")

            t1 = time.time()
            val_loss = self._run_cv_epoch(epoch)
            if self._stop_on_interrupt(epoch, "during the cv pass"):
                break
            self.logger.log_epoch(epoch, "valid", val_loss, time.time() - t1)
            self.cv_loss.append(val_loss)

            if s.half_lr:
                if val_loss >= self.prev_val_loss:
                    self.val_no_impv += 1
                    if self.val_no_impv >= s.lr_patience:
                        self.halving = True
                    if self.val_no_impv >= s.stop_patience and s.early_stop:
                        self.logger.print(
                            f"No improvement for {s.stop_patience} epochs, "
                            "early stopping.")
                        break
                else:
                    self.val_no_impv = 0
            if self.halving:
                new_lr = get_lr(self.state) / 2.0
                set_lr(self.state, new_lr)
                self.halving = False
                self.logger.print(f"Learning rate adjusted to: {new_lr:.6f}")
            self.prev_val_loss = val_loss

            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                path = os.path.join(s.save_folder, s.model_path)
                self._save(path, epoch + 1)
                self.logger.print(
                    f"Found better validated model, saving to {path}")

        return {"tr_loss": self.tr_loss, "cv_loss": self.cv_loss,
                "best_val_loss": self.best_val_loss, "state": self.state}
