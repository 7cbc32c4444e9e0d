"""The fusion solver (counterpart of ``mer_tpu/train/solver.py``).

- the optimizer of the reference's solver block: ``torch.optim.Adam`` with
  L2 ``weight_decay`` (``mer_tpu``'s ``torch_adam``, decay added to the
  gradient before the moments) and, when enabled, ExponentialLR stepped once
  per epoch of *updates*; for the feature-extractor solver, :func:`adamw`
  and :func:`constant_with_warmup`;
- ``solver.grad_accum_steps`` k with ``optax.MultiSteps`` semantics: the
  mean of k micro-gradients makes one update, and the micro-step counter
  runs across epochs;
- one training step is a plain eager forward and backward under
  ``torch.autocast`` in the compute dtype over f32 parameters and f32 Adam
  state (``tpu.params_dtype: float32``); the epoch's mean loss is fetched
  from the device once, at its end;
- per-epoch validation with the reference's batch-averaged accuracy and
  weighted F1 (src/train.py:245-272);
- per-epoch checkpoints with optimizer state, early stopping with a
  best-weights shadow copy restored and promoted on stop
  (src/train.py:186-210), and resume of the optimizer, the step, the best
  validation loss and the patience counter; a resumed run replays the
  uninterrupted run's dropout masks (seeded per step) and, through the
  batcher's ``seek_epoch``, its shuffle;
- on a mesh (``tpu.mesh``, ``parallel/mesh.py``) the step ``mer_tpu`` jits
  over it: every rank takes its dp row shard of the global batch, the
  cross-entropy's denominator is summed over dp before the division (so the
  summed gradients are the global batch's loss's), the model is tp-split
  (``parallel/tensor.py``), and ``tpu.zero1`` keeps each dp rank's slice of
  the Adam moments (``parallel/data.py``). Evaluation runs the whole batch on
  every rank. Rank 0 writes the checkpoints, in the single-process layout.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from mer_tpu_torch.core import compute_dtype
from mer_tpu_torch.models import set_attention_generator
from mer_tpu_torch.objectives import BatchAveragedMetrics, cross_entropy
from mer_tpu_torch.objectives.classification import cross_entropy_terms
from mer_tpu_torch.parallel.data import barrier, data_parallel, global_ratio
from mer_tpu_torch.parallel.mesh import Mesh, dp_row_shard, shard_params, tp_slice
from mer_tpu_torch.parallel.tensor import shard_optimizer_state
from mer_tpu_torch.train.checkpoint import (checkpoint_writer, full_optimizer_state_dict, load_checkpoint, micro_steps,
                                            save_checkpoint)
from mer_tpu_torch.utils import RunLogger, seed_dropout, seed_step
from mer_tpu_torch.utils.logging import StepGradients, watch_norms


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0  # micro-steps (batches) taken, across epochs


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def exponential_lr(base_lr: float, gamma: float, updates_per_epoch: int) -> Callable[[int], float]:
    """torch's ExponentialLR stepped once per epoch of updates: the
    learning rate of update ``n`` (0-based)."""
    return lambda n: base_lr * gamma ** (n // max(updates_per_epoch, 1))


def constant_with_warmup(base_lr: float, warmup_updates: int) -> Callable[[int], float]:
    """Hugging Face's ``get_constant_schedule_with_warmup``
    (``mer_tpu``'s ``constant_with_warmup``): the learning rate of update ``n``
    (0-based) is ``base_lr * min(n / max(warmup_updates, 1), 1)``, so the
    first update runs at lr 0."""
    return lambda n: base_lr * min(n / max(warmup_updates, 1), 1.0)


def adamw(params, lr: float, weight_decay: float = 0.0) -> torch.optim.AdamW:
    """``mer_tpu``'s ``torch_adamw`` (``optax.adamw`` without a mask):
    betas 0.9 / 0.999, eps 1e-8, decoupled decay on every parameter, LayerNorms
    and biases included."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def grad_accum_steps(solver_cfg) -> int:
    return int(solver_cfg.get("grad_accum_steps", 1) or 1)


def schedule_from_config(solver_cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate of update ``n`` from the reference's ``solver:``
    block; an epoch holds ``steps_per_epoch // grad_accum_steps`` updates."""
    base_lr = float(solver_cfg.lr)
    sched = solver_cfg.get("scheduler", None)
    if not (sched and sched.get("enabled", False)):
        return lambda n: base_lr
    if sched.get("scheduler_fn") != "ExponentialLR":
        raise ValueError("Scheduler not supported")
    return exponential_lr(base_lr, float(sched.gamma), steps_per_epoch // grad_accum_steps(solver_cfg))


def optimizer_from_config(solver_cfg, params, steps_per_epoch: int) -> tuple[torch.optim.Adam, Callable[[int], float]]:
    """Adam with L2 decay over ``params``, and its learning-rate schedule."""
    optimizer = torch.optim.Adam(params, lr=float(solver_cfg.lr),
                                 weight_decay=float(solver_cfg.get("weight_decay", 0.0)))
    return optimizer, schedule_from_config(solver_cfg, steps_per_epoch)


def accumulate_and_step(state: TrainState, accum: int, schedule: Callable[[int], float]) -> bool:
    """Count one micro-step whose gradients ``backward`` added into
    ``.grad``. On every ``accum``-th, average them, set the update's
    learning rate, step the optimizer and clear the gradients; returns
    whether it updated."""
    state.step += 1
    if state.step % accum:
        return False
    params = [p for group in state.optimizer.param_groups for p in group["params"] if p.grad is not None]
    if accum > 1:
        for p in params:
            p.grad.div_(accum)
    lr = schedule(state.step // accum - 1)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    return True


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


class Solver:
    """Fusion classification solver.

    Args:
        model: M2FNet (f32 parameters) on the training device.
        config: the pipeline config (reference YAML schema). ``nn.Dropout``'s
            global generators and the attention dropout generator are
            reseeded from (``tpu.seed``, step) before every training step,
            so a resumed run replays the dropout masks of an uninterrupted one.
        class_weights: optional [C] class weights of the reference CE
            (ignore_index=-1, label_smoothing=0.1).
        mesh: this rank's place in a dp/tp mesh (``parallel.mesh_from_config``),
            the model already tp-split on it (``parallel.tensor_parallel_``);
            None for one process.
    """

    def __init__(self, model: torch.nn.Module, config, *, class_weights=None, mesh: Mesh | None = None):
        self.model = model
        self.mesh = mesh or Mesh()
        self.zero1 = bool(config.get_path("tpu.zero1", False)) and self.mesh.dp > 1
        self.config = config
        self.device = next(model.parameters()).device
        self.logger = RunLogger(config)
        self.compute_dtype = compute_dtype(config)
        self.accum = grad_accum_steps(config.solver)
        cw = None if class_weights is None else torch.as_tensor(class_weights, device=self.device)
        self.loss_fn = partial(cross_entropy, label_smoothing=0.1, class_weights=cw, ignore_index=-1)
        self.loss_terms = partial(cross_entropy_terms, label_smoothing=0.1, class_weights=cw, ignore_index=-1)
        self.seed = int(config.get_path("tpu.seed", 0))
        self._attention_generator = seed_dropout(self.seed, config.get_path("tpu.dropout_prng", None))
        set_attention_generator(model, self._attention_generator)
        self._schedule: Callable[[int], float] | None = None

    def init_state(self, steps_per_epoch: int) -> TrainState:
        """The optimizer over the model's current parameters, at step 0 (on
        a dp mesh: gradients summed over dp, ZeRO-1 under ``tpu.zero1``)."""
        self._schedule = schedule_from_config(self.config.solver, steps_per_epoch)
        make = lambda groups: optimizer_from_config(self.config.solver, groups, steps_per_epoch)[0]
        optimizer = data_parallel(make, [{"params": list(self.model.parameters())}], self.mesh, self.zero1,
                                  self.model)
        return TrainState(self.model, optimizer)

    def _autocast(self):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

    def _logits(self, model, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits, labels) of one batch, a dict of numpy arrays or device
        tensors."""
        t = {k: torch.as_tensor(batch[k]).to(self.device) for k in ("text", "audio", "padding_mask", "emotion")}
        with self._autocast():
            logits = model(t["text"], t["audio"], t["padding_mask"])
        return logits, t["emotion"]

    # -- epochs ---------------------------------------------------------------

    def train_epoch(self, state: TrainState, batcher) -> tuple[TrainState, float]:
        """One pass over ``batcher``; returns the mean of the batches' losses."""
        state.model.train()
        total, batches = torch.zeros((), device=self.device), 0
        for batch in batcher:
            seed_step(self.seed, state.step, self._attention_generator, self.mesh.dp_rank, self.mesh.tp_rank)
            if self.mesh.dp > 1:
                batch = dp_row_shard(batch, self.mesh.dp, self.mesh.dp_rank)
            watched = StepGradients(state.model) if self.logger.watch_step(batches) else None
            loss, global_loss = global_ratio(*self.loss_terms(*self._logits(state.model, batch)), self.mesh)
            loss.backward()
            grads = watched.after_backward() if watched else None
            accumulate_and_step(state, self.accum, self._schedule)
            if watched:  # gradients of this step, weights after its update (mer_tpu's watched step)
                self.logger.log_watch(watch_norms(state.model, self.logger.watch_log, grads))
            total += global_loss
            batches += 1
            if self.logger.wants_step_logs:  # a fetch per step, only while wandb records
                self.logger.log_step(total.item() / batches)
        return state, total.item() / max(batches, 1)

    @torch.no_grad()
    def evaluate(self, model, batcher) -> tuple[float, BatchAveragedMetrics]:
        model.eval()
        metrics = BatchAveragedMetrics()
        total, batches = 0.0, 0
        for batch in batcher:
            logits, emotion = self._logits(model, batch)
            loss = self.loss_fn(logits, emotion)
            emotion = emotion.cpu().numpy()
            metrics.update(emotion, logits.argmax(-1).cpu().numpy(), mask=emotion != -1)
            total += loss.item()
            batches += 1
        return total / max(batches, 1), metrics

    # -- full training loop ---------------------------------------------------

    def restore(self, state: TrainState, path: str) -> tuple[int, float, int]:
        """Resume ``state`` from the checkpoint at ``path``, the port's or a
        ``mer_tpu`` one (file or shard directory): weights, Adam moments, an
        open accumulation window, the micro-step; returns (first epoch to
        run, best validation loss, patience counter)."""
        restored = load_checkpoint(path, "fusion", self.config.model)
        names = [n for n, _ in state.model.named_parameters()]
        state.model.load_state_dict(shard_params(restored["model_state_dict"], self.mesh), strict=True)
        state.optimizer.load_state_dict(shard_optimizer_state(full_optimizer_state_dict(restored, state.optimizer),
                                                              names, self.mesh))
        for name, grad in restored.get("accumulated_grads", {}).items():
            param = state.model.get_parameter(name)
            grad = tp_slice(name, grad, self.mesh.tp_rank, self.mesh.tp)  # the dp sum, held by dp rank 0
            param.grad = (grad if self.mesh.dp_rank == 0 else torch.zeros_like(grad)).to(param.device, param.dtype)
        extra = restored["extra"]
        state.step = micro_steps(restored, self.accum)
        return (int(restored["epoch"]) + 1, float(extra.get("min_loss_val", float("inf"))),
                int(extra.get("patience_counter", 0)))

    def fit(self, train_batcher, val_batcher, state: TrainState | None = None) -> tuple[TrainState, dict]:
        solver_cfg, ckpt_cfg = self.config.solver, self.config.checkpoint
        epochs = int(solver_cfg.epochs)
        early_stopping = bool(solver_cfg.get_path("early_stopping.enabled", False))
        patience = int(solver_cfg.get_path("early_stopping.patience", 0) or 0)
        restore_best = bool(solver_cfg.get_path("early_stopping.restore_best_weights", False))
        save_ckpt = bool(ckpt_cfg.get("save_checkpoint", False))
        save_path = os.path.abspath(str(ckpt_cfg.get("save_path", "checkpoints/model.ckpt")))
        best_path = os.path.join(os.path.dirname(save_path), "best_weights.ckpt")

        if state is None:
            state = self.init_state(len(train_batcher))
        elif self._schedule is None:
            self._schedule = schedule_from_config(solver_cfg, len(train_batcher))

        start_epoch, min_loss_val, patience_counter = 0, float("inf"), 0
        load_path = os.path.abspath(str(ckpt_cfg.get("load_path", save_path)))
        if bool(ckpt_cfg.get("load_checkpoint", False)) and os.path.exists(load_path):
            start_epoch, min_loss_val, patience_counter = self.restore(state, load_path)
            train_batcher.seek_epoch(start_epoch)  # the shuffle of an uninterrupted run's epoch
            self.logger.print(f"Resumed from {load_path} at epoch {start_epoch}")

        history: dict[str, list] = {"loss_values": [], "val_loss_values": []}
        writer = checkpoint_writer(self.config)  # by default epoch checkpoints never wait on the disk

        def snapshot(epoch: int) -> dict:
            pending = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
            return dict(epoch=epoch, model=state.model, optimizer=state.optimizer,
                        extra={"step": state.step, "min_loss_val": min_loss_val,
                               "patience_counter": patience_counter},
                        accumulated_grads=pending, mesh=self.mesh)

        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            state, loss_train = self.train_epoch(state, train_batcher)
            loss_val, metrics = self.evaluate(state.model, val_batcher)
            dt = time.perf_counter() - t0
            history["loss_values"].append(loss_train)
            history["val_loss_values"].append(loss_val)
            if save_ckpt:
                writer.save(save_path, **snapshot(epoch))
            self.logger.log_epoch(epoch, lr=self._schedule((state.step - 1) // self.accum), loss_train=loss_train,
                                  loss_val=loss_val, accuracy=metrics.batch_averaged_accuracy,
                                  weighted_f1=metrics.batch_averaged_weighted_f1, epoch_seconds=dt)
            if not early_stopping:
                continue
            if loss_val < min_loss_val:
                min_loss_val, patience_counter = loss_val, 0
                if restore_best:
                    writer.save(best_path, **snapshot(epoch))
                continue
            patience_counter += 1
            if patience_counter >= patience:
                self.logger.print(f"Early stopping: patience {patience} reached")
                writer.wait()  # best_path fully on disk
                barrier(self.mesh)  # ... for every rank: rank 0 wrote it
                if restore_best and os.path.exists(best_path):
                    best = load_checkpoint(best_path)
                    state.model.load_state_dict(shard_params(best["model_state_dict"], self.mesh), strict=True)
                    if save_ckpt:
                        save_checkpoint(save_path, **{**snapshot(epoch), "epoch": best["epoch"]})
                    barrier(self.mesh)
                    if self.mesh.rank == 0:
                        os.remove(best_path)
                    self.logger.print(f"Best model at epoch {best['epoch']} restored")
                break

        writer.wait()
        self.logger.finish()
        return state, history

    # -- evaluation entry (reference src/test.py) -----------------------------

    def test(self, test_batcher, model) -> dict:
        loss, metrics = self.evaluate(model, test_batcher)
        self.logger.print(f"Accuracy=[{metrics.batch_averaged_accuracy * 100:.3f}%] "
                          f"Weighted_F1=[{metrics.batch_averaged_weighted_f1 * 100:.3f}%]")
        return {"loss": loss, **metrics.summary()}
