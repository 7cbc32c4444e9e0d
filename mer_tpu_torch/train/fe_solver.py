"""Freeze / fine-tune solver of the text and wav2vec2 feature extractors
(counterpart of ``mer_tpu/train/fe_solver.py``).

The reference's scheme (text/train.py:55-63, 84, 137-144, 211-227; wav2vec2 the
same skeleton with a weight decay per phase):

- two AdamW optimizers made up front: head-only (frozen phase) and
  all-parameters (fine-tune phase), each with its own moments and, under
  ``solver.grad_accum_steps``, its own accumulation window
  (``optax.MultiSteps`` semantics: the mean of k micro-gradients makes one
  update; a window left open when the phase changes is dropped);
- epochs ``< num_frozen_epochs`` step the head optimizer at ``frozen_lr``; the
  backbone's parameters do not require grad there, so autograd records nothing
  through it (on the card its conv frontend and attention run their
  forward-only kernels and no backward kernel is launched), while the model
  stays in train mode: dropout is on in the backbone too;
- afterwards the all-parameters optimizer under a constant-with-warmup
  schedule over ``warmup_epochs * max(steps_per_epoch // grad_accum, 1)``
  updates, stepped per update and only in unfrozen epochs, so the warmup clock
  starts at the unfreeze and the first fine-tune update runs at lr 0;
- cross-entropy without label smoothing (padding rows carry label -1 and leave
  the mean), optional balanced class weights; an epoch's loss is the mean of
  its batch losses, fetched from the device once;
- a checkpoint every epoch holding the model's parameters only
  (``{"epoch", "model_state_dict"}``, text/train.py:165-169; the file the
  ``test`` and ``embeddings`` entry points read); early stopping on the
  validation loss with the best weights saved beside it as
  ``best_weights.ckpt``, restored, promoted to ``save_path`` and removed.

Both config schemas are read: the text one (``solver.{frozen_lr,
finetuning_lr, weight_decay, warmup_epochs}``) and the wav2vec2 one
(``solver.{frozen: {lr, weight_decay}, finetuning: {lr, weight_decay,
warmup_epochs}}``).

Where this differs from ``mer_tpu`` on purpose:

1. ``tpu.train_scan_chunk`` groups same-shape batches into one scanned
   dispatch there and thereby reorders the steps; it exists to save jit
   dispatches and has no counterpart. The port steps in arrival order, which is
   ``mer_tpu``'s order at ``tpu.train_scan_chunk: 0``.
2. ``mer_tpu`` folds its dropout key on a counter that stands still in the
   frozen phase, so every frozen step draws the same masks. The dropout stream
   is not part of the contract (``utils/rng.py``): the port reseeds both
   generators from (``tpu.seed``, micro-step) before every step, in both
   phases, as the fusion trainer does.
3. Under pipeline parallelism (``pp_logits_fn``) every dropout mask is a
   function of (``tpu.seed``, micro-step, dp rank, global layer,
   microbatch) (``parallel/pipeline.py``), so it does not depend on pp; it
   differs from the non-pipelined stream, as ``mer_tpu``'s pp stream differs
   from its scan. ``--int8``
   selects the int8 engine of the exports alone (training ignores it, as
   ``mer_tpu``'s does).

On a mesh (``tpu.mesh``; dp = -1 by default, every rank) each rank takes its
dp rows of every training batch (the batch size must divide dp, as
``mer_tpu``'s batch sharding requires), the cross-entropy's denominator is
summed over dp, the backbone is tp-split (``parallel/tensor.py``), both
AdamW optimizers sum the gradients over dp and, under ``tpu.zero1``
(``--zero1``), keep each rank's slice of their moments. Evaluation runs every
batch whole on every rank; rank 0 writes the checkpoints (the whole model).

With ``pp_logits_fn`` (``--pp``; ``parallel/pp_forward.py``) the encoder's
layers are pipelined over the mesh's pp group: each stage holds its layers
and their moments alone, the pre-stack's and the head's gradients are
copied from the stage whose graph gives them to the others
(``pipeline.sync_replicated_grads``) before the dp sum, evaluation runs
through the pipeline too, and the checkpoints gather every stage's layers
first. ``tpu.zero1`` is ignored under pp, as in ``mer_tpu``.
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Callable

import torch

from mer_tpu_torch.models import set_attention_generator
from mer_tpu_torch.objectives.classification import cross_entropy, cross_entropy_terms
from mer_tpu_torch.objectives.metrics import BatchAveragedMetrics
from mer_tpu_torch.parallel.data import barrier, data_parallel, global_ratio
from mer_tpu_torch.parallel.mesh import Mesh, dp_row_shard, shard_params
from mer_tpu_torch.parallel.pipeline import full_stage_state_dict, own_entries, sync_replicated_grads
from mer_tpu_torch.parallel.pp_forward import replicated_owner, stack_of
from mer_tpu_torch.parallel.tensor import full_state_dict
from mer_tpu_torch.train.checkpoint import load_checkpoint, write_checkpoint
from mer_tpu_torch.train.solver import TrainState, accumulate_and_step, adamw, constant_with_warmup
from mer_tpu_torch.utils import RunLogger, seed_dropout, seed_step
from mer_tpu_torch.utils.logging import StepGradients, watch_norms


class FEState:
    """The model and the two optimizers' states. ``frozen.step`` and
    ``finetune.step`` count each phase's micro-steps (``finetune.step`` is the
    warmup clock); ``micro_step`` counts every training step and seeds its
    dropout."""

    def __init__(self, model: torch.nn.Module, frozen_opt: torch.optim.Optimizer,
                 finetune_opt: torch.optim.Optimizer):
        self.model = model
        self.frozen = TrainState(model, frozen_opt)
        self.finetune = TrainState(model, finetune_opt)
        self.micro_step = 0
        self.phase: str | None = None  # the phase of the last training epoch


class FESolver:
    """Args:
        model: ``TextERC`` / ``AudioERC`` on its device (``model(*inputs)`` ->
            logits), f32 parameters.
        config: the pipeline config (reference YAML schema).
        batch_to_inputs: ``(batch, device)`` -> the model's arguments.
        backbone_key: the submodule that freezes (``"roberta"`` /
            ``"wav2vec2"``); evaluation alone does not need it.
        class_weights: optional [C] class weights of the cross-entropy.
        mesh: this rank's place in a dp/tp (or dp/pp) mesh, the model already
            tp-split (or stage-split) on it; None for one process.
        pp_logits_fn: ``(*inputs, seed=None) -> logits`` through the
            pipeline over ``mesh``'s pp group (``fe_common.build_pp``), or
            None; ``seed`` is the step's seed words in training.
    """

    def __init__(self, model: torch.nn.Module, config, *, batch_to_inputs: Callable[..., tuple],
                 backbone_key: str | None = None, class_weights=None, mesh: Mesh | None = None,
                 pp_logits_fn: Callable[..., torch.Tensor] | None = None):
        self.model = model
        self.mesh = mesh or Mesh()
        self.pp_logits_fn = pp_logits_fn
        self.zero1 = bool(config.get_path("tpu.zero1", False)) and self.mesh.dp > 1 and pp_logits_fn is None
        self.config = config
        self.batch_to_inputs = batch_to_inputs
        self.backbone_key = backbone_key
        self.device = next(model.parameters()).device
        self.logger = RunLogger(config)
        cw = None if class_weights is None else torch.as_tensor(class_weights, device=self.device)
        self.loss_fn = partial(cross_entropy, label_smoothing=0.0, class_weights=cw, ignore_index=-1)
        self.loss_terms = partial(cross_entropy_terms, label_smoothing=0.0, class_weights=cw, ignore_index=-1)
        self.seed = int(config.get_path("tpu.seed", 0))
        self._attention_generator = seed_dropout(self.seed, config.get_path("tpu.dropout_prng", None))
        set_attention_generator(model, self._attention_generator)
        self._schedules: dict[str, Callable[[int], float]] = {}

    # -- setup -----------------------------------------------------------------

    def _read_solver_config(self) -> None:
        s = self.config.solver
        if "frozen" in s:  # wav2vec2 schema
            self.frozen_lr, self.frozen_wd = float(s.frozen.lr), float(s.frozen.weight_decay)
            self.finetune_lr, self.finetune_wd = float(s.finetuning.lr), float(s.finetuning.weight_decay)
            self.warmup_epochs = int(s.finetuning.warmup_epochs)
        else:  # text schema
            self.frozen_lr, self.finetune_lr = float(s.frozen_lr), float(s.finetuning_lr)
            self.frozen_wd = self.finetune_wd = float(s.weight_decay)
            self.warmup_epochs = int(s.warmup_epochs)
        self.num_frozen_epochs = int(s.num_frozen_epochs)
        self.grad_accum = int(self.config.get_path("solver.grad_accum_steps", 1) or 1)

    def init_state(self, steps_per_epoch: int) -> FEState:
        """Both optimizers over the model's current parameters, at step 0."""
        if self.backbone_key is None:
            raise ValueError("training needs backbone_key, the submodule that freezes")
        self._read_solver_config()
        backbone = {id(p) for p in getattr(self.model, self.backbone_key).parameters()}
        head = [p for p in self.model.parameters() if id(p) not in backbone]
        updates_per_epoch = max(steps_per_epoch // self.grad_accum, 1)
        self._schedules = {
            "frozen": lambda n: self.frozen_lr,
            "finetune": constant_with_warmup(self.finetune_lr, self.warmup_epochs * updates_per_epoch),
        }
        frozen = data_parallel(lambda groups: adamw(groups, self.frozen_lr, self.frozen_wd), [{"params": head}],
                               self.mesh, self.zero1, self.model)
        finetune = data_parallel(lambda groups: adamw(groups, self.finetune_lr, self.finetune_wd),
                                 [{"params": list(self.model.parameters())}], self.mesh, self.zero1, self.model)
        return FEState(self.model, frozen, finetune)

    # -- loops -------------------------------------------------------------------

    def _labels(self, batch: dict) -> torch.Tensor:
        return torch.from_numpy(batch["emotion"]).to(self.device)

    def train_epoch(self, state: FEState, batcher, epoch: int) -> tuple[FEState, float]:
        """One pass over ``batcher`` in the phase ``epoch`` belongs to; returns
        the mean of the batches' losses."""
        phase = "frozen" if epoch < self.num_frozen_epochs else "finetune"
        if state.phase != phase:  # the other optimizer's accumulation window is not this one's
            state.model.zero_grad(set_to_none=True)
            state.phase = phase
        getattr(state.model, self.backbone_key).requires_grad_(phase == "finetune")
        train_state = getattr(state, phase)
        state.model.train()
        losses = []
        for batch in batcher:
            seed_step(self.seed, state.micro_step, self._attention_generator, self.mesh.dp_rank, self.mesh.tp_rank)
            if self.mesh.dp > 1:
                if len(batch["emotion"]) % self.mesh.dp:
                    raise ValueError(f"a batch of {len(batch['emotion'])} does not divide dp={self.mesh.dp}")
                batch = dp_row_shard(batch, self.mesh.dp, self.mesh.dp_rank)
            inputs = self.batch_to_inputs(batch, self.device)
            watched = StepGradients(state.model) if self.logger.watch_step(len(losses)) else None
            if self.pp_logits_fn is None:
                logits = state.model(*inputs)
            else:
                logits = self.pp_logits_fn(*inputs, seed=(self.seed, state.micro_step, self.mesh.dp_rank))
            loss, global_loss = global_ratio(*self.loss_terms(logits, self._labels(batch)), self.mesh)
            loss.backward()
            if self.pp_logits_fn is not None:
                sync_replicated_grads(state.model, self.mesh, replicated_owner(state.model))
            grads = watched.after_backward() if watched else None
            accumulate_and_step(train_state, self.grad_accum, self._schedules[phase])
            if watched:
                self.logger.log_watch(watch_norms(state.model, self.logger.watch_log, grads))
            state.micro_step += 1
            losses.append(global_loss)
            if self.logger.wants_step_logs:  # a fetch per step, only while wandb records
                self.logger.log_step(torch.stack(losses).sum().item() / len(losses))
        getattr(state.model, self.backbone_key).requires_grad_(True)
        return state, (torch.stack(losses).sum().item() / len(losses) if losses else 0.0)

    @torch.no_grad()
    def evaluate(self, batcher) -> tuple[float, BatchAveragedMetrics]:
        """(mean batch loss, metrics) over ``batcher``, in eval mode."""
        self.model.eval()
        losses, preds, labels = [], [], []
        for batch in batcher:
            inputs = self.batch_to_inputs(batch, self.device)
            logits = self.model(*inputs) if self.pp_logits_fn is None else self.pp_logits_fn(*inputs)
            losses.append(self.loss_fn(logits, self._labels(batch)))
            preds.append(logits.argmax(-1))
            labels.append(batch["emotion"])
        metrics = BatchAveragedMetrics()
        if not losses:
            return 0.0, metrics
        total = torch.stack(losses).sum().item()
        for emotion, pred in zip(labels, torch.stack(preds).cpu().numpy()):
            metrics.update(emotion, pred, mask=emotion != -1)
        return total / len(losses), metrics

    def _whole_state_dict(self) -> dict:
        """The whole model's ``state_dict`` (a collective on a mesh: every
        stage's layers, every tp part)."""
        if self.mesh.size == 1:
            return self.model.state_dict()
        if self.mesh.pp > 1:
            layers, prefix = stack_of(self.model)
            return full_stage_state_dict(self.model, prefix, len(layers), self.mesh)
        return full_state_dict(self.model, self.mesh)

    def _save(self, path: str, epoch: int) -> None:
        """Model parameters only (text/train.py:165-169); on a mesh the whole
        model's, written by rank 0."""
        state = self._whole_state_dict()
        if self.mesh.rank == 0:
            write_checkpoint(path, {"epoch": int(epoch), "model_state_dict": {
                k: v.detach().to("cpu", copy=True) for k, v in state.items()}})

    def fit(self, train_batcher, val_batcher, state: FEState | None = None) -> tuple[FEState, dict]:
        solver_cfg, ckpt_cfg = self.config.solver, self.config.checkpoint
        epochs = int(solver_cfg.epochs)
        early = bool(solver_cfg.early_stopping.enabled)
        patience = int(solver_cfg.early_stopping.patience)
        restore_best = bool(solver_cfg.early_stopping.restore_best_weights)
        save_ckpt = bool(ckpt_cfg.get("save_checkpoint", True))
        save_path = os.path.abspath(str(ckpt_cfg.save_path))
        best_path = os.path.join(os.path.dirname(save_path), "best_weights.ckpt")

        if state is None:
            state = self.init_state(len(train_batcher))
        min_loss_val, patience_counter = float("inf"), 0
        history: dict[str, list] = {"loss_values": [], "val_loss_values": []}

        for epoch in range(epochs):
            t0 = time.perf_counter()
            state, loss_train = self.train_epoch(state, train_batcher, epoch)
            loss_val, metrics = self.evaluate(val_batcher)
            dt = time.perf_counter() - t0
            history["loss_values"].append(loss_train)
            history["val_loss_values"].append(loss_val)
            if save_ckpt:
                self._save(save_path, epoch)

            # the schedule's horizon is in updates; the state counts micro-steps
            n_updates = (state.finetune.step - 1) // self.grad_accum
            lr = self.frozen_lr if epoch < self.num_frozen_epochs else self._schedules["finetune"](n_updates)
            self.logger.log_epoch(epoch, lr=lr, loss_train=loss_train, loss_val=loss_val,
                                  accuracy=metrics.batch_averaged_accuracy,
                                  weighted_f1=metrics.batch_averaged_weighted_f1, epoch_seconds=dt)
            if not early:
                continue
            if loss_val < min_loss_val:
                min_loss_val, patience_counter = loss_val, 0
                if restore_best:
                    self._save(best_path, epoch)
                continue
            patience_counter += 1
            if patience_counter >= patience:
                self.logger.print(f"Early stopping: patience {patience} reached")
                barrier(self.mesh)  # rank 0 wrote best_path
                if restore_best and os.path.exists(best_path):
                    best = load_checkpoint(best_path)
                    self.model.load_state_dict(own_entries(self.model, shard_params(best["model_state_dict"],
                                                                                    self.mesh)), strict=True)
                    if save_ckpt:
                        self._save(save_path, best["epoch"])
                    barrier(self.mesh)
                    if self.mesh.rank == 0:
                        os.remove(best_path)
                    self.logger.print(f"Best model at epoch {best['epoch']} restored")
                break
        self.logger.finish()
        return state, history

    def test(self, batcher) -> dict:
        loss, metrics = self.evaluate(batcher)
        self.logger.print(f"Loss=[{loss:.3E}] Accuracy=[{metrics.batch_averaged_accuracy * 100:.3f}%] "
                          f"Weighted_F1=[{metrics.batch_averaged_weighted_f1 * 100:.3f}%]")
        return {"loss": loss, **metrics.summary()}
