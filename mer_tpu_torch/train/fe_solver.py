"""Evaluation half of the feature-extractor solver (counterpart of
``mer_tpu/train/fe_solver.py``: ``FESolver.evaluate`` ``:368`` and ``.test``
``:452``).

Cross-entropy without label smoothing (padding rows carry label -1 and leave
the mean), accuracy and weighted F1 averaged over batches as the reference
averages them, the loss averaged over batches. The batch losses and
predictions stay on the device until the split ends and are fetched once.

The fine-tuning half (``fit``: the frozen and the fine-tune AdamW, the warmup
that starts at the unfreeze, early stopping, balanced class weights) is not
ported yet.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from mer_tpu_torch.objectives.classification import cross_entropy
from mer_tpu_torch.objectives.metrics import BatchAveragedMetrics
from mer_tpu_torch.utils import RunLogger


class FESolver:
    """Args:
        model: ``AudioERC`` on its device (``model(*inputs)`` -> logits).
        config: the pipeline config (reference YAML schema).
        batch_to_inputs: ``(batch, device)`` -> the model's arguments.
    """

    def __init__(self, model: torch.nn.Module, config, *, batch_to_inputs: Callable[..., tuple]):
        self.model = model
        self.config = config
        self.batch_to_inputs = batch_to_inputs
        self.device = next(model.parameters()).device
        self.logger = RunLogger()
        self.loss_fn = partial(cross_entropy, label_smoothing=0.0, ignore_index=-1)

    @torch.no_grad()
    def evaluate(self, batcher) -> tuple[float, BatchAveragedMetrics]:
        """(mean batch loss, metrics) over ``batcher``, in eval mode."""
        self.model.eval()
        losses, preds, labels = [], [], []
        for batch in batcher:
            logits = self.model(*self.batch_to_inputs(batch, self.device))
            emotion = torch.from_numpy(batch["emotion"]).to(self.device)
            losses.append(self.loss_fn(logits, emotion))
            preds.append(logits.argmax(-1))
            labels.append(batch["emotion"])
        metrics = BatchAveragedMetrics()
        if not losses:
            return 0.0, metrics
        total = torch.stack(losses).sum().item()
        for emotion, pred in zip(labels, torch.stack(preds).cpu().numpy()):
            metrics.update(emotion, pred, mask=emotion != -1)
        return total / len(losses), metrics

    def test(self, batcher) -> dict:
        loss, metrics = self.evaluate(batcher)
        self.logger.print(f"Loss=[{loss:.3E}] Accuracy=[{metrics.batch_averaged_accuracy * 100:.3f}%] "
                          f"Weighted_F1=[{metrics.batch_averaged_weighted_f1 * 100:.3f}%]")
        return {"loss": loss, **metrics.summary()}
