"""Console run logging (the console part of ``mer_tpu/utils/logging.py``).

Per epoch: learning rate, train and validation loss, batch-averaged accuracy
and weighted F1, and the epoch's seconds, in the reference's line format
(src/train.py:176-184). wandb and the ``watch_norms`` gradient norms are not
ported: the card's machine has no wandb.
"""

from __future__ import annotations


class RunLogger:
    def print(self, msg: str) -> None:
        print(msg, flush=True)

    def log_epoch(self, epoch: int, *, lr: float, loss_train: float, loss_val: float,
                  accuracy: float, weighted_f1: float, epoch_seconds: float | None = None) -> None:
        line = (f"Epoch: {epoch} lr: {lr:.3E} Train=[{loss_train:.3E}] Val=[{loss_val:.3E}] "
                f"Accuracy=[{accuracy * 100:.3f}%] Weighted_F1=[{weighted_f1 * 100:.3f}%]")
        if epoch_seconds is not None:
            line += f" ({epoch_seconds:.1f}s)"
        self.print(line)
