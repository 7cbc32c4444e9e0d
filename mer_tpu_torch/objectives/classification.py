"""Classification loss and class weights (counterpart of
``mer_tpu/objectives/classification.py``).

The reference trains the fusion classifier with
``torch.nn.CrossEntropyLoss(weight?, ignore_index=-1, label_smoothing=0.1)``
(src/train.py:43-50); padded utterances carry label -1 and leave both the
sum and the mean's denominator. Per element, with class weights w:

    l_i = (1 - eps) w[t_i] nll_i + eps sum_c w_c (-log p_ic) / C
    loss = sum_i l_i valid_i / sum_i w[t_i] valid_i

which is what ``torch.nn.functional.cross_entropy`` computes; this module
states it out, in float32 whatever the logits' dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    label_smoothing: float = 0.0,
    class_weights: torch.Tensor | None = None,
    ignore_index: int = -1,
) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is not
    ``ignore_index``; ``logits`` [..., C], ``labels`` [...] integers,
    ``class_weights`` [C] or None."""
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    w = (torch.ones(num_classes, device=logp.device) if class_weights is None
         else class_weights.to(logp.device, torch.float32))
    wt = w[safe]
    per = wt * nll
    if label_smoothing > 0.0:
        per = (1.0 - label_smoothing) * per - label_smoothing * (logp * w).sum(-1) / num_classes
    per = torch.where(valid, per, 0.0)
    denom = torch.where(valid, wt, 0.0).sum()
    return per.sum() / denom.clamp_min(1e-12)


def balanced_class_weights(labels: np.ndarray, num_classes: int = 7) -> np.ndarray:
    """sklearn's ``class_weight='balanced'``, n / (C * bincount) per class,
    0 for a class that never occurs (reference src/train.py:44-48)."""
    labels = np.asarray(labels)
    labels = labels[labels >= 0]
    counts = np.bincount(labels, minlength=num_classes).astype(np.float64)
    with np.errstate(divide="ignore"):
        weights = labels.shape[0] / (num_classes * counts)
    weights[~np.isfinite(weights)] = 0.0
    return weights.astype(np.float32)
