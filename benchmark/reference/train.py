"""A fine-tuning step in plain PyTorch, float32: the cross-entropy over the
rows that carry a label (a label of -1 marks a padding row), its gradients
by autograd, and AdamW written out (decoupled decay on every parameter,
then the bias-corrected moments), as ``torch.optim.AdamW`` defines it,
under the extractor recipe's constant-with-warmup rate: update n (from 0)
runs at lr * min(n / max(warmup, 1), 1), so the first runs at 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    keep = labels != -1
    return F.cross_entropy(logits[keep].float(), labels[keep].long())


class AdamW:
    def __init__(self, params: dict[str, torch.Tensor], weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.wd, self.betas, self.eps = params, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1.0 - lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m_hat = self.m[k] / (1.0 - b1 ** self.t)
            v_hat = self.v[k] / (1.0 - b2 ** self.t)
            p.sub_(lr * m_hat / (v_hat.sqrt() + self.eps))


def constant_with_warmup(lr: float, warmup_updates: int, n: int) -> float:
    return lr * min(n / max(warmup_updates, 1), 1.0)
