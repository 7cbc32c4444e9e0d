"""Metric-learning losses of the mel feature extractor (counterpart of
``mer_tpu/objectives/embedding.py``), the reference's loss stack
(src/feature_extractors/audio_mel/losses/):

- adaptive triplet margin loss      AdaptiveTripletMarginLoss.py:16-46
- fixed triplet margin loss         torch.nn.TripletMarginLoss(margin=0.2, p=2)
- variance (VICReg hinge)           VarianceLoss.py:6-25   (torch.var, ddof 1)
- covariance (off-diagonal^2)       CovarianceLoss.py:5-23 (torch.cov, ddof 1)
- composite 20 triplet + 5 cov + 1 var   M2FNetAudioEmbeddingLoss.py:22-28

Every function takes [B, D] embedding batches and returns a scalar.
"""

from __future__ import annotations

from functools import partial

import torch


def _pairwise_distance(x1: torch.Tensor, x2: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Row-wise L2 distance; ``eps`` inside the root (torch's TripletMarginLoss)."""
    diff = x1 - x2
    return torch.sqrt((diff * diff).sum(-1) + eps)


def adaptive_triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor, *,
                                 eps: float = 1e-6) -> torch.Tensor:
    """M2FNet's L_AMT, the batch mean of relu(d(a,p) - (d(a,n) + d(p,n)) / 2
    + margin), with margin = (1 + 2 / (exp(4 d_ap) + eps)) + (1 + 2 /
    (exp(-4 d_an + 4) + eps))."""
    d_ap = _pairwise_distance(anchor, positive)
    d_an = _pairwise_distance(anchor, negative)
    d_pn = _pairwise_distance(positive, negative)
    margin = (1.0 + 2.0 / (torch.exp(4.0 * d_ap) + eps)) + (1.0 + 2.0 / (torch.exp(-4.0 * d_an + 4.0) + eps))
    return torch.relu(d_ap - (d_an + d_pn) / 2.0 + margin).mean()


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor, *,
                        margin: float = 0.2, eps: float = 1e-6) -> torch.Tensor:
    """``torch.nn.TripletMarginLoss(margin, p=2)`` with the eps inside the norm
    as ``mer_tpu`` writes it (M2FNetAudioEmbeddingLoss.py:18)."""
    d_ap = _pairwise_distance(anchor, positive, eps)
    d_an = _pairwise_distance(anchor, negative, eps)
    return torch.relu(d_ap - d_an + margin).mean()


def variance_regularization(z: torch.Tensor, gamma: float = 1.0, eps: float = 1e-6) -> torch.Tensor:
    """VICReg variance hinge of one branch (VarianceLoss.py:6-12), ddof 1."""
    std = torch.sqrt(torch.var(z, dim=0, correction=1) + eps)
    return torch.relu(gamma - std).sum() / z.shape[-1]


def variance_loss(za, zp, zn, gamma: float = 1.0, eps: float = 1e-6) -> torch.Tensor:
    return sum(variance_regularization(z, gamma, eps) for z in (za, zp, zn))


def covariance_regularization(z: torch.Tensor) -> torch.Tensor:
    """Off-diagonal squared covariance of one branch over D
    (CovarianceLoss.py:5-12), ddof 1."""
    b, d = z.shape
    zc = z - z.mean(dim=0, keepdim=True)
    cov2 = ((zc.T @ zc) / (b - 1)) ** 2
    return (cov2.sum() - torch.diagonal(cov2).sum()) / d


def covariance_loss(za, zp, zn) -> torch.Tensor:
    return sum(covariance_regularization(z) for z in (za, zp, zn))


def m2fnet_audio_embedding_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor, *,
                                adaptive: bool = True, covariance_enabled: bool = True,
                                variance_enabled: bool = True) -> torch.Tensor:
    """20 triplet + 5 covariance + 1 variance (M2FNetAudioEmbeddingLoss.py:22-28)."""
    triplet = adaptive_triplet_margin_loss if adaptive else triplet_margin_loss
    loss = 20.0 * triplet(anchor, positive, negative)
    if covariance_enabled:
        loss = loss + 5.0 * covariance_loss(anchor, positive, negative)
    if variance_enabled:
        loss = loss + 1.0 * variance_loss(anchor, positive, negative)
    return loss


def make_embedding_loss(config) -> partial:
    """The composite loss bound to ``solver.{adaptive_triplet_margin_loss,
    covariance_loss, variance_loss}`` of a pipeline config."""
    return partial(
        m2fnet_audio_embedding_loss,
        adaptive=bool(config.solver.adaptive_triplet_margin_loss),
        covariance_enabled=bool(config.solver.covariance_loss),
        variance_enabled=bool(config.solver.variance_loss),
    )
