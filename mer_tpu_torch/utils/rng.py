"""Dropout generators from ``tpu.seed`` (counterpart of ``mer_tpu/utils/rng.py``).

As in ``mer_tpu``, the dropout *stream* is not part of the contract; only
the Bernoulli distribution is. Two streams feed training:

- ``nn.Dropout`` (residual, feed-forward, projection and classifier dropout)
  draws from PyTorch's global generators, seeded once from ``seed + 1`` when
  the trainer starts (``mer_tpu`` keys its dropout on ``seed + 1`` too);
- attention dropout inside the kernels draws two 32-bit seed words per call
  from a host ``torch.Generator`` seeded from ``seed + 2``, so no call
  synchronises with the card and the global generators are never used.

``tpu.dropout_prng`` chooses between the TPU's hardware generator and
threefry in ``mer_tpu``; it has no meaning on CUDA. Its value is checked
(an unknown value raises, as in ``mer_tpu``) and otherwise ignored.
"""

from __future__ import annotations

import torch

DROPOUT_PRNG_VALUES = ("auto", "rbg", "threefry2x32")


def seed_dropout(seed: int, dropout_prng: str | None = None) -> torch.Generator:
    """Seed ``nn.Dropout``'s global generators and return the host generator
    of attention dropout, both derived from ``seed``."""
    if (dropout_prng or "auto") not in DROPOUT_PRNG_VALUES:
        raise ValueError(f"tpu.dropout_prng must be one of {DROPOUT_PRNG_VALUES}, got {dropout_prng!r}")
    torch.manual_seed(seed + 1)
    return torch.Generator().manual_seed(seed + 2)
