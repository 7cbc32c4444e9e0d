"""Dropout generators from ``tpu.seed`` (counterpart of ``mer_tpu/utils/rng.py``).

As in ``mer_tpu``, the dropout *stream* is not part of the contract; only
the Bernoulli distribution is. Two streams feed training:

- ``nn.Dropout`` (residual, feed-forward, projection and classifier dropout)
  draws from PyTorch's global generators;
- attention dropout inside the kernels draws two 32-bit seed words per call
  from a host ``torch.Generator``, so no call synchronises with the card.

Both are reseeded before every training step from (``seed``, step), as
``mer_tpu`` folds the step into its dropout key
(``mer_tpu/train/solver.py:196``): a run resumed at step k draws the masks
of an uninterrupted run from step k on.

``tpu.dropout_prng`` chooses between the TPU's hardware generator and
threefry in ``mer_tpu``; it has no meaning on CUDA. Its value is checked
(an unknown value raises, as in ``mer_tpu``) and otherwise ignored.
"""

from __future__ import annotations

import numpy as np
import torch

DROPOUT_PRNG_VALUES = ("auto", "rbg", "threefry2x32")


def seed_dropout(seed: int, dropout_prng: str | None = None) -> torch.Generator:
    """The host generator of attention dropout, with both streams seeded
    for step 0 of ``seed``."""
    if (dropout_prng or "auto") not in DROPOUT_PRNG_VALUES:
        raise ValueError(f"tpu.dropout_prng must be one of {DROPOUT_PRNG_VALUES}, got {dropout_prng!r}")
    generator = torch.Generator()
    seed_step(seed, 0, generator)
    return generator


def seed_step(seed: int, step: int, attention_generator: torch.Generator, dp_rank: int = 0,
              tp_rank: int = 0) -> None:
    """Seed the global generators (``nn.Dropout``) and the attention-dropout
    generator for training step ``step`` of a run seeded with ``seed``.

    Under data and tensor parallelism every rank draws masks of its own: the
    global generators from its dp rank (the tp ranks of one dp rank hold
    replicated activations, which must be dropped alike), the attention
    generator from its dp and tp ranks (a tp rank's heads are its own). Rank
    (0, 0) draws the single-process run's masks."""
    words = lambda *ranks: np.random.SeedSequence([seed, step, *ranks] if any(ranks) else [seed, step]) \
        .generate_state(2, np.uint64)
    torch.manual_seed(int(words(dp_rank)[0]))
    attention_generator.manual_seed(int(words(dp_rank, tp_rank)[1]))
