"""A fine-tuning step's dropout masks, drawn again from the run's seed.

The extractor's training step reseeds two streams before each step from
(seed, step): PyTorch's global generator, from which its ``F.dropout``
calls draw, and a host ``torch.Generator``, from which every attention call
draws two 32-bit seed words for the Philox4x32-10 draw inside the attention
kernels (a 2 x 2 block of probabilities a call; keep where the bits reach
the rate's threshold). :class:`StepMasks` restates both in plain PyTorch
and NumPy, as frozen copies (commit 88254f0) of
``mer_tpu_torch/utils/rng.py::seed_step`` (the seed words) and of the
plain Philox of ``mer_tpu_torch/ops/flash_attention.py`` (``philox4x32``,
``dropout_factor``, ``dropout_threshold``). A hidden-state mask is drawn by
the same ``F.dropout`` on ones of the same shape and dtype, in the order the
step's forward calls it, so it takes the same numbers from the generator.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * m`` (int64 ``a`` in [0, 2**32)),
    with ``m`` split in 16-bit halves so no partial product overflows."""
    lo_part = a * (m & 0xFFFF)
    t = a * (m >> 16) + (lo_part >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (lo_part & 0xFFFF)


def philox4x32(counter, key) -> list[torch.Tensor]:
    """Philox4x32-10 (Salmon et al., SC 2011): four broadcastable int64
    counter words, two key words -> the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = int(key[0]), int(key[1])
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return [c0, c1, c2, c3]


def attention_keep(seed, shape, rate: float, device) -> torch.Tensor:
    """The kept probabilities of a [B, H, Sq, Sk] attention (bool): word
    2 (row & 1) + (col & 1) of Philox at counter (col >> 1, row >> 1, b H + h,
    0) and key ``seed``, kept where it is at least rate * 2**32."""
    b, h, sq, sk = shape
    n_r, n_c = (sq + 1) >> 1, (sk + 1) >> 1
    idx = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    w = [x.expand(b, h, n_r, n_c) for x in
         philox4x32((idx(n_c).view(1, 1, 1, n_c), idx(n_r).view(1, 1, n_r, 1), idx(b * h).view(b, h, 1, 1), 0), seed)]
    bits = torch.stack([torch.stack(w[:2], -1), torch.stack(w[2:], -1)], -3).reshape(b, h, 2 * n_r, 2 * n_c)
    return bits[:, :, :sq, :sk] >= min(int(rate * (1 << 32)), (1 << 32) - 1)


def step_words(seed: int, step: int) -> tuple[int, int]:
    """(global generator's seed, attention generator's seed) of a step."""
    words = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint64)
    return int(words[0]), int(words[1])


class StepMasks:
    """The masks of one training step, in the order its forward draws them.
    Creating it reseeds PyTorch's global generator, as the step does."""

    def __init__(self, seed: int, step: int, hidden_rate: float, attention_rate: float, dtype: torch.dtype, device):
        global_seed, attention_seed = step_words(seed, step)
        torch.manual_seed(global_seed)
        self.generator = torch.Generator()
        self.generator.manual_seed(attention_seed)
        self.hidden_rate, self.attention_rate, self.dtype, self.device = hidden_rate, attention_rate, dtype, device

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` dropped as ``F.dropout`` at ``hidden_rate`` drops a tensor
        of its shape in the step's compute dtype."""
        if self.hidden_rate == 0.0:
            return x
        keep = F.dropout(torch.ones(x.shape, dtype=self.dtype, device=self.device), self.hidden_rate, True) != 0
        return torch.where(keep, x * (1.0 / (1.0 - self.hidden_rate)), 0.0)

    def attention(self, shape) -> torch.Tensor | None:
        """The factor [B, H, Sq, Sk] on one attention's probabilities: 0 where
        dropped, 1 / (1 - rate) where kept (float32)."""
        if self.attention_rate == 0.0:
            return None
        seed = torch.randint(0, 1 << 32, (2,), generator=self.generator, dtype=torch.int64).tolist()
        keep = attention_keep(seed, shape, self.attention_rate, self.device)
        return torch.where(keep, 1.0 / (1.0 - self.attention_rate), 0.0)
