"""Run-time helpers: dropout generators and console logging."""

from mer_tpu_torch.utils.logging import RunLogger
from mer_tpu_torch.utils.rng import seed_dropout

__all__ = ["RunLogger", "seed_dropout"]
