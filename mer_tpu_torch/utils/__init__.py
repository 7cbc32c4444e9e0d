"""Run-time helpers: dropout generators, console logging, profiling and host spans."""

from mer_tpu_torch.utils.logging import RunLogger
from mer_tpu_torch.utils.profiling import trace
from mer_tpu_torch.utils.rng import seed_dropout, seed_step

__all__ = ["RunLogger", "seed_dropout", "seed_step", "trace"]
