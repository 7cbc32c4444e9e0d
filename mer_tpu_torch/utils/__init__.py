"""Run-time helpers: dropout generators, console logging, profiling and step timing."""

from mer_tpu_torch.utils.logging import RunLogger
from mer_tpu_torch.utils.profiling import StepTimer, trace
from mer_tpu_torch.utils.rng import seed_dropout, seed_step

__all__ = ["RunLogger", "StepTimer", "seed_dropout", "seed_step", "trace"]
