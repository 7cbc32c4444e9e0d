"""Fusion training: the solver, its optimizer, checkpoints and the entry
point ``python -m mer_tpu_torch.train`` (:func:`main`). The mel solver is
``train.mel_solver``; the feature-extractor solver's evaluation half is
:class:`FESolver`."""

from mer_tpu_torch.train.checkpoint import AsyncCheckpointer, load_checkpoint, save_checkpoint
from mer_tpu_torch.train.fe_solver import FESolver
from mer_tpu_torch.train.pipeline import main
from mer_tpu_torch.train.solver import (
    Solver,
    TrainState,
    accumulate_and_step,
    exponential_lr,
    optimizer_from_config,
    schedule_from_config,
)

__all__ = [
    "AsyncCheckpointer", "FESolver", "Solver", "TrainState", "accumulate_and_step", "exponential_lr",
    "load_checkpoint", "main", "optimizer_from_config", "save_checkpoint", "schedule_from_config",
]
