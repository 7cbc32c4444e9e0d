"""Run logging: the console, and wandb where it is installed and enabled
(counterpart of ``mer_tpu/utils/logging.py``).

Per epoch: learning rate, train and validation loss, batch-averaged accuracy
and weighted F1, and the epoch's seconds, in the reference's line format
(src/train.py:176-184). The ``wandb`` block of the reference configs is
read as ``mer_tpu`` reads it: ``enabled``, ``watch_model``, ``watch_log``,
``watch_log_freq``, ``project_name``, ``entity``, ``resume_run`` and
``resume_run_id`` (init and resume by run id, src/train.py:59-72). When
wandb is enabled but not installed (neither machine of this project has
it), one line says so and everything goes to the console; when it is
disabled nothing is said.

:func:`watch_norms` is the counterpart of ``wandb.watch(model, log=...,
log_freq=...)`` that ``mer_tpu`` computes in a separately compiled step:
per-parameter L2 norms of the gradients and / or the weights, keyed
``gradients/<name>`` and ``parameters/<name>`` by the ``state_dict`` names,
computed on the device. The solvers compute them on every
``watch_log_freq``-th step of an epoch, and only while wandb records, so a
step that logs nothing fetches nothing from the device.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any

import torch


def watch_norms(model: torch.nn.Module, watch_log: str, grads: dict | None = None) -> dict[str, torch.Tensor]:
    """Per-parameter L2 norms (f32, on the device) in ``mer_tpu``'s modes:
    ``"gradients"``, ``"parameters"`` or ``"all"`` (src/train.py:136).
    ``grads``: the step's gradients by name (default: each ``.grad``);
    parameters without one are left out."""
    norms: dict[str, torch.Tensor] = {}
    named = list(model.named_parameters())
    if watch_log in ("gradients", "all"):
        for name, p in named:
            g = p.grad if grads is None else grads.get(name)
            if g is not None:
                norms[f"gradients/{name}"] = torch.linalg.vector_norm(g.detach().float())
    if watch_log in ("parameters", "all"):
        for name, p in named:
            norms[f"parameters/{name}"] = torch.linalg.vector_norm(p.detach().float())
    return norms


class StepGradients:
    """The gradients one micro-step adds to ``.grad`` (with accumulation
    ``.grad`` holds the window's sum): a copy of the ``.grad`` before the
    backward, subtracted after it. Made only on a watched step."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.before = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}

    def after_backward(self) -> dict[str, torch.Tensor]:
        out = {}
        for name, p in self.model.named_parameters():
            if p.grad is not None:
                prev = self.before.get(name)
                out[name] = p.grad.detach() - prev if prev is not None else p.grad.detach().clone()
        return out


class RunLogger:
    def __init__(self, config=None):
        self._wandb = None
        self._global_step = 0
        self._watch_model = False
        self.watch_log = "all"
        self.watch_freq = 100
        wandb_cfg = config.get("wandb") if config is not None else None
        if wandb_cfg:
            # wandb.watch's knobs (reference src/train.py:132-138: log="all", log_freq=100)
            self._watch_model = bool(wandb_cfg.get("watch_model", False))
            self.watch_log = str(wandb_cfg.get("watch_log", "all"))
            self.watch_freq = int(wandb_cfg.get("watch_log_freq", 100))
        if wandb_cfg and wandb_cfg.get("enabled", False):
            try:
                import wandb
            except ImportError:
                self.print("wandb enabled in config but not installed; falling back to console logging")
            else:
                resume_run = bool(wandb_cfg.get("resume_run", False))
                wandb.init(
                    project=wandb_cfg.get("project_name", "mer-tpu"),
                    name=datetime.now().isoformat().split(".")[0],
                    config=config.to_dict() if hasattr(config, "to_dict") else dict(config or {}),
                    entity=wandb_cfg.get("entity") or None,
                    resume="must" if resume_run else False,
                    id=wandb_cfg.get("resume_run_id") or None,
                )
                self._wandb = wandb

    @property
    def wants_step_logs(self) -> bool:
        """Per-step running-loss logging fetches each step's loss from the
        device; only worth it while wandb records it."""
        return self._wandb is not None

    @property
    def wants_watch_logs(self) -> bool:
        """Whether the solvers should compute :func:`watch_norms` every
        ``watch_freq`` steps (``wandb.watch``'s counterpart)."""
        return self._wandb is not None and self._watch_model

    def watch_step(self, batch_index: int) -> bool:
        """Whether the ``batch_index``-th step of an epoch is a watched one."""
        return self.wants_watch_logs and batch_index % max(self.watch_freq, 1) == 0

    def log_watch(self, norms: dict) -> None:
        """Log a watched step's norms (fetched from the device here)."""
        if self._wandb is not None:
            self._wandb.log({k: float(v) for k, v in norms.items()})

    def log_image(self, key: str, path: str) -> None:
        """wandb.Image upload (reference audio_mel/train.py:337)."""
        if self._wandb is not None:
            self._wandb.log({key: [self._wandb.Image(path)]})

    def log_html(self, key: str, path: str) -> None:
        """wandb.Html upload (reference audio_mel/train.py:339)."""
        if self._wandb is not None:
            self._wandb.log({key: [self._wandb.Html(path)]})

    def print(self, msg: str) -> None:
        print(msg, flush=True)

    def log_step(self, running_loss: float) -> None:
        self._global_step += 1
        if self._wandb is not None:
            self._wandb.log({"Train/Running_loss": running_loss, "Params/Global_step": self._global_step})

    def log_epoch(self, epoch: int, *, lr: float, loss_train: float, loss_val: float,
                  accuracy: float, weighted_f1: float, epoch_seconds: float | None = None,
                  extra: dict[str, Any] | None = None) -> None:
        line = (f"Epoch: {epoch} lr: {lr:.3E} Train=[{loss_train:.3E}] Val=[{loss_val:.3E}] "
                f"Accuracy=[{accuracy * 100:.3f}%] Weighted_F1=[{weighted_f1 * 100:.3f}%]")
        if epoch_seconds is not None:
            line += f" ({epoch_seconds:.1f}s)"
        self.print(line)
        if self._wandb is not None:
            payload = {
                "Params/Epoch": epoch,
                "Params/Learning_Rate": lr,
                "Train/Loss": loss_train,
                "Validation/Loss": loss_val,
                "Validation/Accuracy": accuracy,
                "Validation/Weighted_F1": weighted_f1,
            }
            if epoch_seconds is not None:
                payload["Perf/Epoch_seconds"] = epoch_seconds
            if extra:
                payload.update(extra)
            self._wandb.log(payload)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
