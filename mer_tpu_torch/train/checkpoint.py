"""Training checkpoints (counterpart of ``mer_tpu/train/checkpoint.py``).

Format: ``torch.save`` of the reference's layout (src/train.py:163-168),
``{"epoch", "model_state_dict", "optimizer_state_dict"}``, plus ``mer_tpu``'s
``extra`` slot (step, best validation loss, patience counter) and, while a
gradient-accumulation window is open, the gradients accumulated so far.
``python -m mer_tpu_torch.test --checkpoint`` reads the same files.

Writes are atomic (a temporary file, then ``os.replace``). The
:class:`AsyncCheckpointer` copies the state to the host synchronously and
writes it in a background thread, so an epoch never waits on the disk.

``mer_tpu`` writes flax msgpack files, and ``src/config.yaml`` points both
packages at ``checkpoints/m2fnet.ckpt``. Reading those files needs msgpack
and flax, which the card's machine lacks, so :func:`load_checkpoint` raises
on any file that is not a torch checkpoint rather than misread it.
"""

from __future__ import annotations

import os
import threading

import torch

from mer_tpu_torch.models.convert import read_torch_checkpoint


def _to_host(tree):
    """A copy of ``tree`` with every tensor on the host, detached."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def checkpoint_payload(*, epoch: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer, extra: dict,
                       accumulated_grads: dict | None = None) -> dict:
    """The host-side payload of one checkpoint (copies, safe to write later)."""
    payload = {
        "epoch": int(epoch),
        "model_state_dict": _to_host(model.state_dict()),
        "optimizer_state_dict": _to_host(optimizer.state_dict()),
        "extra": dict(extra),
    }
    if accumulated_grads:
        payload["accumulated_grads"] = _to_host(accumulated_grads)
    return payload


def write_checkpoint(path: str | os.PathLike, payload: dict) -> None:
    """``torch.save`` to ``path`` atomically: a crash leaves no torn file."""
    path = os.path.abspath(os.fspath(path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str | os.PathLike, **kwargs) -> None:
    """Write :func:`checkpoint_payload` ``(**kwargs)`` to ``path`` now."""
    write_checkpoint(path, checkpoint_payload(**kwargs))


load_checkpoint = read_torch_checkpoint  # tensors on the host; refuses files torch.save did not write


class AsyncCheckpointer:
    """Background checkpoint writes, one at a time and in submission order.

    ``save`` takes the host payload synchronously (the copies isolate it from
    later training steps), waits for the previous write, and starts a thread
    for this one. ``wait`` drains the pending write and re-raises its error.
    """

    def __init__(self):
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, path: str | os.PathLike, **kwargs) -> None:
        payload = checkpoint_payload(**kwargs)
        self.wait()

        def write():
            try:
                write_checkpoint(path, payload)
            except BaseException as e:  # raised by the next wait()
                self._error = e

        self._pending = threading.Thread(target=write, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.join()
        if self._error is not None:
            error, self._error = self._error, None
            raise error
