"""Training checkpoints (counterpart of ``mer_tpu/train/checkpoint.py``).

Format: ``torch.save`` of the reference's layout (src/train.py:163-168),
``{"epoch", "model_state_dict", "optimizer_state_dict"}``, plus ``mer_tpu``'s
``extra`` slot (step, best validation loss, patience counter) and, while a
gradient-accumulation window is open, the gradients accumulated so far.
``python -m mer_tpu_torch.test --checkpoint`` reads the same files.

Writes are atomic (a temporary file, then ``os.replace``). The
:class:`AsyncCheckpointer` copies the state to the host synchronously and
writes it in a background thread, so an epoch never waits on the disk.

On a mesh (``parallel/mesh.py``) every rank assembles the payload, a
collective: the tp parts of the weights and moments gathered, ZeRO-1's
moments gathered by the optimizer, an open accumulation window summed over
dp; rank 0 alone writes it. The file is the single-process layout, so a run
resumes from it at any world size.

``mer_tpu`` writes flax msgpack files (one file, or a directory of
per-process shards), and ``src/config.yaml`` points both packages at
``checkpoints/m2fnet.ckpt``. :func:`load_checkpoint` reads those too, in
plain Python (``train/flax_msgpack.py``), and gives them in the port's
layout (``models/convert.py::port_payload``: the weights, the Adam moments,
the early-stop state). A file that is neither raises.

``tpu.async_checkpoint`` (default true) picks the background writer;
false writes each checkpoint before the epoch goes on, as ``mer_tpu`` does
(``mer_tpu/train/solver.py:411-412``): :func:`checkpoint_writer`.
"""

from __future__ import annotations

import os
import threading

import torch

from mer_tpu_torch.models.convert import is_mer_tpu_payload, port_payload, read_checkpoint


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
                       accumulated_grads: dict | None = None, mesh=None) -> dict:
    """The host-side payload of one checkpoint (copies, safe to write later);
    on a ``mesh`` with more than one rank, the whole model's (a collective)."""
    model_state, optimizer_state = model.state_dict(), optimizer.state_dict()
    if mesh is not None and mesh.size > 1:
        from mer_tpu_torch.parallel.tensor import all_reduce_f32, full_optimizer_state, full_state_dict, gather_tp

        model_state = full_state_dict(model, mesh)
        optimizer_state = full_optimizer_state(optimizer_state, [n for n, _ in model.named_parameters()], mesh)
        accumulated_grads = {n: gather_tp(n, all_reduce_f32(g, mesh.dp_group) if mesh.dp > 1 else g, mesh)
                             for n, g in (accumulated_grads or {}).items()}
    payload = {
        "epoch": int(epoch),
        "model_state_dict": _to_host(model_state),
        "optimizer_state_dict": _to_host(optimizer_state),
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
    """Write :func:`checkpoint_payload` ``(**kwargs)`` to ``path`` now (on a
    mesh: every rank assembles it, rank 0 writes)."""
    payload = checkpoint_payload(**kwargs)
    if _writes(kwargs.get("mesh")):
        write_checkpoint(path, payload)


def _writes(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def load_checkpoint(path: str | os.PathLike, kind: str | None = None, model_cfg=None) -> dict:
    """A checkpoint in the port's layout, tensors on the host: a torch file
    as written, or a ``mer_tpu`` msgpack file or shard directory converted
    (``kind``: which model it must hold, found from its names when None;
    ``model_cfg``: the fusion model's ``model:`` block). Anything else raises."""
    payload = read_checkpoint(path)
    return port_payload(payload, kind, model_cfg) if is_mer_tpu_payload(payload) else payload


def full_optimizer_state_dict(restored: dict, optimizer) -> dict:
    """``restored``'s optimizer ``state_dict``; a ``mer_tpu`` checkpoint's
    carries moments alone and takes ``optimizer``'s ``param_groups``."""
    if "optimizer_state_dict" not in restored:
        raise ValueError("the checkpoint holds no optimizer state (no Adam moments); resuming from it would start "
                         "fresh moments")
    state = restored["optimizer_state_dict"]
    return state if "param_groups" in state else {"state": state["state"],
                                                   "param_groups": optimizer.state_dict()["param_groups"]}


def micro_steps(restored: dict, accum: int) -> int:
    """The micro-steps a checkpoint's run had taken: ``extra``'s ``step``,
    else (a ``mer_tpu`` mel checkpoint) the Adam count's updates of ``accum``
    micro-steps plus the open window's."""
    extra = restored["extra"]
    if "step" in extra:
        return int(extra["step"])
    return int(restored.get("adam_count", 0)) * accum + int(restored.get("mini_step", 0))


class SyncCheckpointer:
    """The :class:`AsyncCheckpointer` interface, writing before ``save``
    returns (``tpu.async_checkpoint: false``)."""

    def save(self, path: str | os.PathLike, **kwargs) -> None:
        save_checkpoint(path, **kwargs)

    def wait(self) -> None:
        pass


def checkpoint_writer(config):
    """The writer ``tpu.async_checkpoint`` picks (default: the background one)."""
    return AsyncCheckpointer() if bool(config.get_path("tpu.async_checkpoint", True)) else SyncCheckpointer()


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
        if not _writes(kwargs.get("mesh")):
            return

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
