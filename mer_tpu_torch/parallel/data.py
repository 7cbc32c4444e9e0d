"""Data parallelism and ZeRO-1 over the dp group.

``mer_tpu`` jits its step over a dp mesh and lets XLA sum the gradients; the
step is then the gradient of the *global* batch's loss. The port writes that
step out:

- every rank builds the same global batch and takes its rows
  (``mesh.dp_row_shard``);
- a loss that is a ratio of sums (the weighted cross-entropy) has its
  denominator summed over the group before the division
  (:func:`global_ratio`), so each rank's loss is its part of the global
  numerator over the global denominator, and the summed gradients are the
  global loss's; averaging per-rank means (DDP's default) differs whenever
  class weights or padding make the ranks' denominators unequal;
- a loss over the whole batch (the mel extractor's triplet, variance and
  covariance terms) sees the whole batch's embeddings (:func:`gather_rows`);
- :class:`DataParallelOptimizer` sums the gradients over the group before the
  optimizer's step; with ZeRO-1 each rank keeps its slice of the moments.

The collectives are ``all_reduce`` and ``all_gather`` alone: gloo takes them
on CUDA tensors too.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.distributed as dist
from torch import nn

from mer_tpu_torch.parallel.mesh import Mesh, torch_tp_split, zero1_axis

_BUCKET = 1 << 24  # elements a gradient all-reduce moves at once


def all_reduce_sum_(tensors: Iterable[torch.Tensor], group) -> None:
    """Sum every tensor over ``group`` in place, a flat bucket per dtype and
    device at a time."""
    buckets: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        start = 0
        while start < len(ts):
            end, size = start, 0
            while end < len(ts) and (end == start or size + ts[end].numel() <= _BUCKET):
                size += ts[end].numel()
                end += 1
            flat = torch.cat([t.reshape(-1) for t in ts[start:end]])
            dist.all_reduce(flat, group=group)
            offset = 0
            for t in ts[start:end]:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
            start = end


def global_ratio(numerator: torch.Tensor, denominator: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(this rank's loss, the global loss) of a loss ``sum / sum`` whose rows
    the dp ranks share: the rank's numerator over the denominator summed over
    the dp group (the gradient to sum), and the summed numerator over it (the
    value to log, detached). One rank: the ratio twice."""
    if mesh.dp == 1:
        loss = numerator / denominator.clamp_min(1e-12)
        return loss, loss.detach()
    both = torch.stack([numerator.detach().float(), denominator.detach().float()])
    dist.all_reduce(both, group=mesh.dp_group)
    den = both[1].clamp_min(1e-12)
    return numerator / den, both[0] / den


class _GatherRows(torch.autograd.Function):
    """The dp group's row shards concatenated in rank order; backward this
    rank's rows of the gradient (every rank computes the same loss on the
    whole batch, so the gradient of its rows is its own)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch from this rank's rows ``x`` (differentiable)."""
    return x if mesh.dp == 1 else _GatherRows.apply(x, mesh.dp_group)


class DataParallelOptimizer:
    """A ``torch.optim`` optimizer over the dp group, with the interface the
    solvers use (``param_groups``, ``step``, ``zero_grad``, ``state_dict``,
    ``load_state_dict``).

    :meth:`step` first sums the gradients over the group. Without ZeRO-1 every
    rank then steps ``make(param_groups)`` on the whole parameters, the moments
    replicated. With ZeRO-1 a parameter with an axis divisible by dp
    (``mesh.zero1_axis``, never its tp axis) is stepped on this rank's slice
    along it, so its moments are that slice, and the new slices are
    all-gathered into it; one without such an axis is stepped whole on every
    rank. Adam and AdamW are elementwise, so the update is the replicated
    optimizer's. :meth:`state_dict` gathers the moments into the whole
    parameters' layout (a collective), and :meth:`load_state_dict` takes that
    layout: a checkpoint resumes at any dp."""

    def __init__(self, make: Callable[[list[dict]], torch.optim.Optimizer], groups: list[dict], mesh: Mesh,
                 zero1: bool, model: nn.Module):
        self.mesh, self.zero1 = mesh, bool(zero1)
        names = {id(p): n for n, p in model.named_parameters()}
        groups = [dict(g, params=list(g["params"])) for g in groups]
        self._slots: list[tuple[torch.Tensor, torch.Tensor, int | None]] = []  # (param, what the optimizer steps, axis)
        for g in groups:
            for p in g["params"]:
                split = torch_tp_split(names.get(id(p), ""))
                axis = zero1_axis(p.shape, mesh.dp, () if split is None else (split[1],)) if self.zero1 else None
                shard = p if axis is None else self._slice(p.detach(), axis).clone()
                self._slots.append((p, shard, axis))
        shards = iter(s for _, s, _ in self._slots)
        self.inner = make([dict(g, params=[next(shards) for _ in g["params"]]) for g in groups])
        self.param_groups = groups if self.zero1 else self.inner.param_groups

    def _slice(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        n = t.shape[axis] // self.mesh.dp
        return t.narrow(axis, self.mesh.dp_rank * n, n)

    def _gather(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in range(self.mesh.dp)]
        dist.all_gather(parts, t.contiguous(), group=self.mesh.dp_group)
        return torch.cat(parts, axis)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p, shard, _ in self._slots:
            p.grad = shard.grad = None

    @torch.no_grad()
    def step(self) -> None:
        if self.mesh.dp > 1:
            all_reduce_sum_((p.grad for p, _, _ in self._slots if p.grad is not None), self.mesh.dp_group)
        if not self.zero1:
            self.inner.step()
            return
        for mine, inner in zip(self.param_groups, self.inner.param_groups):
            inner.update({k: v for k, v in mine.items() if k != "params"})
        for p, shard, axis in self._slots:
            if shard is not p:
                shard.copy_(self._slice(p.detach(), axis))
                shard.grad = None if p.grad is None else self._slice(p.grad, axis).contiguous()
        self.inner.step()
        for p, shard, axis in self._slots:
            if shard is not p and p.grad is not None:
                p.copy_(self._gather(shard, axis))

    def state_dict(self) -> dict:
        """torch's layout for the whole parameters (moments gathered)."""
        state = self.inner.state_dict()
        if not self.zero1:
            return state
        for i, (p, shard, axis) in enumerate(self._slots):
            if shard is not p and i in state["state"]:
                state["state"][i] = {k: self._gather(v, axis) if torch.is_tensor(v) and v.dim() else v
                                     for k, v in state["state"][i].items()}
        return state

    def load_state_dict(self, state: dict) -> None:
        if self.zero1:
            state = {**state, "state": {i: {k: self._slice(v, self._slots[i][2]).clone()
                                             if torch.is_tensor(v) and v.dim() and self._slots[i][2] is not None
                                             else v for k, v in st.items()}
                                        for i, st in state["state"].items()}}
            for mine, saved in zip(self.param_groups, state["param_groups"]):
                mine.update({k: v for k, v in saved.items() if k != "params"})
        self.inner.load_state_dict(state)

    def moment_bytes(self) -> int:
        """Bytes of optimizer state this rank holds."""
        return sum(v.numel() * v.element_size() for st in self.inner.state.values() for v in st.values()
                   if torch.is_tensor(v))


def data_parallel(make: Callable[[list[dict]], torch.optim.Optimizer], groups: list[dict], mesh: Mesh, zero1: bool,
                  model: nn.Module):
    """``make(groups)`` itself on one dp rank; a :class:`DataParallelOptimizer`
    over more."""
    if mesh.dp == 1:
        return make(groups)
    return DataParallelOptimizer(make, groups, mesh, zero1, model)


def barrier(mesh: Mesh) -> None:
    """Every rank of a mesh of more than one waits for the others."""
    if mesh.size > 1:
        dist.barrier()
