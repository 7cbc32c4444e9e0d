"""Tensor parallelism: Megatron column and row splits over the tp group.

``mer_tpu`` annotates the splits (``parallel/mesh.py::_TP_RULES``) and XLA
inserts the collectives; here they are written out, as in Megatron-LM:

- a column-parallel linear (q, k, v, the first feed-forward linear) holds
  its rank's rows of the weight and bias; its input is replicated, so the
  forward is local and the backward sums the input's gradient over the
  group (:class:`_CopyToGroup`);
- a row-parallel linear (the attention output, the second feed-forward
  linear) holds its rank's columns of the weight; its input is the rank's
  slice (a column-parallel output through an elementwise op, or the heads
  of its attention), so its product is a partial sum: one all-reduce, in
  float32, then the whole bias, then the activation's dtype again
  (:class:`_ReduceFromGroup`). A row-parallel linear whose input is
  replicated (RoBERTa's classifier ``out_proj``, which the rules split too)
  first takes the rank's slice of it.

Attention modules keep ``num_heads / tp`` heads, so the attention kernels
see a tp-th of the heads. Replicated parameters get the same gradient on
every tp rank; sharded ones their own. :func:`tensor_parallel_` slices a
model in place by ``mesh.TORCH_TP_RULES``; :func:`full_state_dict` gathers
it back into the reference layout.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mer_tpu_torch.parallel.mesh import Mesh, tp_slice, torch_tp_split


def all_reduce_f32(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor in ``t``'s dtype),
    added in float32 (gloo has no bf16 sum)."""
    out = t.to(torch.float64 if t.dtype == torch.float64 else torch.float32, copy=True).contiguous()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_f32(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SliceForGroup(torch.autograd.Function):
    """This rank's slice of the last axis forward; backward the gradient of
    the whole input (every rank's slice, summed into zeros)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, -1)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        full = g.new_zeros(*g.shape[:-1], ctx.width)
        full[..., r * g.shape[-1]:(r + 1) * g.shape[-1]] = g
        return all_reduce_f32(full, ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def tp_linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``layer`` applied to ``x`` (operands cast to ``dtype`` when given),
    column- or row-parallel as :func:`tensor_parallel_` marked it."""
    kind, group = getattr(layer, "tp", (None, None))
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    if kind == "column":
        x = copy_to_group(x, group)
    if kind != "row":
        return F.linear(cast(x), cast(layer.weight), None if layer.bias is None else cast(layer.bias))
    if x.shape[-1] != layer.weight.shape[1]:  # a replicated input: this rank's slice of it
        x = _SliceForGroup.apply(x, group)
    partial = F.linear(cast(x), cast(layer.weight))
    y = _ReduceFromGroup.apply(partial.float(), group)  # f32 sum, f32 bias, rounded once
    return (y if layer.bias is None else y + cast(layer.bias).float()).to(partial.dtype)


class ParallelLinear(nn.Linear):
    """An ``nn.Linear`` whose call is :func:`tp_linear` (its ``tp`` marks the
    kind and group)."""

    def forward(self, x):
        return tp_linear(x, self)


def tensor_parallel_(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Slice ``model`` in place for this rank of ``mesh``'s tp group: each
    parameter named by ``TORCH_TP_RULES`` keeps its rank's part, its linear is
    marked column- or row-parallel, and every attention module keeps
    ``num_heads / tp`` heads. A no-op at tp 1."""
    if mesh.tp == 1:
        return model
    for module in model.modules():
        heads = getattr(module, "num_heads", None)
        if heads is not None and heads % mesh.tp:
            raise ValueError(f"{type(module).__name__}: {heads} heads do not divide tp={mesh.tp}")
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        split = None
        for pname, param in module.named_parameters(recurse=False):
            kind = torch_tp_split(prefix + pname)
            if kind is None:
                continue
            split = kind[0]
            with torch.no_grad():
                param.data = tp_slice(prefix + pname, param.data, mesh.tp_rank, mesh.tp).contiguous()
        if split is None:
            continue
        if isinstance(module, nn.Linear):
            module.__class__ = ParallelLinear
            module.tp = (split, mesh.tp_group)
            module.in_features, module.out_features = module.weight.shape[1], module.weight.shape[0]
        else:  # nn.MultiheadAttention's packed in-projection
            module.tp_group = mesh.tp_group
    for module in model.modules():
        if getattr(module, "num_heads", None) is not None:
            module.num_heads //= mesh.tp
    return model


def _gather_axis(t: torch.Tensor, axis: int, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, axis)


def gather_tp(name: str, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole ``state_dict`` entry ``name`` from this rank's part ``t``
    (every tp rank calls it; the inverse of ``mesh.tp_slice``)."""
    split = torch_tp_split(name)
    if split is None or mesh.tp == 1:
        return t
    kind, axis = split
    if kind == "packed":
        return torch.cat([_gather_axis(part, 0, mesh.tp_group) for part in t.chunk(3, 0)])
    return _gather_axis(t, axis, mesh.tp_group)


def full_state_dict(model: nn.Module, mesh: Mesh) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` in the reference layout, its tp parts gathered
    (a collective: every tp rank calls it)."""
    return {name: gather_tp(name, t.detach(), mesh) for name, t in model.state_dict().items()}


def full_optimizer_state(state: dict, names: list[str], mesh: Mesh) -> dict:
    """An optimizer ``state_dict`` over the parameters ``names`` (in the
    optimizer's order) with every moment's tp parts gathered (a collective)."""
    if mesh.tp == 1:
        return state
    return {**state, "state": {i: {k: gather_tp(names[i], v, mesh) if torch.is_tensor(v) and v.dim() else v
                                   for k, v in st.items()} for i, st in state["state"].items()}}


def shard_optimizer_state(state: dict, names: list[str], mesh: Mesh) -> dict:
    """The inverse of :func:`full_optimizer_state`: this tp rank's parts."""
    if mesh.tp == 1:
        return state
    return {**state, "state": {i: {k: tp_slice(names[i], v, mesh.tp_rank, mesh.tp).clone()
                                   if torch.is_tensor(v) and v.dim() else v for k, v in st.items()}
                               for i, st in state["state"].items()}}
