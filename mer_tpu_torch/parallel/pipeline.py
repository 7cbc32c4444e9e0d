"""Pipeline parallelism over the ``pp`` axis (counterpart of
``mer_tpu/parallel/pipeline.py``): GPipe over an encoder's layers.

``mer_tpu`` runs the schedule as one ``lax.scan`` inside a ``shard_map`` and
lets ``ppermute``'s transpose make the backward the reverse schedule. Here
each rank is one stage and the schedule is a Python loop:

- stage d of pp owns layers d·L/pp ... (d + 1)·L/pp - 1; only it holds their
  parameters (:func:`keep_stage_layers_`, the counterpart of
  ``pipeline_param_sharding``) and so their optimizer state;
- the batch splits into M microbatches fed over M + pp - 1 ticks: at tick t
  stage 0 takes microbatch t, a later stage the buffer its predecessor sent
  at tick t - 1; a stage outside its microbatches (a bubble) holds the
  buffer; the last stage collects the outputs;
- after every tick but the last each stage sends its buffer one hop around
  the pp ring (``parallel/hop.py``: ``batch_isend_irecv``, the gradient sent
  back the other way in the backward). Every rank posts every hop, bubbles
  included, and keeps every received buffer in its graph (stage 0 ties it to
  the microbatch it takes), so the backward's hops pair up on every rank;
- the last stage broadcasts the outputs, and every stage returns them. The
  broadcast's backward keeps the last stage's gradient alone: the last
  stage's loss is the one that counts, and every other stage hands a zero to
  its last buffer only to run its part of the reverse schedule.

Parameters outside the stack (the pre-stack and the head, replicated on
every stage) get their gradient where the graph gives it: the pre-stack's on
stage 0, the head's on the last stage (every stage runs the head on the same
outputs, but only the last one's gradient reaches the stack).
:func:`sync_replicated_grads` copies each from its stage to the others.

Dropout (``seed``): before each (global layer l, microbatch j) call both
dropout streams (the global generators of ``F.dropout`` and the attention's
seed generator) are reseeded from (seed..., l · M + j), as ``mer_tpu`` folds
its key, so for a fixed (L, M) the masks do not depend on pp; they differ
from the non-pipelined model's stream by design, as in ``mer_tpu``.

``remat`` wraps each layer call in ``utils/remat.py``'s checkpoint (True:
recompute everything; a policy name: selective).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mer_tpu_torch.models.layers import attention_generators
from mer_tpu_torch.parallel.hop import Hop, broadcast_, rotate
from mer_tpu_torch.parallel.mesh import Mesh, make_mesh
from mer_tpu_torch.utils.remat import checkpointed


def stages_for(mesh: Mesh) -> int:
    return mesh.pp


def make_pp_mesh(pp: int, dp: int = 1) -> Mesh:
    """A (dp, pp) mesh over the process group; pp innermost, so a stage's
    neighbours are adjacent ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * pp > world:
        raise ValueError(f"mesh {dp}x{pp} needs {dp * pp} devices, have {world}")
    return make_mesh(dp=dp, pp=pp)


def stage_range(n_layers: int, mesh: Mesh) -> range:
    """The global indices of the layers this rank's stage owns."""
    if n_layers % mesh.pp:
        raise ValueError(f"{n_layers} layers not divisible by pp={mesh.pp}")
    per_stage = n_layers // mesh.pp
    return range(mesh.pp_rank * per_stage, (mesh.pp_rank + 1) * per_stage)


class OnAnotherStage(nn.Module):
    """The place of a layer another pipeline stage owns: no parameters."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"layer {self.index} lives on another pipeline stage")


def keep_stage_layers_(layers: nn.ModuleList, mesh: Mesh) -> nn.ModuleList:
    """Replace, in place, every layer this stage does not own by an
    :class:`OnAnotherStage` (its parameters are freed here); a no-op at pp 1."""
    own = stage_range(len(layers), mesh)
    for i in range(len(layers)):
        if i not in own:
            layers[i] = OnAnotherStage(i)
    return layers


def reseed(words: Sequence[int], *modules: nn.Module) -> None:
    """Reseed both dropout streams, ``F.dropout``'s global generators and the
    attention generators of ``modules``, from the seed words ``words``."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(2, np.uint64)
    torch.manual_seed(int(state[0]))
    for generator in attention_generators(*modules):
        generator.manual_seed(int(state[1]))


class _Tie(torch.autograd.Function):
    """``x``, with ``unused`` kept in the graph: its gradient is zero."""

    @staticmethod
    def forward(ctx, x, unused):
        ctx.like = (unused.shape, unused.dtype, unused.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return g, torch.zeros(shape, dtype=dtype, device=device)


class _Collect(torch.autograd.Function):
    """The last stage's outputs on every stage. Backward: the last stage's
    gradient to its outputs; a zero to ``tail`` (this stage's last buffer),
    which runs the stage's part of the reverse schedule."""

    @staticmethod
    def forward(ctx, tail, outputs, group, src, is_src, shape):
        ctx.is_src, ctx.tail = is_src, (tail.shape, tail.dtype, tail.device)
        buf = outputs.clone() if is_src else torch.empty(shape, dtype=tail.dtype, device=tail.device)
        return broadcast_(buf, src, group)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.tail
        return torch.zeros(shape, dtype=dtype, device=device), (g if ctx.is_src else None), None, None, None, None


def pipeline_apply(layers: Sequence[nn.Module], x: torch.Tensor, layer_fn: Callable[..., torch.Tensor], mesh: Mesh,
                   *, microbatches: int | None = None, extra: torch.Tensor | None = None,
                   seed: Sequence[int] | None = None, remat: bool | str = False) -> torch.Tensor:
    """Run ``x`` through the whole layer stack ``layers`` (L entries, this
    stage's own among them), pipelined over ``mesh``'s pp group.

    x: [B, ...], this rank's dp rows; only stage 0 reads its values, the
        other stages its shape, dtype and device.
    layer_fn(layer, x[, extra]) -> x: one layer's forward.
    extra: per-row side input [B, ...] (a key padding mask), microbatched
        alongside x and handed to ``layer_fn``.
    microbatches: M (default pp). The global batch (B x dp rows) must divide
        into M microbatches, L must divide by pp and a microbatch's rows by
        dp, as in ``mer_tpu``.
    seed: the step's seed words; when given, both dropout streams are
        reseeded from (seed..., l · M + j) before layer l runs microbatch j.
    remat: recompute each layer in the backward (True) or by a policy name.

    Returns [B, ...] on every stage."""
    pp, m, b = mesh.pp, microbatches or mesh.pp, x.shape[0] * mesh.dp
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    n_layers = len(layers)
    own = stage_range(n_layers, mesh)
    if mesh.dp > 1 and (b // m) % mesh.dp:
        raise ValueError(f"microbatch rows {b}//{m}={b // m} not divisible by dp={mesh.dp}")

    def call(i: int, h: torch.Tensor, e, j: int) -> torch.Tensor:
        layer = layers[i]

        def run(h, *e):
            if seed is not None:
                reseed((*seed, i * m + j), layer)
            return layer_fn(layer, h, *e)

        args = (h,) if e is None else (h, e)
        if remat and torch.is_grad_enabled():
            return checkpointed(run, *args, policy=None if remat is True else remat,
                                generators=attention_generators(layer))
        return run(*args)

    xm = x.chunk(m)
    em = [None] * m if extra is None else extra.chunk(m)
    d, last = mesh.pp_rank, pp - 1
    # every hop of a training step must record its autograd node on every rank, the first one's zeros too
    trains = torch.is_grad_enabled() and any(p.requires_grad for i in own for p in layers[i].parameters())
    buf = torch.zeros_like(xm[0]).requires_grad_(trains)
    outs: list[torch.Tensor | None] = [None] * m
    for t in range(m + pp - 1):
        j = t - d  # the microbatch this stage works on at tick t
        if 0 <= j < m:
            y = _Tie.apply(xm[j], buf) if d == 0 else buf
            for i in own:
                y = call(i, y, em[j], j)
            if d == last:
                outs[j] = y
        else:
            y = buf  # a bubble holds the buffer
        if pp > 1 and t < m + pp - 2:
            (received,) = rotate([y], mesh.pp_group).wait()
            buf = Hop.apply(y, received, mesh.pp_group)
        else:
            buf = y
    if pp == 1:
        return torch.cat(outs)
    src = dist.get_global_rank(mesh.pp_group, last)
    collected = torch.cat(outs) if d == last else buf
    return _Collect.apply(buf, collected, mesh.pp_group, src, d == last, tuple(x.shape))


def sync_replicated_grads(model: nn.Module, mesh: Mesh, owner: Callable[[str], str | None]) -> None:
    """Copy each replicated parameter's gradient from the stage whose graph
    gives it to the other stages of the pp group: ``owner(name)`` is
    "first" (stage 0: the pre-stack), "last" (the head) or None (a stage's
    own layer, left alone). A stage without a gradient receives into zeros.
    Parameters that do not require grad (a frozen backbone) are skipped."""
    if mesh.pp == 1:
        return
    for name, p in model.named_parameters():
        which = owner(name)
        if which is None or not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        src = dist.get_global_rank(mesh.pp_group, 0 if which == "first" else mesh.pp - 1)
        broadcast_(p.grad, src, mesh.pp_group)


def full_stage_state_dict(model: nn.Module, layers_prefix: str, n_layers: int, mesh: Mesh) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` with every stage's layers (``layers_prefix``
    "{i}." ...), each broadcast from its stage over the pp group: the whole
    model on every rank of the group (a collective)."""
    state = dict(model.state_dict())
    if mesh.pp == 1:
        return state
    own = stage_range(n_layers, mesh)
    template = {k[len(f"{layers_prefix}{own[0]}."):]: v for k, v in state.items()
                if k.startswith(f"{layers_prefix}{own[0]}.")}
    per_stage = len(own)
    for i in range(n_layers):
        src = dist.get_global_rank(mesh.pp_group, i // per_stage)
        for key, like in template.items():
            name = f"{layers_prefix}{i}.{key}"
            t = state[name].detach().clone() if i in own else torch.empty_like(like)
            state[name] = broadcast_(t, src, mesh.pp_group)
    return state


def own_entries(model: nn.Module, state_dict: dict[str, Any]) -> dict[str, Any]:
    """The entries of a whole model's ``state_dict`` this stage holds."""
    mine = model.state_dict()
    return {k: v for k, v in state_dict.items() if k in mine}


__all__ = ["full_stage_state_dict", "keep_stage_layers_", "make_pp_mesh", "own_entries", "pipeline_apply",
           "reseed", "stage_range", "stages_for", "sync_replicated_grads"]
