"""Process groups and sharding rules (counterpart of ``mer_tpu/parallel/mesh.py``).

``mer_tpu`` names a (dp, tp[, sp]) device mesh, annotates shardings and lets
XLA insert the collectives. The port runs one process per card
(``torchrun``), builds each mesh axis as ``torch.distributed`` process
groups and writes the collectives out:

- ``dp``: every rank builds the same global batch and takes its row shard
  (:func:`pad_batch_to_dp`, :func:`dp_row_shard`); gradients are summed over
  the dp group (``parallel/data.py``); with ZeRO-1 each rank keeps its slice
  of the Adam moments (:func:`zero1_axis`);
- ``tp``: Megatron column and row splits of the attention and feed-forward
  linears by :data:`_TP_RULES`, one all-reduce after each row-parallel
  product (``parallel/tensor.py``);
- ``sp``: ring attention over the sp group (``ops/ring_attention.py``);
- ``pp``: pipeline stages of an encoder's layers (``parallel/pipeline.py``),
  innermost, as ``mer_tpu``'s (dp, pp) mesh has it.

Ranks are laid out as ``mer_tpu``'s device array (row-major over (dp, tp,
sp, pp)): rank = ((dp_rank * tp + tp_rank) * sp + sp_rank) * pp + pp_rank,
so a pp, sp or tp group is ranks that are neighbours. :func:`initialize_distributed` reads the
``torchrun`` environment (or explicit arguments) and takes NCCL for CUDA and
gloo for the CPU; each rank's device is ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

# -- the process group ---------------------------------------------------------------


def initialize_distributed(init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
                           backend: str | None = None, device: str = "cuda") -> bool:
    """``torch.distributed.init_process_group`` from ``torchrun``'s
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
    or the arguments; a no-op for one process and when a group exists.
    ``backend`` defaults to NCCL for ``device`` "cuda" (which also selects
    ``cuda:LOCAL_RANK``) and gloo for "cpu". True when a group is up."""
    if dist.is_initialized():
        return True
    world_size = int(os.environ.get("WORLD_SIZE", 1) if world_size is None else world_size)
    if world_size <= 1:
        return False
    rank = int(os.environ.get("RANK", 0) if rank is None else rank)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(backend or ("nccl" if on_card else "gloo"), init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def local_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for "cuda", else ``device``."""
    if torch.device(device).type != "cuda" or torch.device(device).index is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def mesh_shape(dp: int = -1, tp: int = 1, sp: int = 1, n: int = 1, pp: int = 1) -> tuple[int, int, int]:
    """(dp, tp, sp) by ``mer_tpu``'s sizing rules over ``n`` ranks, ``pp``
    of them a pipeline's stages: dp = -1 takes the rest, and a mesh that
    needs more ranks than exist raises ``ValueError`` (as does one left
    without a dp rank: tp x sp x pp above n)."""
    tp, sp, pp = max(int(tp), 1), max(int(sp), 1), max(int(pp), 1)
    dp = n // (tp * sp * pp) if int(dp) == -1 else int(dp)
    if dp < 1 or dp * tp * sp * pp > n:
        shape = "x".join(map(str, (dp, tp, sp) + ((pp,) if pp > 1 else ())))
        raise ValueError(f"mesh {shape} needs {max(dp, 1) * tp * sp * pp} devices, have {n}")
    return dp, tp, sp


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (dp, tp, sp, pp) mesh and its groups (None
    for an axis of size 1). ``size`` is dp x tp x sp x pp; ranks past it (a
    mesh smaller than the world, as ``mer_tpu`` allows) hold no place and
    raise when they build one."""

    dp: int = 1
    tp: int = 1
    sp: int = 1
    rank: int = 0
    dp_group: Any = None
    tp_group: Any = None
    sp_group: Any = None
    pp: int = 1
    pp_group: Any = None

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.sp * self.pp

    @property
    def dp_rank(self) -> int:
        return self.rank // (self.tp * self.sp * self.pp)

    @property
    def tp_rank(self) -> int:
        return self.rank // (self.sp * self.pp) % self.tp

    @property
    def sp_rank(self) -> int:
        return self.rank // self.pp % self.sp

    @property
    def pp_rank(self) -> int:
        return self.rank % self.pp


def make_mesh(dp: int = -1, tp: int = 1, sp: int = 1, pp: int = 1) -> Mesh:
    """The (dp, tp, sp, pp) mesh over the initialized process group (one
    rank without one). Every rank builds every group, in one order, as
    ``torch.distributed.new_group`` requires, and keeps its own."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    pp = max(int(pp), 1)
    dp, tp, sp = mesh_shape(dp, tp, sp, world, pp)
    mesh = Mesh(dp, tp, sp, rank, pp=pp)
    if world == 1:
        return mesh
    sizes = {"dp": dp, "tp": tp, "sp": sp, "pp": pp}
    coords = [dict(zip(sizes, c)) for c in np.ndindex(dp, tp, sp, pp)]  # row-major: the rank is the index
    for axis, size in sizes.items():
        if size == 1:
            continue
        groups: dict[tuple, list[int]] = {}
        for r, c in enumerate(coords):
            groups.setdefault(tuple(v for a, v in c.items() if a != axis), []).append(r)
        for ranks in groups.values():
            group = dist.new_group(ranks)
            if rank in ranks:
                setattr(mesh, f"{axis}_group", group)
    if rank >= mesh.size:
        shape = "x".join(map(str, (dp, tp, sp) + ((pp,) if pp > 1 else ())))
        raise ValueError(f"rank {rank} has no place in the {shape} mesh of a world of {world}")
    return mesh


def mesh_from_config(config) -> Mesh:
    """:func:`make_mesh` from the ``tpu.mesh`` block (``src/config.yaml``)."""
    cfg = config.get_path("tpu.mesh", {}) or {}
    return make_mesh(dp=int(cfg.get("dp", -1)), tp=int(cfg.get("tp", 1)), sp=int(cfg.get("sp", 1)))


# -- tensor-parallel rules -------------------------------------------------------------
#
# ``mer_tpu``'s table, kept as data: a parameter path ("/"-joined, its param
# tree's names) -> the mesh axis of each array axis (None: replicated). q, k, v
# and the first feed-forward linear split their outputs (column parallel), the
# attention output and the second feed-forward linear their inputs (row
# parallel); everything else is replicated. Scan-stacked layers carry a
# leading layer axis.

_TP_RULES: list[tuple[str, tuple]] = [
    (r".*layers_scan/.*(q_proj|k_proj|v_proj|query|key|value)/kernel$", (None, None, "tp")),
    (r".*layers_scan/.*(q_proj|k_proj|v_proj|query|key|value)/bias$", (None, "tp")),
    (r".*layers_scan/.*(out_proj|attention_output)/kernel$", (None, "tp", None)),
    (r".*layers_scan/.*(linear1|intermediate)/kernel$", (None, None, "tp")),
    (r".*layers_scan/.*(linear1|intermediate)/bias$", (None, "tp")),
    (r".*layers_scan/.*(linear2|output)/kernel$", (None, "tp", None)),
    (r".*(q_proj|k_proj|v_proj|query|key|value)/kernel$", (None, "tp")),
    (r".*(q_proj|k_proj|v_proj|query|key|value)/bias$", ("tp",)),
    (r".*(out_proj|attention_output)/kernel$", ("tp", None)),
    (r".*(linear1|intermediate)/kernel$", (None, "tp")),
    (r".*(linear1|intermediate)/bias$", ("tp",)),
    (r".*(linear2|output)/kernel$", ("tp", None)),
]


def partition_spec_for(path: str) -> tuple:
    """The split of the parameter at ``path`` (a ``mer_tpu`` path string):
    the mesh axis name or None per array axis; () replicates."""
    for pattern, spec in _TP_RULES:
        if re.match(pattern, path):
            return spec
    return ()


def zero1_param_specs(shapes: Mapping[str, Sequence[int]], dp: int,
                      specs: Mapping[str, tuple] | None = None) -> dict[str, tuple]:
    """ZeRO-1 specs of the parameters ``shapes`` (path -> shape): each TP
    spec (``specs``, by default :func:`partition_spec_for`) with "dp" on its
    largest unsharded axis divisible by ``dp``; unchanged where none is, for
    a scalar and at dp 1."""
    out = {}
    for path, shape in shapes.items():
        spec = tuple(specs[path]) if specs is not None else partition_spec_for(path)
        names = list(spec) + [None] * (len(shape) - len(spec))
        axis = zero1_axis(shape, dp, [a for a, name in enumerate(names) if name is not None])
        if axis is not None:
            names[axis] = "dp"
            spec = tuple(names)
        out[path] = spec
    return out


# The same splits in the port's ``state_dict`` names (torch's [out, in]
# weights): "column" splits axis 0 of a weight and its bias, "row" axis 1 of a
# weight (its bias is added once, after the all-reduce), "packed" splits each
# third of ``nn.MultiheadAttention``'s stacked q, k, v ``in_proj``.
TORCH_TP_RULES: list[tuple[str, str]] = [
    (r".*in_proj_(weight|bias)$", "packed"),
    (r".*(q_proj|k_proj|v_proj|query|key|value)\.(weight|bias)$", "column"),
    (r".*(out_proj|attention\.output\.dense)\.weight$", "row"),
    (r".*(linear1|intermediate\.dense|intermediate_dense)\.(weight|bias)$", "column"),
    (r".*(linear2|output\.dense|output_dense)\.weight$", "row"),
]


def torch_tp_split(name: str) -> tuple[str, int] | None:
    """(kind, axis) of the ``state_dict`` entry ``name`` under tp, or None
    for a replicated one."""
    for pattern, kind in TORCH_TP_RULES:
        if re.match(pattern, name):
            return kind, 1 if kind == "row" else 0
    return None


def tp_slice(name: str, tensor: torch.Tensor, tp_rank: int, tp: int) -> torch.Tensor:
    """Rank ``tp_rank``'s part of ``tensor`` (the ``state_dict`` entry
    ``name``) among ``tp``; the whole tensor where it is replicated."""
    split = torch_tp_split(name)
    if split is None or tp == 1:
        return tensor
    kind, axis = split
    if kind == "packed":
        return torch.cat([part.chunk(tp, 0)[tp_rank] for part in tensor.chunk(3, 0)])
    if tensor.shape[axis] % tp:
        raise ValueError(f"{name}: axis {axis} of {tuple(tensor.shape)} does not divide tp={tp}")
    return tensor.chunk(tp, axis)[tp_rank]


def shard_params(state_dict: Mapping[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's ``state_dict``: every tensor sliced by
    :data:`TORCH_TP_RULES` for its tp rank (contiguous copies), replicated
    over dp and sp."""
    return {name: tp_slice(name, t, mesh.tp_rank, mesh.tp).contiguous() for name, t in state_dict.items()}


def zero1_axis(shape: Sequence[int], dp: int, skip: Sequence[int] = ()) -> int | None:
    """The axis of a ``shape`` parameter whose slices ZeRO-1 gives the dp
    ranks: the largest divisible by ``dp`` (the first of equals) not in
    ``skip`` (its tp-split axes); None when none is, or at dp 1."""
    best, best_size = None, 0
    for axis, size in enumerate(shape):
        if dp > 1 and axis not in skip and size % dp == 0 and size > best_size:
            best, best_size = axis, size
    return best


# -- the batch ---------------------------------------------------------------------------


def _pad_rows(x, rem: int):
    """``rem`` pad rows under ``x``: -1 for integers (ignored labels), True for
    masks (padding everywhere in the repo), 0 otherwise; numpy or torch."""
    if isinstance(x, torch.Tensor):
        fill = True if x.dtype == torch.bool else (0 if x.dtype.is_floating_point else -1)
        return torch.cat([x, torch.full((rem, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)])
    block = np.zeros((rem,) + x.shape[1:], dtype=x.dtype)
    if x.dtype.kind in "iu":
        block[...] = -1
    elif x.dtype.kind == "b":
        block[...] = True
    return np.concatenate([x, block], axis=0)


def pad_batch_to_dp(batch: Mapping[str, Any], dp: int) -> dict:
    """Pad the leading dim of every array (numpy or torch) so that it divides
    ``dp``, as ``mer_tpu``'s; an all-padding row of ``padding_mask`` keeps key
    0 attendable."""
    out = {}
    for key, x in batch.items():
        rem = (-x.shape[0]) % dp
        out[key] = _pad_rows(x, rem) if rem else x
    if "padding_mask" in out:
        pm = out["padding_mask"]
        empty = pm.all(axis=-1) if isinstance(pm, np.ndarray) else pm.all(dim=-1)
        if empty.any():
            pm = pm.copy() if isinstance(pm, np.ndarray) else pm.clone()
            pm[empty, 0] = False
        out["padding_mask"] = pm
    return out


def dp_row_shard(batch: Mapping[str, Any], dp: int, dp_rank: int) -> dict:
    """Rank ``dp_rank``'s contiguous rows of :func:`pad_batch_to_dp`'s batch."""
    padded = pad_batch_to_dp(batch, dp)
    return {k: x[x.shape[0] // dp * dp_rank: x.shape[0] // dp * (dp_rank + 1)] for k, x in padded.items()}
