"""Parallelism over ``torch.distributed`` (counterpart of ``mer_tpu/parallel``):
the (dp, tp, sp, pp) mesh and its sharding rules (``mesh``), Megatron tensor
parallelism (``tensor``), data parallelism and ZeRO-1 (``data``), the
differentiable ring hop (``hop``), and GPipe over the pp axis (``pipeline``,
``pp_forward``; imported by name: they need the models). Ring attention over
the sp axis is ``mer_tpu_torch.ops.ring_attention``."""

from mer_tpu_torch.parallel.mesh import (
    Mesh,
    dp_row_shard,
    initialize_distributed,
    local_device,
    make_mesh,
    mesh_from_config,
    pad_batch_to_dp,
    partition_spec_for,
    shard_params,
    zero1_param_specs,
)
from mer_tpu_torch.parallel.tensor import full_state_dict, tensor_parallel_

__all__ = [
    "Mesh", "dp_row_shard", "full_state_dict", "initialize_distributed", "local_device", "make_mesh",
    "mesh_from_config", "pad_batch_to_dp", "partition_spec_for", "shard_params", "tensor_parallel_",
    "zero1_param_specs",
]
