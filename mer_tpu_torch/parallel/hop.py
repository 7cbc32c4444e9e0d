"""One hop around a process group's ring, differentiable: the point-to-point
transfer that ring attention (``ops/ring_attention.py``) rotates K and V with
and that the pipeline (``parallel/pipeline.py``) hands activations on with.

:func:`rotate` posts one hop (send to rank + 1, receive from rank - 1, or the
other way) as one ``torch.distributed.batch_isend_irecv``; :class:`Hop` is
the received tensor as a function of the sent one, whose backward sends the
gradient back one hop. Every rank of the group must post the same hops in
the same order, forward and backward: a rank whose received tensor never
reaches its loss would skip a backward hop and leave its neighbours waiting.

gloo sends and receives host memory alone, so under gloo a CUDA tensor goes
through a host copy each way (two ranks sharing one card run on gloo, as
NCCL takes one rank a card). Tensors travel as their bytes, whatever their
dtype.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(group, tensor: torch.Tensor) -> bool:
    """Whether ``tensor`` goes through host memory on ``group`` (gloo and a CUDA tensor)."""
    return tensor.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


class Rotation:
    """Posted sends and receives of one hop; :meth:`wait` returns the received tensors."""

    def __init__(self, requests, buffers, outputs):
        self.requests, self.buffers, self.outputs = requests, buffers, outputs

    def wait(self) -> list[torch.Tensor]:
        for request in self.requests:
            request.wait()
        for buf, out in zip(self.buffers, self.outputs):
            if buf.data_ptr() != out.data_ptr():
                _bytes(out).copy_(buf)
        return self.outputs


def rotate(tensors: list[torch.Tensor], group, back: bool = False) -> Rotation:
    """Post one hop of ``tensors`` around ``group``'s ring: to rank + 1 and
    from rank - 1 (``back``: the other way)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    to, frm = ((r - 1) % n, (r + 1) % n) if back else ((r + 1) % n, (r - 1) % n)
    to, frm = dist.get_global_rank(group, to), dist.get_global_rank(group, frm)
    outputs = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
    host = [_staged(group, t) for t in tensors]
    sends = [_bytes(t).cpu() if h else _bytes(t) for t, h in zip(tensors, host)]
    buffers = [torch.empty(o.numel() * o.element_size(), dtype=torch.uint8) if h else _bytes(o)
               for o, h in zip(outputs, host)]
    ops = [dist.P2POp(dist.isend, t, to, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, b, frm, group) for b in buffers]
    return Rotation(dist.batch_isend_irecv(ops), buffers, outputs)


class Hop(torch.autograd.Function):
    """The tensor received from the ring's previous rank, as a function of the
    one this rank sent on: backward sends the gradient back one hop."""

    @staticmethod
    def forward(ctx, sent, received, group):
        ctx.group = group
        return received.view_as(received)

    @staticmethod
    def backward(ctx, g):
        return rotate([g.contiguous()], ctx.group, back=True).wait()[0], None, None


def broadcast_(tensor: torch.Tensor, src: int, group) -> torch.Tensor:
    """``tensor`` overwritten in place on every rank of ``group`` by the global
    rank ``src``'s, as bytes (through the host for a CUDA tensor under gloo)."""
    flat = _bytes(tensor)
    if _staged(group, tensor):
        host = flat.cpu()
        dist.broadcast(host, src, group=group)
        flat.copy_(host)
    else:
        dist.broadcast(flat, src, group=group)
    if flat.data_ptr() != tensor.data_ptr():
        tensor.copy_(flat.view(tensor.dtype).view_as(tensor))
    return tensor
