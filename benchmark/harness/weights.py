"""Seeded weights, made on the device in one call.

The benchmark makes the weights and hands the same tensors' values to the
program (``load_state_dict``) and to the plain reference, which makes them
again from the seed. One ``torch.randn`` over every parameter's values
from a generator on the device, then views of it scaled in place: a matrix
or kernel N(0, 1 / fan_in), a norm's gain 1 + N(0, 0.05^2), every other
vector (a bias, a norm's shift) N(0, 0.02^2).
"""

from __future__ import annotations

import math

import torch


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed from the run's seed and a stream number."""
    return (int(seed) * 1_000_003 + int(stream) * 7_919 + 1) & ((1 << 63) - 1)


def seeded_weights(spec: list[tuple[str, tuple[int, ...]]], seed: int, stream: int, device,
                   dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``spec`` ([(name, shape)], the order fixes the
    values), as views of one buffer in ``dtype`` on ``device``."""
    sizes = [math.prod(shape) for _, shape in spec]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for (name, shape), n in zip(spec, sizes):
        view = flat[offset: offset + n].view(shape)
        offset += n
        if len(shape) >= 2:
            view.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif name.endswith("weight"):
            view.mul_(0.05).add_(1.0)
        else:
            view.mul_(0.02)
        out[name] = view
    if dtype != torch.float32:
        flat = flat.to(dtype)
        out, offset = {}, 0
        for (name, shape), n in zip(spec, sizes):
            out[name] = flat[offset: offset + n].view(shape)
            offset += n
    return out
