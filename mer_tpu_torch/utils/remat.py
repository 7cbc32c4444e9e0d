"""Rematerialisation of encoder layers (counterpart of ``mer_tpu/utils/remat.py``).

``--remat`` recomputes each encoder layer in the backward instead of keeping
its activations; ``--remat-policy`` says what is kept:

- ``full``: nothing (``torch.utils.checkpoint``, non-reentrant): one more
  forward of every layer in the backward;
- ``dots``: the outputs of the matrix products (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``), by selective checkpointing; the elementwise chain (bias,
  GELU, dropout, LayerNorm) and the attention kernel are recomputed;
- ``dots_no_batch``: the products without a batch dimension (``mm``,
  ``addmm``).

The attention kernels are called through ``ctypes``, which no dispatcher
sees: only the aten ops around them are (the ``empty`` that holds their
output among them, recomputed under every policy), so a recompute launches
the forward kernel again.

Dropout under a recompute: ``torch.utils.checkpoint`` restores the default
CPU and CUDA generators, which ``F.dropout`` draws from, but not the host
generator the attention kernels take their seed words from
(``ops/attention.py``). :func:`checkpointed` restores that one too, so the
recompute draws the masks of the forward.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

REMAT_POLICIES = ("full", "dots", "dots_no_batch")


def _saved_ops(name: str) -> list:
    aten = torch.ops.aten
    return {"dots": [aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default],
            "dots_no_batch": [aten.mm.default, aten.addmm.default]}[name]


def resolve_remat_policy(name: str | None) -> Callable[[], Any] | None:
    """Policy name -> the ``context_fn`` of a selective checkpoint (None: save
    nothing, ``full``); an unknown name raises ``ValueError``."""
    if name is None or name == "full":
        return None
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; choose from {list(REMAT_POLICIES)}")
    return functools.partial(create_selective_checkpoint_contexts, _saved_ops(name))


def checkpointed(fn: Callable[..., torch.Tensor], *args, policy: str | None = None,
                 generators: Sequence[torch.Generator] = ()) -> torch.Tensor:
    """``fn(*args)``, its activations recomputed in the backward by
    ``policy``; ``generators`` (host generators ``fn`` draws from) are put
    back where the forward found them before the recompute."""
    states = [(g, g.get_state()) for g in generators]

    def run(*a):
        for g, state in states:
            g.set_state(state)
        return fn(*a)

    context_fn = resolve_remat_policy(policy)
    kwargs = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=True, **kwargs)


__all__ = ["REMAT_POLICIES", "checkpointed", "resolve_remat_policy"]
