"""Ring attention over the sequence-parallel axis (counterpart of
``mer_tpu/ops/ring_attention.py``).

Q, K and V are cut along the sequence into ``sp`` shards [B, H, S / sp, Dh].
Each query shard attends to every key shard in ``sp`` steps; K, V and the key
padding mask move one hop around the ring per step, and the rotation for
step t + 1 is posted before step t's block, so that it overlaps the block's
work. Peak memory per shard is O(S / sp) for K and V.

Two rings:

- a real one, over a process group (``mesh.sp_group``): each rank holds its
  shards, the rotation is ``torch.distributed.batch_isend_irecv`` (send to
  rank + 1, receive from rank - 1), and its autograd node sends the
  gradient back the other way (``parallel/hop.py``, which the pipeline
  shares);
- a local one (``group=None``): the sp shards on one device, the rotation a
  list index, the counterpart of ``mer_tpu``'s ring on a virtual CPU mesh.

Per block the device picks, as everywhere in the port:

- CUDA tensors: :class:`~mer_tpu_torch.ops.flash_attention.FlashAttention`,
  out and lse from K1 (K3 above ``STREAM_THRESHOLD`` keys a block), and in
  the backward K4 (K2 up to ``BWD_FUSED_MAX`` keys) with the lse cotangent
  the merge hands it: the counterpart of ``_ring_body_kernel``. The blocks
  merge as lse' = logaddexp(lse, lse_t), out' = out e^(lse - lse') + out_t
  e^(lse_t - lse'), in float32;
- CPU tensors: :func:`_block_update`'s plain online-softmax algebra
  (``_ring_body``), autograd through it.

A block whose keys are all padding for a row has K1's convention there (P =
1/Sk, lse below ``FULLY_MASKED_LSE``); it enters the merge at lse -1e30, so
its weight is exactly 0 (and no gradient reaches it) wherever a block of the
row has a key. A row none of whose blocks has one takes the blocks' outs
weighted by their key counts, the mean of V, as the plain full attention
gives. The result does not depend on the convention. For a batch element whose every key is padding
the gradients of q and k are a convention of the backward kernel (their
true value is 0); out and the gradient of v are the plain attention's.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from mer_tpu_torch.ops.attention import dot_product_attention
from mer_tpu_torch.ops.flash_attention import FULLY_MASKED_LSE, NEG_INF, FlashAttention
from mer_tpu_torch.parallel.hop import Hop, rotate

def _block_update(q, k, v, bias, m_prev, l_prev, acc):
    """One online-softmax update (``mer_tpu``'s ``_block_update``): q [B, H,
    Sq, Dh], k/v [B, H, Bk, Dh], bias [B, Bk] additive; m/l [B, H, Sq, 1],
    acc [B, H, Sq, Dh] float32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q * (1.0 / math.sqrt(q.shape[-1])), k).float() + bias[:, None, None, :]
    m_new = torch.maximum(m_prev, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + p.sum(-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return m_new, l_new, acc_new


class _PlainBody:
    """The CPU block: :func:`_block_update` over (m, l, acc)."""

    @staticmethod
    def init(q):
        b, h, sq, dh = q.shape
        return (q.new_full((b, h, sq, 1), NEG_INF, dtype=torch.float32), q.new_zeros((b, h, sq, 1), dtype=torch.float32),
                q.new_zeros((b, h, sq, dh), dtype=torch.float32))

    @staticmethod
    def update(state, q, k, v, mask):
        return _block_update(q, k, v, torch.where(mask, NEG_INF, 0.0), *state)

    @staticmethod
    def finish(state, q):
        _, l, acc = state
        return (acc / l.clamp_min(1e-30)).to(q.dtype)


class _KernelBody:
    """The kernels' block: (out, lse) from :class:`FlashAttention`, merged by
    logsumexp weights in float32. State: the merged (out, lse) of the blocks
    with keys, and beside it the key-count-weighted sum of the fully masked
    blocks' outs and their key count (used by a row whose every block is
    masked)."""

    @staticmethod
    def init(q):
        b, h, sq, dh = q.shape
        zeros = q.new_zeros((b, h, sq, dh), dtype=torch.float32)
        return zeros, q.new_full((b, h, sq), NEG_INF, dtype=torch.float32), zeros, q.new_zeros((b, h, sq, 1))

    @staticmethod
    def update(state, q, k, v, mask):
        out, lse, masked_out, masked_keys = state
        blk_out, blk_lse = FlashAttention.apply(q, k, v, mask, None, 0.0)
        masked = blk_lse < FULLY_MASKED_LSE
        blk_lse = blk_lse.masked_fill(masked, NEG_INF)  # e^(-1e30 - lse') is 0: no weight, no gradient
        new_lse = torch.logaddexp(lse, blk_lse)
        out = out * torch.exp(lse - new_lse)[..., None] + blk_out.float() * torch.exp(blk_lse - new_lse)[..., None]
        keys = masked[..., None] * float(k.shape[2])
        return out, new_lse, masked_out + blk_out.float() * keys, masked_keys + keys

    @staticmethod
    def finish(state, q):
        out, lse, masked_out, masked_keys = state
        return torch.where((lse < FULLY_MASKED_LSE)[..., None], masked_out / masked_keys.clamp_min(1.0), out).to(q.dtype)


def _body(q):
    return _KernelBody if q.device.type == "cuda" else _PlainBody


def _group_ring(q, k, v, mask, group):
    """This rank's output shard of the ring over ``group``."""
    body, sp = _body(q), dist.get_world_size(group)
    q, k, v, mask = q.contiguous(), k.contiguous(), v.contiguous(), mask.contiguous()
    state = body.init(q)
    for t in range(sp):
        pending = rotate([k, v, mask.to(torch.uint8)], group) if t < sp - 1 else None
        state = body.update(state, q, k, v, mask)
        if pending is not None:
            k_next, v_next, mask_next = pending.wait()
            k, v, mask = Hop.apply(k, k_next, group), Hop.apply(v, v_next, group), mask_next.bool()
    return body.finish(state, q)


def _local_ring(q, k, v, mask, sp: int):
    """The ring of ``sp`` shards on one device: shard i at step t holds the
    keys of shard (i - t) mod sp, as rank i of a real ring does."""
    body = _body(q)
    qs, ks, vs, ms = ([part.contiguous() for part in t.chunk(sp, axis)] for t, axis in ((q, 2), (k, 2), (v, 2), (mask, 1)))
    states = [body.init(qi) for qi in qs]
    for t in range(sp):
        for i in range(sp):
            j = (i - t) % sp
            states[i] = body.update(states[i], qs[i], ks[j], vs[j], ms[j])
    return torch.cat([body.finish(state, qi) for state, qi in zip(states, qs)], 2)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, key_padding_mask: torch.Tensor | None = None,
                   sp: int | None = None, group=None) -> torch.Tensor:
    """Context-parallel attention, differentiable.

    ``group`` (the sp process group): q, k, v are this rank's shards [B, H,
    S / sp, Dh] (rank r of the group holds the r-th), ``key_padding_mask``
    [B, S / sp] bool (True = ignore); returns this rank's output shard.
    Without ``group``: a local ring of ``sp`` shards, q, k, v [B, H, S, Dh]
    whole on one device, mask [B, S]; returns [B, H, S, Dh]. S not divisible
    by sp raises ``ValueError``."""
    b, h, s, dh = q.shape
    if key_padding_mask is None:
        key_padding_mask = torch.zeros((b, k.shape[2]), dtype=torch.bool, device=q.device)
    if group is not None:
        return _group_ring(q, k, v, key_padding_mask, group)
    if sp is None or sp < 1:
        raise ValueError("a local ring needs sp >= 1 shards")
    if s % sp != 0 or k.shape[2] % sp != 0:
        raise ValueError(f"sequence length {s} must divide sp={sp}")
    return _local_ring(q, k, v, key_padding_mask, sp)


def sequence_parallel_attention(q, k, v, *, mesh=None, key_padding_mask=None):
    """The ring over ``mesh``'s sp group when its sp > 1 (q, k, v and the
    mask this rank's shards), else :func:`dot_product_attention`."""
    if mesh is not None and mesh.sp > 1:
        return ring_attention(q, k, v, key_padding_mask=key_padding_mask, group=mesh.sp_group)
    return dot_product_attention(q, k, v, key_padding_mask=key_padding_mask)
