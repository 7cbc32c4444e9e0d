"""Pipeline-parallel forwards of the fine-tuning models (counterpart of
``mer_tpu/parallel/pp_forward.py``).

The 12-layer encoder stacks of RoBERTa and wav2vec2 go through
:func:`~mer_tpu_torch.parallel.pipeline.pipeline_apply` over the mesh's pp
group; the pre-stack (embeddings; the conv frontend, feature projection and
positional conv) runs on stage 0 alone, the only stage that feeds it to the
pipeline, and the head (RoBERTa's classifier; wav2vec2's masked mean pool and
Linear-Tanh-Linear) on every stage, on the outputs every stage returns. They
call the whole model's own submodules, so no weight is copied, and they hold
a model whose other stages' layers were dropped
(:func:`~mer_tpu_torch.parallel.pipeline.keep_stage_layers_`).

``seed`` (training) is the step's seed words: the pipeline reseeds both
dropout streams per (layer, microbatch), and the pre-stack and the head are
reseeded from (seed..., 2^30) and (seed..., 2^30 + 1) here (past every
l · M + j), so every dropout mask is
a function of the seed alone and every stage draws the head's alike.
:func:`replicated_owner` names the stage whose gradient counts for each
parameter outside the stack (``pipeline.sync_replicated_grads``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mer_tpu_torch.models.roberta import RobertaModel, TextERC
from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Model
from mer_tpu_torch.parallel.mesh import Mesh
from mer_tpu_torch.parallel.pipeline import pipeline_apply, reseed

PRE_STACK, HEAD = 1 << 30, (1 << 30) + 1  # the seed words' last entry for the pre-stack and the head


def _stage0_input(mesh: Mesh, shape, dtype, device, make) -> torch.Tensor:
    """The pipeline's input: ``make()`` on stage 0, a placeholder of its shape elsewhere."""
    return make() if mesh.pp_rank == 0 else torch.empty(shape, dtype=dtype, device=device)


def roberta_hidden_pp(model: RobertaModel, mesh: Mesh, input_ids: torch.Tensor, attention_mask: torch.Tensor, *,
                      seed: Sequence[int] | None = None, microbatches: int | None = None,
                      remat: bool | str = False) -> torch.Tensor:
    """``RobertaModel.forward`` with the layer stack pipelined: [B, S, H]."""
    def embed():
        if seed is not None:
            reseed((*seed, PRE_STACK))
        return model.embeddings(input_ids, model.dtype)

    b, s = input_ids.shape
    hidden = _stage0_input(mesh, (b, s, model.cfg.hidden_size), model.dtype, input_ids.device, embed)
    key_padding_mask = (attention_mask == 0).contiguous()
    return pipeline_apply(model.encoder.layer, hidden, lambda layer, h, kpm: layer(h, kpm, model.dtype), mesh,
                          microbatches=microbatches, extra=key_padding_mask, seed=seed, remat=remat)


def text_erc_logits_pp(model: TextERC, mesh: Mesh, input_ids: torch.Tensor, attention_mask: torch.Tensor, *,
                       seed: Sequence[int] | None = None, microbatches: int | None = None,
                       remat: bool | str = False) -> torch.Tensor:
    """``TextERC.forward`` pipelined over pp: logits [B, num_labels]."""
    hidden = roberta_hidden_pp(model.roberta, mesh, input_ids, attention_mask, seed=seed,
                               microbatches=microbatches, remat=remat)
    if seed is not None:
        reseed((*seed, HEAD))
    return model.classifier_head(hidden, model.dtype)


def wav2vec2_hidden_pp(model: Wav2Vec2Model, mesh: Mesh, waveforms: torch.Tensor, lengths: torch.Tensor, *,
                       seed: Sequence[int] | None = None, microbatches: int | None = None,
                       remat: bool | str = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``Wav2Vec2Model.forward`` with the encoder stack pipelined: (hidden
    [B, T, H], frame counts [B])."""
    cfg = model.cfg
    out_lengths = cfg.feat_extract_output_lengths(lengths.to(torch.int32))
    t = int(cfg.feat_extract_output_lengths(waveforms.shape[1]))
    frame_valid = torch.arange(t, device=waveforms.device)[None, :] < out_lengths[:, None]

    def pre_stack():
        if seed is not None:
            reseed((*seed, PRE_STACK))
        x, _, valid = model.frames(waveforms, lengths)
        return model.encoder.pre_stack(x, valid, model.dtype)

    x = _stage0_input(mesh, (waveforms.shape[0], t, cfg.hidden_size), model.dtype, waveforms.device, pre_stack)
    x = pipeline_apply(model.encoder.layers, x, lambda layer, h, kpm: layer(h, kpm, model.dtype), mesh,
                       microbatches=microbatches, extra=(~frame_valid).contiguous(), seed=seed, remat=remat)
    return x, out_lengths


def audio_erc_logits_pp(model: AudioERC, mesh: Mesh, waveforms: torch.Tensor, lengths: torch.Tensor, *,
                        seed: Sequence[int] | None = None, microbatches: int | None = None,
                        remat: bool | str = False) -> torch.Tensor:
    """``AudioERC.forward`` pipelined over pp: logits [B, num_labels]."""
    hidden, out_lengths = wav2vec2_hidden_pp(model.wav2vec2, mesh, waveforms, lengths, seed=seed,
                                             microbatches=microbatches, remat=remat)
    return model.head(model.pool(hidden, out_lengths))


def replicated_owner(model: nn.Module):
    """``name -> "first" | "last" | None`` for ``model``'s parameters: the
    pre-stack's gradient comes from stage 0, the head's from the last stage,
    a stack layer's stays on its stage."""
    if isinstance(model, TextERC):
        stack, pre = "roberta.encoder.layer.", ("roberta.embeddings.",)
    elif isinstance(model, AudioERC):
        stack = "wav2vec2.encoder.layers."
        pre = ("wav2vec2.feature_extractor.", "wav2vec2.feature_projection.", "wav2vec2.encoder.pos_conv_embed.",
               "wav2vec2.encoder.layer_norm.")
    else:
        raise TypeError(f"no pipeline forward for {type(model).__name__}")

    def owner(name: str) -> str | None:
        if name.startswith(stack):
            return None
        return "first" if name.startswith(pre) else "last"

    return owner


def stack_of(model: nn.Module) -> tuple[nn.ModuleList, str]:
    """(the encoder's layer list, its ``state_dict`` prefix) of a TextERC or AudioERC."""
    if isinstance(model, TextERC):
        return model.roberta.encoder.layer, "roberta.encoder.layer."
    if isinstance(model, AudioERC):
        return model.wav2vec2.encoder.layers, "wav2vec2.encoder.layers."
    raise TypeError(f"no pipeline forward for {type(model).__name__}")


__all__ = ["audio_erc_logits_pp", "replicated_owner", "roberta_hidden_pp", "stack_of", "text_erc_logits_pp",
           "wav2vec2_hidden_pp"]
