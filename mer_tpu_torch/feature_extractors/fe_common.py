"""Shared wiring of the text and wav2vec2 feature-extractor entry points
(counterpart of ``src/feature_extractors/fe_common.py``).

:func:`parse_args`, :func:`resolve_compute_dtype`, the model loaders
:func:`load_wav2vec2_model` and :func:`load_text_model_and_tokenizer`,
:func:`with_pretrained_backbone`, :func:`load_finetuned`,
:func:`export_embedding_table` and :func:`int8_embed`. ``--int8`` selects the int8 serving
engine in the embedding exports (``serving/encoders.py``; the other entry
points ignore it, as ``mer_tpu``'s do). ``--zero1`` sets ``tpu.zero1``: on
a dp mesh each rank keeps its slice of the AdamW moments
(:func:`parallel_setup` builds the mesh from ``tpu.mesh`` under ``torchrun``).
``--pp N`` (training) pipelines the encoder's layers over N stages of the
ranks, the rest dp (:func:`parallel_setup`, :func:`build_pp`;
``--pp-microbatches`` M, default N); ``--remat`` recomputes each encoder
layer in the backward, ``--remat-policy`` says what it keeps
(``utils/remat.py``), with or without ``--pp``. The
encoders have one layout here, so ``--scan-layers`` has no counterpart, and the
exports always loop over batches (``mer_tpu``'s ``--per-batch-export`` shape;
its scan grouping exists to save jit dispatches).

Nothing is downloaded. Without ``--random-init`` the pretrained backbone must
be a local ``--pretrained`` file (a ``torch.save``'d Hugging Face
``state_dict``) or a directory holding one as ``pytorch_model.bin``; without
``--toy-tokenizer`` the RoBERTa tokenizer's files must be in that directory.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mer_tpu_torch.data.text_fe import ToyWhitespaceTokenizer, load_roberta_tokenizer
from mer_tpu_torch.models.convert import load_model_state_dict, read_torch_checkpoint
from mer_tpu_torch.models.roberta import RobertaConfig, TextERC, text_erc_from_seed
from mer_tpu_torch.models.wav2vec2 import AudioERC, Wav2Vec2Config, audio_erc_from_seed
from mer_tpu_torch.parallel import initialize_distributed, local_device, mesh_from_config
from mer_tpu_torch.serving.engine import resolve_device
from mer_tpu_torch.utils.remat import REMAT_POLICIES

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None, default_config: str | None = None, prog: str | None = None):
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("--config", default=default_config)
    p.add_argument("--data-root", default=None, help="directory containing MELD.Raw (default ./data)")
    p.add_argument("--epochs", type=int, default=None, help="training: override solver.epochs")
    p.add_argument("--random-init", action="store_true",
                   help="seeded random backbone weights instead of pretrained ones (smoke runs)")
    p.add_argument("--toy-tokenizer", action="store_true",
                   help="text: the hash tokenizer instead of the Hugging Face RoBERTa vocabulary")
    p.add_argument("--pretrained", default=None,
                   help="local file: a torch.save'd backbone state_dict (Hugging Face key names), or a directory "
                        "holding it as pytorch_model.bin (text: beside the tokenizer's files)")
    p.add_argument("--variant", default=None, help="text: roberta-base (default) or roberta-large")
    dtype = p.add_mutually_exclusive_group()
    dtype.add_argument("--bf16", action="store_true", help="force bf16 compute over the f32 weights")
    dtype.add_argument("--f32", action="store_true", help="force float32 compute")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--int8", action="store_true",
                   help="embedding export: the int8 serving engine (int8 weights and activations, int32 products)")
    p.add_argument("--pp", type=int, default=1,
                   help="training: pipeline stages of the 12-layer encoder (GPipe over a (dp, pp) mesh of the ranks, "
                        "parallel/pipeline.py); the remaining ranks become dp; tpu.zero1 and tpu.mesh's tp are "
                        "ignored under it")
    p.add_argument("--pp-microbatches", type=int, default=None, help="microbatches per pipeline round (default: pp)")
    p.add_argument("--remat-policy", default=None, choices=list(REMAT_POLICIES),
                   help="with --remat: what the backward keeps (utils/remat.py; 'dots*' keep the matrix products' "
                        "outputs and recompute the elementwise chain)")
    p.add_argument("--remat", action="store_true",
                   help="training: recompute each encoder layer in the backward (activation memory of about one "
                        "layer for one more forward)")
    p.add_argument("--zero1", action="store_true",
                   help="training: ZeRO-1, each dp rank keeps its slice of the optimizer's moments (tpu.zero1)")
    return p.parse_args(argv)


def parallel_setup(args, config):
    """(config, mesh, device) of a training entry point: the process group
    under ``torchrun`` (one process: none), the mesh of ``tpu.mesh`` (dp =
    -1 by default: every rank) or, under ``--pp N``, a (dp, pp) mesh whose
    dp takes the ranks the stages leave, this rank's ``cuda:LOCAL_RANK``,
    and ``--zero1`` as ``tpu.zero1``."""
    resolve_device(args.device)
    initialize_distributed(device=args.device)
    if args.zero1:
        config = config.override(tpu__zero1=True)
    pp = int(getattr(args, "pp", 1) or 1)
    if pp <= 1:
        return config, mesh_from_config(config), local_device(args.device)
    from mer_tpu_torch.parallel.pipeline import make_pp_mesh

    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    if world % pp:
        raise ValueError(f"--pp {pp} does not divide the {world} available devices")
    return config, make_pp_mesh(pp=pp, dp=world // pp), local_device(args.device)


def remat_value(args) -> bool | str:
    """``--remat`` as ``pipeline_apply`` takes it: False, True (recompute
    everything) or a selective policy's name."""
    policy = getattr(args, "remat_policy", None)
    if not getattr(args, "remat", False):
        return False
    return policy if policy and policy != "full" else True


def build_pp(args, model, mesh, config=None):
    """``--pp N``: the pipelined logits function of ``model`` (``(*inputs,
    seed=None) -> logits``, ``parallel/pp_forward.py``) over ``mesh``'s pp
    group, after dropping the layers other stages own; None when pp <= 1."""
    if mesh.pp <= 1:
        return None
    from mer_tpu_torch.parallel.pipeline import keep_stage_layers_
    from mer_tpu_torch.parallel.pp_forward import stack_of

    keep_stage_layers_(stack_of(model)[0], mesh)
    mb = getattr(args, "pp_microbatches", None)
    ignored = []
    if config is not None and config.get_path("tpu.zero1", False):
        ignored.append("tpu.zero1")
    if config is not None and int((config.get_path("tpu.mesh", {}) or {}).get("tp", 1)) > 1:
        ignored.append("tpu.mesh's tp")
    print(f"Pipeline parallelism: pp={mesh.pp} dp={mesh.dp} (microbatches={mb if mb is not None else mesh.pp})"
          + (f"; ignored under --pp: {', '.join(ignored)}" if ignored else ""))
    return pipelined_logits(model, mesh, mb, remat_value(args))


def pipelined_logits(model, mesh, microbatches: int | None = None, remat: bool | str = False):
    """``(*inputs, seed=None) -> logits`` of ``model`` (TextERC or AudioERC)
    through ``parallel/pp_forward.py`` over ``mesh``'s pp group (at pp 1:
    the same microbatches and dropout seeds in one process)."""
    from mer_tpu_torch.parallel.pp_forward import audio_erc_logits_pp, text_erc_logits_pp

    forward = text_erc_logits_pp if isinstance(model, TextERC) else audio_erc_logits_pp
    return lambda *inputs, seed=None: forward(model, mesh, *inputs, seed=seed, microbatches=microbatches,
                                              remat=remat)


def int8_embed(model, quantize, engine):
    """A stand-in for ``model.embed`` through the int8 serving engine
    ``engine(model)`` over ``quantize(model)``'s weights, quantized once."""
    qparams, server = quantize(model), engine(model)
    print("int8 serving engine enabled")
    return lambda *inputs: server.embed(qparams, *inputs)


def resolve_compute_dtype(args, config=None) -> torch.dtype:
    """bf16 *compute* over f32 parameters, or f32: ``--bf16`` / ``--f32``
    force; otherwise the config's ``tpu.compute_dtype`` decides (the shipped
    configs say bfloat16; float32 where the key is absent)."""
    if getattr(args, "f32", False):
        return torch.float32
    if getattr(args, "bf16", False):
        return torch.bfloat16
    name = str(config.get_path("tpu.compute_dtype", "float32")) if config is not None else "float32"
    return torch.bfloat16 if name in ("bfloat16", "bf16") else torch.float32


def _pretrained_state_dict(args, variant: str, reference: str) -> dict | None:
    """The pretrained backbone's ``state_dict`` from ``--pretrained``, None
    under ``--random-init``; anything else is a loud error."""
    if args.random_init:
        return None
    path = args.pretrained
    if path and os.path.isdir(path):
        path = os.path.join(path, "pytorch_model.bin")
    if not (path and os.path.isfile(path)):
        raise RuntimeError(
            f"pretrained backbone '{args.pretrained or variant}' is unavailable (this package downloads nothing). "
            "Stage the weights locally and pass --pretrained <state_dict file>, or run with --random-init for a "
            f"smoke run; results will NOT match the reference's fine-tuned artifacts ({reference}).")
    return read_torch_checkpoint(path)


def _seed(config) -> int:
    return int(config.get_path("tpu.seed", 0)) if config is not None else 0


def load_wav2vec2_model(args, variant: str = "facebook/wav2vec2-base", config=None) -> tuple[AudioERC, dict | None]:
    """(model on the host, pretrained backbone ``state_dict`` or None): the
    base-config ``AudioERC`` with seeded random weights (``tpu.seed``) in the
    resolved compute dtype. Without ``--random-init`` the pretrained backbone
    must be a local ``--pretrained`` file; nothing is downloaded."""
    model = audio_erc_from_seed(_seed(config), Wav2Vec2Config.base(), resolve_compute_dtype(args, config))
    model.set_remat(getattr(args, "remat", False), getattr(args, "remat_policy", None))
    return model, _pretrained_state_dict(args, variant, "audio_wav2vec2/model.py:9")


def load_text_model_and_tokenizer(args, variant: str | None = None, config=None):
    """(model on the host, tokenizer, pretrained backbone ``state_dict`` or
    None): ``TextERC`` with seeded random weights (``tpu.seed``) in the
    resolved compute dtype. The variant comes from ``--variant``, then
    ``variant``, then the config's ``test.pretrained_model`` (the reference's
    knob), then ``roberta-base``; a name holding "large" picks the large
    config. ``--toy-tokenizer`` picks the hash tokenizer over the variant's
    vocabulary size, else the Hugging Face tokenizer is read from local files."""
    variant = (args.variant or variant or (config.get_path("test.pretrained_model") if config is not None else None)
               or "roberta-base")
    cfg = RobertaConfig.large() if "large" in variant else RobertaConfig.base()
    model = text_erc_from_seed(_seed(config), cfg, resolve_compute_dtype(args, config))
    model.set_remat(getattr(args, "remat", False), getattr(args, "remat_policy", None))
    tokenizer = (ToyWhitespaceTokenizer(vocab_size=cfg.vocab_size) if args.toy_tokenizer
                 else load_roberta_tokenizer(args.pretrained or variant))
    return model, tokenizer, _pretrained_state_dict(args, variant, "text/model.py:16")


def with_pretrained_backbone(model: TextERC | AudioERC, pretrained: dict | None):
    """``model`` with its backbone filled from the pretrained ``state_dict``
    (its head keeps the seeded weights); unchanged when there is none."""
    if pretrained is not None:
        model.load_backbone(pretrained)
    return model


def set_float32_exact(dtype: torch.dtype) -> None:
    """In float32 turn TF32 off, so f32 means f32 on the card."""
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def load_finetuned(model: TextERC | AudioERC, pretrained: dict | None, ckpt_path: str, need_checkpoint: bool):
    """``model`` with the fine-tuned checkpoint at ``ckpt_path`` (a
    ``model_state_dict``, a bare ``state_dict``, or a ``mer_tpu`` msgpack file
    or shard directory, converted) when it exists; else, unless
    ``need_checkpoint``, with the pretrained backbone under the seeded head;
    else an error (as the reference's entry points)."""
    ckpt_path = os.path.abspath(ckpt_path)
    if os.path.exists(ckpt_path):
        kind = "text" if isinstance(model, TextERC) else "wav2vec2"
        model.load_state_dict(load_model_state_dict(ckpt_path, kind), strict=True)
        print(f"Loaded fine-tuned checkpoint {ckpt_path}")
    elif need_checkpoint:
        raise FileNotFoundError(f"Checkpoint not found at {ckpt_path}")
    elif pretrained is not None:
        model.load_backbone(pretrained)
        print("Checkpoint not found; exporting with pretrained backbone")
    else:
        raise ValueError("Checkpoint not found")
    return model


def export_embedding_table(embed_batches, n_rows: int, dim: int) -> np.ndarray:
    """[N, D] float32 from (row indices, embeddings) batches: scatter
    semantics as the reference exporters' (text/embeddings.py:70,86-90)."""
    out = np.zeros((n_rows, dim), dtype=np.float32)
    for idx, emb in embed_batches:
        out[np.asarray(idx)] = np.asarray(emb)[: len(idx)]
    return out
