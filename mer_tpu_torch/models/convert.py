"""Weights across: the JAX package's param trees and reference checkpoints.

:func:`state_dict_from_jax` turns a ``mer_tpu`` M2FNet param tree, given as
nested dicts of numpy arrays, into this port's ``state_dict`` (the reference
torch layout of ``mer_tpu/models/torch_export.py``). Both encoder layouts are
read: unrolled ``layers_{i}`` and scan-stacked ``layers_scan/layer`` with a
leading layer axis, unstacked here in numpy.
:func:`adam_state_from_jax` does the same for its optax Adam state, so a
run resumes in the port from ``mer_tpu``'s optimizer state.
:func:`mel_state_dict_from_jax` carries a ``mer_tpu`` mel extractor (params
and BatchNorm stats) over to the port's torchvision-layout ResNet18, and
:func:`audio_state_dict_from_jax` a ``mer_tpu`` wav2vec2 ``AudioERC`` and
:func:`text_state_dict_from_jax` a ``mer_tpu`` RoBERTa ``TextERC`` to the
port's, under Hugging Face's key names.
:func:`load_reference_checkpoint` reads ``torch.save({'epoch',
'model_state_dict'})`` files (reference src/train.py:163-168).

:func:`read_checkpoint` is the one reader of every entry point: a torch zip
file, or a ``mer_tpu`` flax msgpack file or shard directory
(``train/flax_msgpack.py``, plain Python). :func:`port_payload` turns a
``mer_tpu`` payload into the port's checkpoint layout, the Adam moments
included; :func:`load_model_state_dict` gives any of them as a model's
``state_dict``.
"""

from __future__ import annotations

import os
import zipfile
from typing import Mapping

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):  # a bfloat16 leaf of a msgpack checkpoint
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _first_leaf(tree: Mapping):
    for v in tree.values():
        return _first_leaf(v) if isinstance(v, Mapping) else v
    raise ValueError("empty param tree")


def _unstack(tree: Mapping) -> list[dict]:
    """Split a param tree with a leading layer axis into per-layer trees."""

    def take(node: Mapping, i: int) -> dict:
        return {k: take(v, i) if isinstance(v, Mapping) else _np(v)[i] for k, v in node.items()}

    return [take(tree, i) for i in range(np.shape(_first_leaf(tree))[0])]


def _linear(node: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}weight"] = _np(node["kernel"]).T
    out[f"{prefix}bias"] = _np(node["bias"])


def _layernorm(node: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}weight"] = _np(node["scale"])
    out[f"{prefix}bias"] = _np(node["bias"])


def _mha(node: Mapping, prefix: str, out: dict) -> None:
    proj = ("q_proj", "k_proj", "v_proj")
    out[f"{prefix}in_proj_weight"] = np.concatenate([_np(node[p]["kernel"]).T for p in proj], axis=0)
    out[f"{prefix}in_proj_bias"] = np.concatenate([_np(node[p]["bias"]) for p in proj], axis=0)
    _linear(node["out_proj"], f"{prefix}out_proj.", out)


def _encoder(node: Mapping, prefix: str, out: dict) -> None:
    if "layers_scan" in node:
        layers = _unstack(node["layers_scan"]["layer"])
    else:
        layers = [node[f"layers_{i}"] for i in range(sum(k.startswith("layers_") for k in node))]
    for i, layer in enumerate(layers):
        p = f"{prefix}layers.{i}."
        _mha(layer["self_attn"], f"{p}self_attn.", out)
        _linear(layer["linear1"], f"{p}linear1.", out)
        _linear(layer["linear2"], f"{p}linear2.", out)
        _layernorm(layer["norm1"], f"{p}norm1.", out)
        _layernorm(layer["norm2"], f"{p}norm2.", out)
    _layernorm(node["norm"], f"{prefix}norm.", out)


def state_dict_from_jax(params_np: Mapping, model_cfg) -> dict[str, torch.Tensor]:
    """``mer_tpu`` M2FNet params (nested dicts of numpy arrays) -> this port's
    ``state_dict``. ``model_cfg`` is the ``model:`` config block the params
    were built from (modality toggles, stack counts, classifier depth)."""
    out: dict[str, np.ndarray] = {}
    for modality in ("audio", "text"):
        block = model_cfg[modality.upper()]
        if bool(block.enabled):
            for i in range(int(block.n_transformers)):
                _encoder(params_np[f"{modality}_encoders_{i}"], f"{modality}_encoders.{i}.", out)
            _linear(params_np[f"{modality}_proj"], f"{modality}_proj.", out)
    if bool(model_cfg.FAM.enabled):
        for i in range(int(model_cfg.FAM.n_layers)):
            fam = params_np[f"fusion_layers_{i}"]
            _mha(fam["multihead_attention"], f"fusion_layers.{i}.multihead_attention.", out)
            _linear(fam["linear"], f"fusion_layers.{i}.linear.", out)

    # output_layer Sequential: Linear, (ReLU, Linear)*, ReLU, Dropout, Linear
    n_hidden = max(int(model_cfg.CLASSIFIER.n_layers) - 2, 0) + 1
    for j in range(n_hidden):
        _linear(params_np[f"classifier_{j}"], f"output_layer.{2 * j}.", out)
    _linear(params_np["classifier_out"], f"output_layer.{2 * n_hidden + 1}.", out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}  # copies: writable, contiguous


def mel_state_dict_from_jax(params_np: Mapping, batch_stats_np: Mapping | None) -> dict[str, torch.Tensor]:
    """``mer_tpu``'s ``AudioMelFeatureExtractor`` params and BatchNorm stats
    (nested dicts of numpy arrays) -> the port's ``state_dict`` in
    torchvision's names: convolutions HWIO -> OIHW, Dense kernels
    transposed, BatchNorm scale/bias/mean/var to weight/bias/running_mean/
    running_var (``num_batches_tracked`` 0). ``batch_stats_np`` None: the
    parameters alone (a tree of Adam moments, say), no BatchNorm buffers."""
    out: dict[str, np.ndarray] = {}

    def conv(node: Mapping, prefix: str) -> None:
        out[f"{prefix}weight"] = _np(node["kernel"]).transpose(3, 2, 0, 1)

    def bn(node: Mapping, stats: Mapping | None, prefix: str) -> None:
        out[f"{prefix}weight"], out[f"{prefix}bias"] = _np(node["scale"]), _np(node["bias"])
        if stats is not None:
            out[f"{prefix}running_mean"], out[f"{prefix}running_var"] = _np(stats["mean"]), _np(stats["var"])
            out[f"{prefix}num_batches_tracked"] = np.zeros((), np.int64)

    p = params_np["resnet18"]
    s = None if batch_stats_np is None else batch_stats_np["resnet18"]
    sub = lambda name: None if s is None else s[name]
    conv(p["conv1"], "resnet18.conv1.")
    bn(p["bn1"], sub("bn1"), "resnet18.bn1.")
    for stage in range(1, 5):
        for block in range(2):
            bp, bs, prefix = p[f"layer{stage}_{block}"], sub(f"layer{stage}_{block}"), f"resnet18.layer{stage}.{block}."
            for i in (1, 2):
                conv(bp[f"conv{i}"], f"{prefix}conv{i}.")
                bn(bp[f"bn{i}"], None if bs is None else bs[f"bn{i}"], f"{prefix}bn{i}.")
            if "downsample_conv" in bp:
                conv(bp["downsample_conv"], f"{prefix}downsample.0.")
                bn(bp["downsample_bn"], None if bs is None else bs["downsample_bn"], f"{prefix}downsample.1.")
    _linear(p["fc"], "resnet18.fc.", out)
    _linear(params_np["projector"], "projector.1.", out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}  # copies: writable, contiguous


def audio_state_dict_from_jax(params_np: Mapping) -> dict[str, torch.Tensor]:
    """``mer_tpu``'s ``AudioERC`` params (nested dicts of numpy arrays) -> the
    port's ``state_dict``: the inverse of ``convert_hf_wav2vec2``
    (``mer_tpu/models/wav2vec2.py:392``), so the backbone carries Hugging
    Face's names under ``wav2vec2.``. Conv kernels [k, in, out] -> [out, in, k]
    (the positional conv's as a folded ``weight``), Dense kernels transposed,
    the GroupNorm as ``conv_layers.0.layer_norm``. Both encoder layouts are
    read: unrolled ``layer_{i}`` and scan-stacked ``layers_scan/layer``."""
    out: dict[str, np.ndarray] = {}

    def conv(node: Mapping, prefix: str) -> None:
        out[f"{prefix}weight"] = _np(node["kernel"]).transpose(2, 1, 0)
        if "bias" in node:
            out[f"{prefix}bias"] = _np(node["bias"])

    backbone, prefix = params_np["wav2vec2"], "wav2vec2."
    fe = backbone["feature_extractor"]
    for i in range(sum(k.startswith("conv_") for k in fe)):
        conv(fe[f"conv_{i}"], f"{prefix}feature_extractor.conv_layers.{i}.conv.")
    _layernorm(fe["group_norm"], f"{prefix}feature_extractor.conv_layers.0.layer_norm.", out)
    _layernorm(backbone["feature_projection_norm"], f"{prefix}feature_projection.layer_norm.", out)
    _linear(backbone["feature_projection"], f"{prefix}feature_projection.projection.", out)
    conv(backbone["pos_conv_embed"]["conv"], f"{prefix}encoder.pos_conv_embed.conv.")
    _layernorm(backbone["encoder_layer_norm"], f"{prefix}encoder.layer_norm.", out)
    if "layers_scan" in backbone:
        layers = _unstack(backbone["layers_scan"]["layer"])
    else:
        layers = [backbone[f"layer_{i}"] for i in range(sum(k.startswith("layer_") for k in backbone))]
    for i, layer in enumerate(layers):
        p = f"{prefix}encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(layer[name], f"{p}attention.{name}.", out)
        _layernorm(layer["layer_norm"], f"{p}layer_norm.", out)
        _linear(layer["intermediate"], f"{p}feed_forward.intermediate_dense.", out)
        _linear(layer["output"], f"{p}feed_forward.output_dense.", out)
        _layernorm(layer["final_layer_norm"], f"{p}final_layer_norm.", out)
    _linear(params_np["head_dense"], "head_dense.", out)
    _linear(params_np["head_out"], "head_out.", out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}  # copies: writable, contiguous


def text_state_dict_from_jax(params_np: Mapping) -> dict[str, torch.Tensor]:
    """``mer_tpu``'s ``TextERC`` params (nested dicts of numpy arrays) -> the
    port's ``state_dict``: the inverse of ``convert_hf_roberta``
    (``mer_tpu/models/roberta.py:227``, under ``roberta.``) and
    ``convert_hf_classification_head`` (``:272``, under ``classifier_head.``).
    Embedding tables as they are, Dense kernels transposed, LayerNorm scale to
    weight. Both encoder layouts are read: unrolled ``layer_{i}`` and
    scan-stacked ``layers_scan/layer``."""
    out: dict[str, np.ndarray] = {}
    backbone, prefix = params_np["roberta"], "roberta."
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        out[f"{prefix}embeddings.{name}.weight"] = _np(backbone[name]["embedding"])
    _layernorm(backbone["embeddings_layernorm"], f"{prefix}embeddings.LayerNorm.", out)
    if "layers_scan" in backbone:
        layers = _unstack(backbone["layers_scan"]["layer"])
    else:
        layers = [backbone[f"layer_{i}"] for i in range(sum(k.startswith("layer_") for k in backbone))]
    for i, layer in enumerate(layers):
        p = f"{prefix}encoder.layer.{i}."
        for name in ("query", "key", "value"):
            _linear(layer["attention"][name], f"{p}attention.self.{name}.", out)
        _linear(layer["attention_output"], f"{p}attention.output.dense.", out)
        _layernorm(layer["attention_layernorm"], f"{p}attention.output.LayerNorm.", out)
        _linear(layer["intermediate"], f"{p}intermediate.dense.", out)
        _linear(layer["output"], f"{p}output.dense.", out)
        _layernorm(layer["output_layernorm"], f"{p}output.LayerNorm.", out)
    _linear(params_np["classifier_head"]["dense"], "classifier_head.dense.", out)
    _linear(params_np["classifier_head"]["out_proj"], "classifier_head.out_proj.", out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}  # copies: writable, contiguous


def _find_adam_moments(tree):
    """The ``(count, mu, nu)`` of the first Adam state inside an optax state
    given as nested tuples, namedtuples or dicts (``to_state_dict`` output)."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree["count"], tree["mu"], tree["nu"]
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _find_adam_moments(child)
        if found is not None:
            return found
    return None


def _adam_state(opt_state_np, to_state_dict, names: list[str], want: Mapping) -> dict[int, dict[str, torch.Tensor]]:
    """The ``"state"`` of a ``torch.optim`` Adam over parameters ``names``
    (in the optimizer's order) from an optax state: ``to_state_dict`` turns
    the moment trees into the port's names, ``want`` the converted params,
    against whose names and shapes the moments are checked."""
    found = _find_adam_moments(opt_state_np)
    if found is None:
        raise ValueError("no Adam state (count, mu, nu) found in the optimizer state")
    count, mu, nu = found
    mu_sd, nu_sd = to_state_dict(mu), to_state_dict(nu)
    for label, sd in (("mu", mu_sd), ("nu", nu_sd)):
        missing = [n for n in names if n not in sd or sd[n].shape != want[n].shape]
        if missing or set(names) != set(want):
            raise ValueError(f"the Adam moments do not match the model's parameters: {label} of "
                             f"{', '.join(missing) or sorted(set(want) ^ set(names))}")
    step = torch.tensor(float(np.asarray(count)))
    return {i: {"step": step.clone(), "exp_avg": mu_sd[n].contiguous(), "exp_avg_sq": nu_sd[n].contiguous()}
            for i, n in enumerate(names)}


def _parameter_names(module_factory) -> list[str]:
    with torch.device("meta"):
        return [name for name, _ in module_factory().named_parameters()]


def adam_state_from_jax(opt_state_np, params_np: Mapping, model_cfg) -> dict[int, dict[str, torch.Tensor]]:
    """``mer_tpu``'s optax Adam state (mu, nu, count; nested in the
    ``torch_adam`` chain and, with accumulation, in ``MultiSteps``) -> the
    ``"state"`` of this port's ``torch.optim.Adam`` over
    ``M2FNet.from_config(model_cfg).parameters()``, indexed in that order::

        sd = optimizer.state_dict()
        optimizer.load_state_dict({**sd, "state": adam_state_from_jax(...)})

    The moments have the params' tree structure, so they convert as params
    do; ``params_np`` checks that they match the model."""
    from mer_tpu_torch.models.m2fnet import M2FNet

    return _adam_state(opt_state_np, lambda tree: state_dict_from_jax(tree, model_cfg),
                       _parameter_names(lambda: M2FNet.from_config(model_cfg)),
                       state_dict_from_jax(params_np, model_cfg))


def mel_adam_state_from_jax(opt_state_np, params_np: Mapping) -> dict[int, dict[str, torch.Tensor]]:
    """:func:`adam_state_from_jax` for the mel extractor: the ``"state"`` of
    a ``torch.optim.Adam`` over ``AudioMelFeatureExtractor().parameters()``."""
    from mer_tpu_torch.models.resnet import AudioMelFeatureExtractor

    return _adam_state(opt_state_np, lambda tree: mel_state_dict_from_jax(tree, None),
                       _parameter_names(AudioMelFeatureExtractor), mel_state_dict_from_jax(params_np, None))


# -- mer_tpu checkpoints ----------------------------------------------------------

MER_TPU_KINDS = ("fusion", "mel", "text", "wav2vec2")


def mer_tpu_kind(params: Mapping) -> str:
    """Which model a ``mer_tpu`` param tree holds, from its top-level names."""
    for key, kind in (("resnet18", "mel"), ("roberta", "text"), ("wav2vec2", "wav2vec2"),
                      ("classifier_out", "fusion")):
        if key in params:
            return kind
    raise ValueError(f"not a mer_tpu model's params (top level: {sorted(params)})")


def _mel_default_buffers(sd: dict) -> dict:
    """``sd`` with flax's initial BatchNorm statistics (mean 0, var 1) where
    a checkpoint holds no ``batch_stats`` (``mer_tpu``'s best-weights files)."""
    from mer_tpu_torch.models.resnet import AudioMelFeatureExtractor

    with torch.device("meta"):
        buffers = [(n, tuple(b.shape)) for n, b in AudioMelFeatureExtractor().named_buffers()]
    for name, shape in buffers:
        if name.endswith("running_mean"):
            sd[name] = torch.zeros(shape)
        elif name.endswith("running_var"):
            sd[name] = torch.ones(shape)
        else:
            sd[name] = torch.zeros(shape, dtype=torch.int64)
    return sd


def mer_tpu_state_dict(params: Mapping, kind: str, model_cfg=None, batch_stats: Mapping | None = None):
    """The port's ``state_dict`` of a ``mer_tpu`` param tree of ``kind``
    (``model_cfg``: the fusion model's ``model:`` block)."""
    if kind == "fusion":
        if model_cfg is None:
            raise ValueError("a fusion checkpoint of mer_tpu converts through the model: config block")
        return state_dict_from_jax(params, model_cfg)
    if kind == "mel":
        sd = mel_state_dict_from_jax(params, batch_stats or None)
        return sd if batch_stats else _mel_default_buffers(sd)
    if kind == "text":
        return text_state_dict_from_jax(params)
    if kind == "wav2vec2":
        return audio_state_dict_from_jax(params)
    raise ValueError(f"unknown model kind {kind!r}; one of {MER_TPU_KINDS}")


def _scalar(v):
    return v.item() if hasattr(v, "item") and np.ndim(v) == 0 else v


def _multisteps_window(opt_state_np):
    """(mini_step, acc_grads) of an optax ``MultiSteps`` state, else None."""
    if isinstance(opt_state_np, Mapping):
        if {"mini_step", "acc_grads"} <= set(opt_state_np):
            return int(np.asarray(opt_state_np["mini_step"])), opt_state_np["acc_grads"]
        for child in opt_state_np.values():
            found = _multisteps_window(child)
            if found is not None:
                return found
    return None


def port_payload(payload: Mapping, kind: str | None = None, model_cfg=None) -> dict:
    """A ``mer_tpu`` checkpoint payload ``{epoch, params, opt_state, extra}``
    in the port's layout: ``{"epoch", "model_state_dict", "extra"}`` and,
    where the optax state holds Adam moments (fusion, mel),
    ``"optimizer_state_dict": {"state": ...}`` without ``param_groups`` (the
    live optimizer's are kept), plus ``"accumulated_grads"`` (the sum of the
    window's micro-gradients) when a ``MultiSteps`` window is open. ``extra``
    keeps the early-stop state, and the mel ``batch_stats`` go into the
    BatchNorm buffers. With Adam moments come ``"adam_count"`` (updates) and
    ``"mini_step"`` (micro-steps of the open window), from which a solver
    counts its micro-steps where ``extra`` has no ``step`` (mel). A moment
    that cannot be mapped raises and names it."""
    params = payload["params"]
    found = mer_tpu_kind(params)
    if kind is not None and kind != found:
        raise ValueError(f"the checkpoint holds a mer_tpu {found} model, not a {kind} one")
    kind = found
    extra = {k: _scalar(v) for k, v in dict(payload.get("extra") or {}).items() if k != "batch_stats"}
    batch_stats = (payload.get("extra") or {}).get("batch_stats")
    out = {"epoch": int(payload["epoch"]),
           "model_state_dict": mer_tpu_state_dict(params, kind, model_cfg, batch_stats), "extra": extra}
    opt_state = payload.get("opt_state")
    if opt_state and kind in ("fusion", "mel"):
        if kind == "fusion":
            state = adam_state_from_jax(opt_state, params, model_cfg)
            to_sd = lambda tree: state_dict_from_jax(tree, model_cfg)
        else:
            state = mel_adam_state_from_jax(opt_state, params)
            to_sd = lambda tree: mel_state_dict_from_jax(tree, None)
        out["optimizer_state_dict"] = {"state": state}
        mini_step, acc_grads = _multisteps_window(opt_state) or (0, None)
        if mini_step:  # optax keeps the window's mean; the port's .grad holds its sum
            out["accumulated_grads"] = {n: (g * mini_step).contiguous() for n, g in to_sd(acc_grads).items()}
        out["adam_count"], out["mini_step"] = int(np.asarray(_find_adam_moments(opt_state)[0])), mini_step
    return out


def read_checkpoint(path: str | os.PathLike) -> dict:
    """A checkpoint as it was written: a torch zip file through
    :func:`read_torch_checkpoint`, or a ``mer_tpu`` msgpack file or shard
    directory as ``{"epoch", "params", "opt_state", "extra", "format":
    "mer_tpu"}`` (``train/flax_msgpack.py``). Anything else raises."""
    from mer_tpu_torch.train import flax_msgpack

    if not os.path.exists(path):
        raise FileNotFoundError(f"Checkpoint not found at {path}")
    if os.path.isfile(path) and zipfile.is_zipfile(path):
        return read_torch_checkpoint(path)
    if flax_msgpack.is_msgpack_checkpoint(path):
        return {**flax_msgpack.load(path), "format": "mer_tpu"}
    raise ValueError(f"{path} is neither a torch checkpoint (a zip archive) nor a mer_tpu msgpack checkpoint "
                     "(a file or a directory of shard*-of-*.msgpack files)")


def is_mer_tpu_payload(payload: Mapping) -> bool:
    return payload.get("format") == "mer_tpu"


def read_torch_checkpoint(path: str | os.PathLike) -> dict:
    """``torch.load`` a checkpoint onto the host, tensors and plain data only.
    A file that is not a torch checkpoint raises instead of being misread."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path} is not a torch checkpoint (torch.save writes a zip archive)")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_state_dict(path: str | os.PathLike, kind: str, model_cfg=None) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` of model ``kind`` from any checkpoint
    :func:`read_checkpoint` takes: a torch file's ``model_state_dict`` (or
    the bare ``state_dict`` it holds), or a ``mer_tpu`` one converted."""
    payload = read_checkpoint(path)
    if is_mer_tpu_payload(payload):
        return port_payload(payload, kind, model_cfg)["model_state_dict"]
    return payload.get("model_state_dict", payload)


def load_reference_checkpoint(path: str | os.PathLike, model_cfg=None) -> dict[str, torch.Tensor]:
    """The fusion model's ``state_dict``: the ``model_state_dict`` of a
    reference-layout ``.pth`` checkpoint, or a ``mer_tpu`` fusion checkpoint
    converted through ``model_cfg`` (the ``model:`` block)."""
    return load_model_state_dict(path, "fusion", model_cfg)


def save_reference_checkpoint(path: str | os.PathLike, model: torch.nn.Module, epoch: int = 0) -> None:
    """Write ``{'epoch', 'model_state_dict'}`` as the reference does."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"epoch": epoch, "model_state_dict": sd}, path)
