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
:func:`audio_state_dict_from_jax` a ``mer_tpu`` wav2vec2 ``AudioERC`` to the
port's, under Hugging Face's key names.
:func:`load_reference_checkpoint` reads ``torch.save({'epoch',
'model_state_dict'})`` files (reference src/train.py:163-168).
"""

from __future__ import annotations

import os
import zipfile
from typing import Mapping

import numpy as np
import torch


def _np(x) -> np.ndarray:
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


def mel_state_dict_from_jax(params_np: Mapping, batch_stats_np: Mapping) -> dict[str, torch.Tensor]:
    """``mer_tpu``'s ``AudioMelFeatureExtractor`` params and BatchNorm stats
    (nested dicts of numpy arrays) -> the port's ``state_dict`` in
    torchvision's names: convolutions HWIO -> OIHW, Dense kernels
    transposed, BatchNorm scale/bias/mean/var to weight/bias/running_mean/
    running_var (``num_batches_tracked`` 0)."""
    out: dict[str, np.ndarray] = {}

    def conv(node: Mapping, prefix: str) -> None:
        out[f"{prefix}weight"] = _np(node["kernel"]).transpose(3, 2, 0, 1)

    def bn(node: Mapping, stats: Mapping, prefix: str) -> None:
        out[f"{prefix}weight"], out[f"{prefix}bias"] = _np(node["scale"]), _np(node["bias"])
        out[f"{prefix}running_mean"], out[f"{prefix}running_var"] = _np(stats["mean"]), _np(stats["var"])
        out[f"{prefix}num_batches_tracked"] = np.zeros((), np.int64)

    p, s = params_np["resnet18"], batch_stats_np["resnet18"]
    conv(p["conv1"], "resnet18.conv1.")
    bn(p["bn1"], s["bn1"], "resnet18.bn1.")
    for stage in range(1, 5):
        for block in range(2):
            bp, bs, prefix = p[f"layer{stage}_{block}"], s[f"layer{stage}_{block}"], f"resnet18.layer{stage}.{block}."
            for i in (1, 2):
                conv(bp[f"conv{i}"], f"{prefix}conv{i}.")
                bn(bp[f"bn{i}"], bs[f"bn{i}"], f"{prefix}bn{i}.")
            if "downsample_conv" in bp:
                conv(bp["downsample_conv"], f"{prefix}downsample.0.")
                bn(bp["downsample_bn"], bs["downsample_bn"], f"{prefix}downsample.1.")
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

    found = _find_adam_moments(opt_state_np)
    if found is None:
        raise ValueError("no Adam state (count, mu, nu) found in the optimizer state")
    count, mu, nu = found
    want = state_dict_from_jax(params_np, model_cfg)
    mu_sd, nu_sd = state_dict_from_jax(mu, model_cfg), state_dict_from_jax(nu, model_cfg)
    with torch.device("meta"):
        names = [name for name, _ in M2FNet.from_config(model_cfg).named_parameters()]
    if set(names) != set(want) or any(mu_sd[n].shape != want[n].shape for n in names):
        raise ValueError("the Adam moments do not match the model's parameters")
    step = torch.tensor(float(np.asarray(count)))
    return {i: {"step": step.clone(), "exp_avg": mu_sd[n], "exp_avg_sq": nu_sd[n]} for i, n in enumerate(names)}


def read_torch_checkpoint(path: str | os.PathLike) -> dict:
    """``torch.load`` a checkpoint onto the host, tensors and plain data only.
    A file that is not a torch checkpoint (a ``mer_tpu`` msgpack one, say)
    raises instead of being misread."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path} is not a torch checkpoint (torch.save writes a zip archive); a mer_tpu "
                         "msgpack checkpoint cannot be read by the port yet. Point checkpoint.load_path or "
                         "--checkpoint at a file the port or torch.save wrote.")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_checkpoint(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """The ``model_state_dict`` of a reference-layout ``.pth`` checkpoint."""
    return read_torch_checkpoint(path)["model_state_dict"]


def save_reference_checkpoint(path: str | os.PathLike, model: torch.nn.Module, epoch: int = 0) -> None:
    """Write ``{'epoch', 'model_state_dict'}`` as the reference does."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"epoch": epoch, "model_state_dict": sd}, path)
