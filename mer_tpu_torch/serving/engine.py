"""Model set-up shared by the entry points: device, weights, predict (the
model in its dtype, or the int8 engine over its f32 weights)."""

from __future__ import annotations

import numpy as np
import torch

from mer_tpu_torch.core import compute_dtype
from mer_tpu_torch.models import M2FNet, init_random_, load_reference_checkpoint

DTYPE_LABEL = {torch.bfloat16: "bf16", torch.float32: "f32"}


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default of every entry point) or ``cpu``; asking for
    CUDA where there is none raises rather than fall back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but torch.cuda.is_available() is false; "
                           "pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def build_model(config, device: torch.device, checkpoint: str | None = None,
                dtype: torch.dtype | None = None) -> M2FNet:
    """M2FNet from ``config.model`` in eval mode on ``device``, cast to
    ``dtype`` (default: the config's compute dtype; the int8 engine
    quantizes f32 weights); weights from a reference-layout checkpoint
    (strict load) or, without one, random weights from seed 0."""
    model = M2FNet.from_config(config.model)
    if checkpoint is not None:
        model.load_state_dict(load_reference_checkpoint(checkpoint), strict=True)
    else:
        init_random_(model, torch.Generator().manual_seed(0))
    return model.to(device=device, dtype=dtype or compute_dtype(config)).eval()


def predict_fn(model: M2FNet, int8: bool = False):
    """``(text, audio, padding_mask)`` device tensors -> argmax class [b, u].
    The embeddings stay f32: the model keeps them so across the encoder
    skips and casts to its weights' dtype inside. ``int8``: the int8 engine
    (:class:`~mer_tpu_torch.serving.quant.M2FNetInt8`) over the model's
    weights, quantized once here."""
    if int8:
        from mer_tpu_torch.serving.quant import M2FNetInt8, quantize_m2fnet

        qparams, server = quantize_m2fnet(model), M2FNetInt8(model)
        return lambda text, audio, padding_mask: server.apply(qparams, text, audio, padding_mask).argmax(-1)

    def predict(text, audio, padding_mask):
        return model(text, audio, padding_mask).argmax(-1)

    return predict


def host_predict_fn(model: M2FNet, device: torch.device, int8: bool = False):
    """:func:`predict_fn` over host numpy arrays, for the online server."""
    predict = predict_fn(model, int8)

    def run(text: np.ndarray, audio: np.ndarray, padding_mask: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = predict(*(torch.from_numpy(a).to(device) for a in (text, audio, padding_mask)))
            return out.cpu().numpy()

    return run
