"""Config system: the reference YAML schema parsed into attribute dicts.

Counterpart of ``mer_tpu/core/config.py``. The port reads the unchanged
``src/config.yaml``; of its ``tpu:`` block it reads only ``length_buckets``
and ``compute_dtype`` (see :func:`length_buckets` and :func:`compute_dtype`),
the two keys that decide the numbers. Mesh, donation, PRNG and layer-layout
keys describe the TPU program and have no meaning here.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Mapping

import torch
import yaml

DEFAULT_LENGTH_BUCKETS = (8, 16, 24, 33)  # MELD dialogues are <= 33 utterances
# the fusion config shared with the JAX package, read unchanged
CONFIG_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                           "src", "config.yaml")


class Config(dict):
    """A dict with attribute access, recursively applied. Minimal Munch."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs: Any):
        super().__init__()
        merged: dict[str, Any] = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = _wrap(value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def get_path(self, dotted: str, default: Any = None) -> Any:
        """``config.get_path("solver.scheduler.gamma", 0.98)``."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def to_dict(self) -> dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, Config) else copy.deepcopy(v)) for k, v in self.items()}

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config(self.to_dict())

    def override(self, **kwargs: Any) -> "Config":
        """Return a copy with overrides applied; ``__`` separates path parts
        (``config.override(tpu__compute_dtype="float32")``)."""
        out = Config(self.to_dict())
        for dotted, value in kwargs.items():
            parts = dotted.split("__")
            node: Any = out
            for part in parts[:-1]:
                if part not in node:
                    node[part] = Config()
                node = node[part]
            node[parts[-1]] = _wrap(value)
        return out


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


def load_config(path: str | os.PathLike) -> Config:
    """Parse a YAML file into a Config."""
    with open(path, "rt", encoding="utf-8") as f:
        raw = yaml.safe_load(f.read())
    return Config(raw or {})


def length_buckets(config: Config) -> tuple[int, ...]:
    """Dialogue-length padding buckets (``tpu.length_buckets``)."""
    return tuple(int(b) for b in config.get_path("tpu.length_buckets", DEFAULT_LENGTH_BUCKETS))


def compute_dtype(config: Config) -> torch.dtype:
    """Serving compute dtype (``tpu.compute_dtype``; bf16 unless float32)."""
    name = str(config.get_path("tpu.compute_dtype", "bfloat16"))
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"tpu.compute_dtype must be bfloat16 or float32, got {name!r}")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


# Emotion label vocabulary shared by every pipeline (reference src/dataset.py:22).
EMOTION_LABELS: dict[str, int] = {
    "neutral": 0,
    "joy": 1,
    "sadness": 2,
    "anger": 3,
    "surprise": 4,
    "fear": 5,
    "disgust": 6,
}
NUM_EMOTIONS = len(EMOTION_LABELS)
