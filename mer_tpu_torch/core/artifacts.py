"""Embedding artifact store (counterpart of ``mer_tpu/core/artifacts.py``).

The stage-1 -> stage-2 contract is a pickled ``torch.FloatTensor`` [N, D] at
``embeddings/<name>/{train,val,test}.pkl``, row-indexed by the ``get_text``
table order (reference src/dataset.py:14-17). Plain numpy pickles load too.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch


def _to_numpy(obj: Any) -> np.ndarray:
    if isinstance(obj, np.ndarray):
        return np.asarray(obj, dtype=np.float32)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().astype(np.float32)
    raise TypeError(f"Unsupported embedding artifact type: {type(obj)!r}")


def load_embeddings(path: str | os.PathLike) -> np.ndarray:
    """Load an [N, D] float32 embedding table from a reference-layout pickle.

    The file is unpickled, so only load artifacts this project wrote."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    arr = _to_numpy(obj)
    if arr.ndim != 2:
        raise ValueError(f"Expected [N, D] embeddings at {path}, got shape {arr.shape}")
    return arr


def embeddings_path(base_dir: str | os.PathLike, mode: str) -> str:
    """``embeddings/<name>`` + mode -> ``embeddings/<name>/<mode>.pkl``."""
    return os.path.join(os.path.abspath(os.fspath(base_dir)), f"{mode}.pkl")
