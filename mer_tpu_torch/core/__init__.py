"""Config, MELD tables and embedding artifacts."""

from mer_tpu_torch.core.artifacts import embeddings_path, load_embeddings, save_embeddings
from mer_tpu_torch.core.config import (
    CONFIG_PATH,
    EMOTION_LABELS,
    NUM_EMOTIONS,
    Config,
    compute_dtype,
    length_buckets,
    load_config,
)
from mer_tpu_torch.core.text import dialogue_index, get_text, get_utterance_with_context, map_emotions

__all__ = [
    "CONFIG_PATH", "EMOTION_LABELS", "NUM_EMOTIONS", "Config", "compute_dtype", "dialogue_index",
    "embeddings_path", "get_text", "get_utterance_with_context", "length_buckets", "load_config", "load_embeddings",
    "map_emotions", "save_embeddings",
]
