"""Offline batch inference, the online micro-batching server and the int8
serving engines."""

from mer_tpu_torch.serving.encoders import RobertaInt8, Wav2Vec2Int8, quantize_roberta, quantize_wav2vec2
from mer_tpu_torch.serving.offline import BatchedPredictor, recollate_batches, split_recollated
from mer_tpu_torch.serving.online import DEFAULT_BATCH_BUCKETS, OnlineServer, ServerStats
from mer_tpu_torch.serving.quant import (
    M2FNetInt8,
    apply_calibration,
    calibration,
    int8_dense,
    quantize_m2fnet,
    quantize_tree,
    quantize_weight,
    quantized_bytes,
)

__all__ = [
    "BatchedPredictor", "DEFAULT_BATCH_BUCKETS", "M2FNetInt8", "OnlineServer", "RobertaInt8", "ServerStats",
    "Wav2Vec2Int8", "apply_calibration", "calibration", "int8_dense", "quantize_m2fnet", "quantize_roberta",
    "quantize_tree", "quantize_wav2vec2", "quantize_weight", "quantized_bytes", "recollate_batches",
    "split_recollated",
]
