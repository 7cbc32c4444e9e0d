"""End-to-end streaming: wavs and transcripts -> emotion predictions."""

from mer_tpu_torch.pipelines.e2e import E2EModels, StreamingPipeline, mixed_utterance_batches

__all__ = ["E2EModels", "StreamingPipeline", "mixed_utterance_batches"]
