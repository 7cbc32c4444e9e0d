"""The median host time to dispatch one utterance batch of the stream: the
program's ``stream.batch`` spans (both encoders' calls on one batch in
``StreamingPipeline.embed_utterances``), in ms."""

import statistics

from benchmark.harness import spans


def read(layers: dict):
    found = spans.of(layers)
    if found is None or not found.count("stream.batch"):
        return None
    return statistics.median(found.durations_ms("stream.batch"))
