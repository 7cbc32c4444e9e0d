"""Kernel-launch calls an utterance batch: the traced window's launch calls
whose host time falls inside a ``stream.batch`` span, over the number of
those spans."""

from benchmark.harness import spans


def read(layers: dict):
    found = spans.of(layers)
    if found is None or not found.count("stream.batch"):
        return None
    inside = found.launches_inside("stream.batch")
    return None if inside is None else inside / found.count("stream.batch")
