"""The stream's wait for its prefetch thread, in ms a pass: the program's
``stream.wait`` spans (the consumer's wait for the next device batch) summed
over the traced window, over the number of ``stream.pass`` spans."""

from benchmark.harness import spans


def read(layers: dict):
    found = spans.of(layers)
    if found is None or not found.count("stream.pass"):
        return None
    return sum(found.durations_ms("stream.wait")) / found.count("stream.pass")
