"""Kernel-launch calls a fine-tune step: the traced window's launch calls
whose host time falls inside a ``fe.step`` span (the backward's, from
autograd's device thread, count too), over the number of those spans."""

from benchmark.harness import spans


def read(layers: dict):
    found = spans.of(layers)
    if found is None or not found.count("fe.step"):
        return None
    inside = found.launches_inside("fe.step")
    return None if inside is None else inside / found.count("fe.step")
