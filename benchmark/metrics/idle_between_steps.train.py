"""The share of the device's idle time that falls between fine-tune steps:
idle gaps (between the device's busy intervals in the traced window) whose
midpoint lies outside every ``fe.step`` span, over all those gaps, in %."""

from benchmark.harness import spans


def read(layers: dict):
    found = spans.of(layers)
    if found is None or not found.count("fe.step"):
        return None
    idle = found.idle_us("fe.step")
    if idle is None or idle[1] <= 0:
        return None
    return 100.0 * idle[0] / idle[1]
