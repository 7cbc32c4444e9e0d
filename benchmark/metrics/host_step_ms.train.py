"""The median host time of a fine-tune step in the traced window: the
program's ``fe.step`` spans (``FESolver.train_epoch``, from a batch's
arrival to the optimizer's return), in ms."""

import statistics

from benchmark.harness import spans


def read(layers: dict):
    found = spans.of(layers)
    if found is None or not found.count("fe.step"):
        return None
    return statistics.median(found.durations_ms("fe.step"))
