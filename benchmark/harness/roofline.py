"""Shared by the roofline readers (``benchmark/metrics/*_roofline.*``): the least time of an entry's recorded
calls (``benchmark/harness/flops.py``) over the device time of the kernels
launched inside those calls and inside their backward nodes."""

from benchmark.harness import flops


def attention_bound_s(calls: list[dict]) -> float:
    total = 0.0
    for c in calls:
        shape = (c["b"], c["h"], c["sq"], c["sk"], c["dh"], c["dtype"])
        total += flops.attention_bound_s(True, *shape)
        if c["grad"]:
            total += flops.attention_bound_s(False, *shape)
    return total


def share_pct(layers: dict, entry: str, bound_s: float):
    """100 x bound / device time of ``entry``'s calls and backward nodes; None
    when the trace holds no call of it."""
    trace, calls = layers.get("trace"), layers.get("calls", {}).get(entry)
    if trace is None or not calls:
        return None
    nodes = {"autograd::engine::evaluate_function: " + n for n in layers.get("backward_nodes", {}).get(entry, [])}
    device_s = trace.range_device_s(lambda name: name == "bench.op." + entry or name in nodes)
    return 100.0 * bound_s / device_s if device_s > 0 else None
