"""The conv frontend's share of its roofline: the least time of every call
of ``ops.w2v_conv.layer0_gn`` (K7) and ``conv_stack_fused`` (K6) in the
traced window over the device time of all the kernels those calls launched."""

from benchmark.harness import flops


def read(layers: dict):
    trace, calls = layers.get("trace"), layers.get("calls", {})
    l0, tail = calls.get("w2v_layer0", []), calls.get("w2v_tail", [])
    if trace is None or not (l0 or tail):
        return None
    bound = sum(flops.w2v_layer0_bound_s(c["b"], c["n"], c["dtype"]) for c in l0)
    bound += sum(flops.w2v_tail_bound_s(c["b"], c["t0"], c["dtype"]) for c in tail)
    device_s = trace.range_device_s(lambda name: name in ("bench.op.w2v_layer0", "bench.op.w2v_tail"))
    return 100.0 * bound / device_s if device_s > 0 else None
