"""The readings behind the fusion engine's limits in ``tests/test_torch_int8.py``:
for each fixture seed, the port's ``M2FNetInt8`` logits against ``mer_tpu``'s
engine, with its attention restated as the port's and as it is, dynamic and
calibrated, and the restated a8w8 reading of a planted fault (per-tensor
activation scales at every site), each as the largest |difference| over the
largest |logit|; then, at seed 0, the worst site of ``site_outputs`` under
the planted faults (that one in a8w8, static scales 2% off). On the CPU,
from the repository root:

    python tests/int8_fusion_readings.py [FIRST_SEED LAST_SEED]   # default 0 7
"""

import os
import sys
from unittest import mock

import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]  # test_torch_int8, and the two packages at the repository root

import jax  # noqa: E402

import test_torch_int8 as t  # noqa: E402
from mer_tpu import serving as jax_serving  # noqa: E402
from mer_tpu_torch.serving import quant  # noqa: E402


def per_tensor_fault(x, wq, bias, act_scale=None, weight_only=False, _dense=quant.int8_dense):
    """``int8_dense`` with one activation scale for the whole tensor in place of one a row."""
    if act_scale is None and not weight_only:
        act_scale = (x.float().abs().amax() / 127.0).clamp_min(1e-12)
    return _dense(x, wq, bias, act_scale, weight_only)


def readings(seed: int) -> dict:
    f = t.fusion_case(seed)
    jqp = jax_serving.quantize_m2fnet(f["params"])
    jax_engine, engine = jax_serving.M2FNetInt8(f["jax_model"]), quant.M2FNetInt8(f["port"])
    with t._restated():
        restated = np.asarray(jax.jit(jax_engine.apply)(jqp, *f["np"]))[:, :7]
    as_is = np.asarray(jax.jit(jax_engine.apply)(jqp, *f["np"]))[:, :7]
    qp = quant.quantize_m2fnet(f["port"])
    got = t._port_logits(f, qp)[:, :7]
    with mock.patch.object(quant, "int8_dense", per_tensor_fault):
        fault = t._port_logits(f, qp)[:, :7]
    with torch.inference_mode(), quant.calibration(qp) as sink:
        engine.apply(qp, *f["torch"])
    with jax_serving.calibration(jqp) as jsink:  # op by op, as the calibration pass must run
        jax_engine.apply(jqp, *f["np"])
    static = t._port_logits(f, quant.apply_calibration(qp, sink))[:, :7]
    static_as_is = np.asarray(jax.jit(jax_engine.apply)(jax_serving.apply_calibration(jqp, jsink), *f["np"]))[:, :7]
    return {"seed": seed, "a8w8_restated": t._rel(got, restated), "a8w8_as_is": t._rel(got, as_is),
            "static_as_is": t._rel(static, static_as_is), "fault_restated": t._rel(fault, restated)}


def scaled_static_fault(x, wq, bias, act_scale=None, weight_only=False, _dense=quant.int8_dense):
    """``int8_dense`` with every static activation scale 2% too large."""
    return _dense(x, wq, bias, None if act_scale is None else act_scale * 1.02, weight_only)


def site_fault_readings(seed: int = 0) -> dict:
    f, out = t.fusion_case(seed), {}
    for name, fault, mode in (("per_tensor_a8w8", per_tensor_fault, "a8w8"),
                              ("static_scales_2pct", scaled_static_fault, "static")):
        with mock.patch.object(quant, "int8_dense", fault):
            want, got = t.site_outputs(f, mode)
        out[name] = max(t._rel(g, w) for g, w in zip(got, want))
    return out


if __name__ == "__main__":
    torch.set_num_threads(2)
    first, last = (int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2 else (0, 7)
    for seed in range(first, last + 1):
        print(readings(seed), flush=True)
    print("worst site under a planted fault, seed 0:", site_fault_readings(0))
