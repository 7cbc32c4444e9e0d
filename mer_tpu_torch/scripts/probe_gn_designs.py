"""K8's function in two designs on the card: K8 itself (``csrc/w2v_gn_gelu.cu``:
a statistics grid, a finalize pass and an apply grid, x read twice from HBM)
and one persistent cooperative grid that walks the batch clip by clip and
reads each clip's second pass back from L2 (``csrc/probe_gn_grid_sync.cu``,
a probe, on no path of the port).

    python -m mer_tpu_torch.scripts.probe_gn_designs

At K8's shapes in ``chip_smoke.py`` ([32, 31999, 512], [2, 12799, 512] and
the ragged [3, 301, 512] with 7 valid rows), f32 and bf16, each design is
held against K8's plain version (f32 within 1e-4 absolute and relative,
bf16 within 2e-2 of the plain version's largest value: chip_smoke's limits)
and timed: calls captured in a CUDA graph and replayed between CUDA events,
in the order K8, probe, probe, K8, so that a card that slows under load
shows in the pairs. One JSON line a case; each names the card and its power
limit. The bound is one read and one write of x at 3.35 TB/s (H100 SXM
HBM3). Needs a card: there is no CPU version of a probe.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from mer_tpu_torch.ops import _build, w2v_conv
from mer_tpu_torch.scripts.bench_attention import device_ms
from mer_tpu_torch.utils.profiling import HBM_BYTES_PER_S

PROBE = "probe_gn_grid_sync"
SHAPES = [((32, 31999, 512), 31999), ((2, 12799, 512), 12799), ((3, 301, 512), 7)]
BF16_REL = 2e-2
EPS = 1e-5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _probe_fns():
    lib = _build.load(PROBE)
    run = getattr(lib, f"mer_{PROBE}")
    run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    run.restype = ctypes.c_int
    blocks = getattr(lib, f"mer_{PROBE}_blocks")
    blocks.argtypes, blocks.restype = [ctypes.c_int], ctypes.c_int
    return run, blocks


def grid_sync_gn_gelu(x, scale, bias, t_valid: int, eps: float = EPS) -> torch.Tensor:
    """The probe's design on a CUDA x [B, T, 512]: the function of
    ``w2v_conv.gn_gelu``."""
    run, blocks = _probe_fns()
    b, rows, c = x.shape
    grid = blocks(_DTYPE_CODE[x.dtype])
    if grid <= 0:
        raise RuntimeError(f"{PROBE}: no cooperative grid (cudaError {-grid})")
    out = torch.empty_like(x)
    partial = torch.empty((grid, 2, c), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    gamma, beta = (p.float().contiguous() for p in (scale, bias))
    rc = run(_DTYPE_CODE[x.dtype], x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), partial.data_ptr(),
             stats.data_ptr(), out.data_ptr(), b, rows, int(t_valid), grid, float(eps),
             torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{PROBE} launch failed: cudaError {rc} at x {tuple(x.shape)} {x.dtype}")
    return out


def excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |error| over the limit (<= 0 passes)."""
    err, want = (got.float() - want.float()).abs(), want.float()
    if got.dtype == torch.float32:
        return (err - (1e-4 + 1e-4 * want.abs())).max().item()
    return (err.max() - BF16_REL * want.abs().max()).item()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_gn_designs needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()
    failed = []
    for i, (shape, t_valid) in enumerate(SHAPES):
        gen = torch.Generator().manual_seed(900 + i)
        x32 = torch.randn(shape, generator=gen) * 1.5 + 0.3
        scale, bias = 1 + 0.1 * torch.randn(shape[2], generator=gen), 0.1 * torch.randn(shape[2], generator=gen)
        scale, bias = scale.cuda(), bias.cuda()
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to("cuda", dtype)
            want = w2v_conv.gn_gelu_reference(x, scale, bias, t_valid, EPS)
            designs = {"k8": lambda: w2v_conv.gn_gelu(x, scale, bias, t_valid, EPS),
                       "grid_sync": lambda: grid_sync_gn_gelu(x, scale, bias, t_valid, EPS)}
            result = {"shape": list(shape), "t_valid": t_valid, "dtype": str(dtype).split(".")[-1]}
            for name, fn in designs.items():
                got = fn()
                torch.cuda.synchronize()
                result[f"{name}_excess"] = excess(got, want)
                result[f"{name}_same_bits"] = bool(torch.equal(got, fn()))
                if result[f"{name}_excess"] > 0 or not result[f"{name}_same_bits"]:
                    failed.append(f"{name} {shape} {dtype}")
            reps, replays = (3, 4) if shape[0] * shape[1] > 1e6 else (20, 10)
            times = {name: [] for name in designs}
            for name in ("k8", "grid_sync", "grid_sync", "k8"):
                times[name].append(device_ms(designs[name], reps, replays))
            bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            result.update({"ms": times, "bound_ms": bound,
                           "share_of_bound": {n: bound / (sum(t) / len(t)) for n, t in times.items()},
                           "blocks": _probe_fns()[1](_DTYPE_CODE[dtype]), "card": card})
            print(json.dumps(result), flush=True)
            del x, want
            torch.cuda.empty_cache()
    print(card)
    if failed:
        print(f"probe_gn_designs: outside the limits or not the same bits: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
