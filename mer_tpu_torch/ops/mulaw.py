"""μ-law (ITU-T G.711, μ = 255) 8-bit wire codec for waveforms crossing from
the host to the device (counterpart of ``mer_tpu/ops/mulaw.py``).

The streaming pipeline ships waveforms as int16 PCM by default (exact);
``--wire mulaw`` halves those bytes again with 8-bit companding, at about
35-38 dB SNR on speech-shaped signals. The host encodes with numpy; the
device decodes with the closed form below, elementwise, no table.

Codes: ``code = round(y * 127) + 128`` over the compressed ``y`` in [-1, 1],
so codes span [1, 255] and code 128 decodes to exactly 0.0: batch padding
is silence on both wires.

    encode (host):    y = sign(x) ln(1 + μ|x|) / ln(1 + μ)
    decode (device):  y = (code - 128) / 127,  x = sign(y) (exp(|y| ln(1 + μ)) - 1) / μ
"""

from __future__ import annotations

import numpy as np
import torch

MU = 255.0
_LOG1P_MU = float(np.log1p(MU))
#: the code that decodes to exactly 0.0 (batch padding)
MULAW_ZERO = 128


def mulaw_encode_np(x: np.ndarray) -> np.ndarray:
    """Float waveform in [-1, 1] (clipped) -> uint8 μ-law codes, on the host."""
    x = np.clip(x, -1.0, 1.0)
    y = np.sign(x) * np.log1p(MU * np.abs(x)) / _LOG1P_MU
    return (np.rint(y * 127.0) + 128.0).astype(np.uint8)


def mulaw_decode(codes: torch.Tensor) -> torch.Tensor:
    """uint8 μ-law codes -> float32 waveform, on the codes' device."""
    y = (codes.to(torch.float32) - 128.0) / 127.0
    return torch.sign(y) * torch.expm1(y.abs() * _LOG1P_MU) / MU


def mulaw_decode_np(codes: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`mulaw_decode`."""
    y = (codes.astype(np.float32) - 128.0) / 127.0
    return (np.sign(y) * np.expm1(np.abs(y) * _LOG1P_MU) / MU).astype(np.float32)
