"""The numbers that decide ``correct``: gaps between what the window's path
produced and the plain reference, each held to a limit of the cell's
traffic file (``limits``), and readings of the window's trace for the
metrics' readers."""

from __future__ import annotations

import statistics

import torch


def scalar_gap(got: list[float], want: list[float]) -> float:
    """The largest |got - want| / |want| over the pairs."""
    return max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want, strict=True))


def leaf_gaps(got: dict[str, float], want: dict[str, float], keep=None) -> dict[str, float]:
    """Each leaf's |norm got - norm want| over the larger of that leaf's want
    and the median leaf's want (some leaves are all but zero)."""
    names = [k for k in want if keep is None or k in keep]
    median = statistics.median(want[k] for k in names)
    return {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in names}


def worst(gaps: dict[str, float]) -> tuple[str, float]:
    name = max(gaps, key=gaps.get)
    return name, gaps[name]


def row_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each row's ||got - want|| over the larger of that row's ||want|| and
    the median row's ([N, D] float32)."""
    want = want.float()
    norms = want.norm(dim=1)
    floor = norms.median().clamp_min(1e-30)
    return (got.float() - want).norm(dim=1) / torch.maximum(norms, floor)



def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v.detach().float().norm()) for k, v in tensors.items()}


def judged(readings: dict[str, float], limits: dict[str, float]) -> list[tuple[str, float, float]]:
    """(name, reading, limit) for every limit of the cell; a reading that is
    missing counts as failed."""
    return [(name, float(readings.get(name, float("inf"))), float(limit)) for name, limit in limits.items()]
