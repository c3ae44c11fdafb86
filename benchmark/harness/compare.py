"""The numbers that decide ``correct``, each the worst over what it
reads, so that a single altered frame shows."""
from __future__ import annotations

import torch


def frame_mae_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest, over the frames, of a frame's mean absolute gap (both
    (T, ...) on one device, on one scale).  The mean absolute gap of two
    values rounded to one grid grows as their gap before rounding does,
    where a root-mean-square gap grows as its square root."""
    if got.shape != want.shape:
        return float("inf")
    d = (got.double() - want.double()).reshape(got.shape[0], -1)
    return float(d.abs().mean(1).max())


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||."""
    if got.shape != want.shape:
        return float("inf")
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())
