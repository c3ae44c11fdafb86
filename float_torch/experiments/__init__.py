"""Counterparts of the repository's two TPU probes in ``experiments/``,
each a hand-written Hopper kernel beside its plain PyTorch version:

- ``warp_selection_matmul``: the TPU's windowed selection-matmul warp,
  on the card a gather on the CUDA cores (K5,
  ``kernels/csrc/warp_window.cu``), beside the exact gather K3 and
  ``F.grid_sample``;
- ``fma_dtype_bench``: a dependent multiply-add chain in f32 and packed
  bf16 on the CUDA cores (K6, ``kernels/csrc/fma_dtype.cu``).

Each runs as ``python -m float_torch.experiments.<name>``, on the card
unless given ``--device cpu`` (the plain versions at tiny sizes); without
a card it stops rather than carry on with the CPU.
"""
from __future__ import annotations

import time

import torch


def time_ms(fn, device: torch.device, iters: int) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after one warm-up call:
    CUDA events on a card (device time), the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
