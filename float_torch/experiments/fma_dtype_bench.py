"""Multiply-add throughput in f32 against packed bf16 on the CUDA cores
(twin of ``experiments/vpu_dtype_bench.py``).

The question: would the warps' tap arithmetic run faster in bf16?  On
the TPU v5e the answer was no (no packed-bf16 VPU win); Hopper's CUDA
cores run ``bfloat162`` arithmetic, two elements an instruction, so the
card gets its own reading.

The probe (``fma_chain_ref``, K6 on a card): on (TILES, 8, 128, 128)
elements x, acc = x in the accumulator's type, then ``n_ops`` times
acc = acc + x * k_i with k_i = 0.5 + i * 1e-3 rounded to that type, each
product and sum rounded on its own; the result in x's dtype.  Three
variants: f32 in / f32 acc, bf16 in / f32 acc, bf16 in / bf16 acc.
``main`` prints each variant's time at N_OPS = 64 steps, as the TPU probe
did, and at 1024, where the ALUs and not the memory set the pace, each
with the speed-up line.

    python -m float_torch.experiments.fma_dtype_bench [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..runtime.pipeline import _checked_device
from ..utils.flops import (H100_BF16_VECTOR_FLOPS, H100_F32_FLOPS,
                           H100_HBM_BPS)
from . import time_ms

N_OPS = 64
TILES = 256
TILE = (8, 128, 128)
LONG_OPS = 1024           # ALU-bound chain length of main's second table
CPU_TILES = 2             # --device cpu: the plain chain at a tiny size
VARIANTS = (("f32  in, f32 acc", torch.float32, torch.float32),
            ("bf16 in, f32 acc", torch.bfloat16, torch.float32),
            ("bf16 in, bf16 acc", torch.bfloat16, torch.bfloat16))


def constants(acc_dtype: torch.dtype, n_ops: int = N_OPS,
              device=None) -> torch.Tensor:
    """k_i = acc_dtype(0.5 + i * 1e-3), i < n_ops, as the TPU probe
    rounds them (through f32)."""
    k = torch.tensor([0.5 + i * 1e-3 for i in range(n_ops)],
                     dtype=torch.float32)
    return k.to(acc_dtype).to(device)


def fma_chain_ref(x: torch.Tensor, acc_dtype: torch.dtype,
                  n_ops: int = N_OPS) -> torch.Tensor:
    """Plain version of K6: acc = x as acc_dtype, then acc = acc + x * k_i
    for i < n_ops, each op a torch op in acc_dtype; -> x's dtype."""
    ks = constants(acc_dtype, n_ops, x.device)
    xa = x.to(acc_dtype)
    acc = xa
    for i in range(n_ops):
        acc = acc + xa * ks[i]
    return acc.to(x.dtype)


def make(dtype: torch.dtype, acc_dtype: torch.dtype, n_ops: int = N_OPS):
    """The probe for one variant: ``run(x)`` takes x of ``dtype`` and
    launches K6 on a CUDA tensor, the plain chain on a CPU tensor."""
    from ..kernels.fma_dtype import KINDS
    if (dtype, acc_dtype) not in KINDS:
        raise TypeError(f"no variant ({dtype}, {acc_dtype})")
    k_by_device = {}

    def run(x: torch.Tensor) -> torch.Tensor:
        if x.dtype != dtype:
            raise TypeError(f"x must be {dtype}, got {x.dtype}")
        if x.device.type == "cpu":
            return fma_chain_ref(x, acc_dtype, n_ops)
        from ..kernels.fma_dtype import fma_chain_cuda
        k = k_by_device.get(x.device)
        if k is None:
            k = k_by_device[x.device] = constants(
                acc_dtype, n_ops, x.device).float()
        return fma_chain_cuda(x, acc_dtype, k)
    return run


def bound(n: int, dtype: torch.dtype, acc_dtype: torch.dtype,
          n_ops: int) -> tuple:
    """(least ms on an H100, "bytes" or "operations"): n elements read and
    written once in dtype, against n_ops steps an element, each step two
    instructions, because the probe rounds the product before the add: a
    multiply and an add, each at the CUDA cores' issue rate for acc_dtype.
    The published rates (f32 67, packed bf16 133.8 TFLOP/s) count a fused
    multiply-add as 2 operations, so an instruction issues at half of
    them."""
    esize = torch.empty((), dtype=dtype).element_size()
    rate = H100_F32_FLOPS if acc_dtype == torch.float32 \
        else H100_BF16_VECTOR_FLOPS
    tb = 2 * n * esize / H100_HBM_BPS * 1e3
    to = 2 * n * n_ops / (rate / 2) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bench(name: str, dtype: torch.dtype, acc_dtype: torch.dtype,
          n_ops: int = N_OPS, device="cuda", tiles: int = TILES,
          iters: int = 20) -> float:
    """Mean ms of one call of the probe on ones((tiles, 8, 128, 128)):
    device time on a card, host time on the CPU; prints the probe's line."""
    device = _checked_device(device)
    run = make(dtype, acc_dtype, n_ops)
    x = torch.ones((tiles, *TILE), dtype=dtype, device=device)
    ms = time_ms(lambda: run(x), device, iters)
    elems = x.numel() * n_ops
    line = (f"{name}: {ms:.4f} ms  ({elems / ms / 1e9:.2f} T fma-elems/s, "
            f"{n_ops} steps)")
    if device.type == "cuda":
        bnd, by = bound(x.numel(), dtype, acc_dtype, n_ops)
        line += f"; bound {bnd:.4f} ms ({by}), {bnd / ms:.1%}"
    else:
        line += " on the CPU (plain chain, host clock)"
    print(line, flush=True)
    return ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain chain at a tiny "
                         "size")
    device = _checked_device(ap.parse_args(argv).device)
    on_card = device.type == "cuda"
    tiles, iters = (TILES, 20) if on_card else (CPU_TILES, 2)
    if on_card:
        print(f"device: {torch.cuda.get_device_name(device)}")
    out = {}
    for n_ops in (N_OPS, LONG_OPS):
        a, b, c = (bench(name, dt, acc, n_ops, device, tiles, iters)
                   for name, dt, acc in VARIANTS)
        print(f"bf16-acc speedup vs f32-acc: {a / c:.2f}x; vs "
              f"bf16-in/f32-acc: {b / c:.2f}x ({n_ops} steps)", flush=True)
        out[n_ops] = (a, b, c)
    return out


if __name__ == "__main__":
    try:
        main()
    except RuntimeError as e:
        print(f"fma_dtype_bench: {e}", file=sys.stderr)
        sys.exit(1)
