"""ctypes wrapper of K6, the dependent multiply-add chain of
``csrc/fma_dtype.cu``.  Its plain PyTorch version is
``float_torch.experiments.fma_dtype_bench.fma_chain_ref``."""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from .build import load

NAME = "fma_dtype"
MAX_OPS = 4096
# (input/output dtype, accumulator dtype) -> the launcher's kind
KINDS = {(torch.float32, torch.float32): 0,
         (torch.bfloat16, torch.float32): 1,
         (torch.bfloat16, torch.bfloat16): 2}


def _lib() -> ctypes.CDLL:
    # every pointer and the stream as c_void_p (see warp_shared._lib)
    lib = load(NAME)
    lib.fma_dtype_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.fma_dtype_launch.restype = ctypes.c_int
    lib.fma_dtype_error_string.argtypes = [ctypes.c_int]
    lib.fma_dtype_error_string.restype = ctypes.c_char_p
    return lib


def fma_chain_cuda(x: torch.Tensor, acc_dtype: torch.dtype,
                   k: torch.Tensor) -> torch.Tensor:
    """K6: acc = x (as acc_dtype); acc = acc + x * k[i] for each of the
    len(k) constants, each product and sum rounded in acc_dtype; returned
    in x's dtype.  x: contiguous CUDA f32 or bf16 (with acc_dtype as
    ``KINDS`` pairs them), numel % 8 == 0, 16-byte aligned; k: the
    constants as f32 on x's device, already rounded to acc_dtype.  Raises
    on anything else."""
    kind = KINDS.get((x.dtype, acc_dtype))
    if kind is None:
        raise TypeError(f"{NAME} takes (f32, f32), (bf16, f32) or "
                        f"(bf16, bf16), got ({x.dtype}, {acc_dtype})")
    if not x.is_cuda or k.device != x.device:
        raise ValueError(f"{NAME} needs x and k on one CUDA device, got "
                         f"{x.device} and {k.device}")
    if k.dtype != torch.float32 or k.ndim != 1 or len(k) > MAX_OPS \
            or not k.is_contiguous():
        raise ValueError(f"k must be a contiguous 1-D f32 tensor of at most "
                         f"{MAX_OPS} constants")
    if not x.is_contiguous() or x.numel() % 8 or x.data_ptr() % 16:
        raise ValueError("x must be contiguous, 16-byte aligned, with a "
                         "multiple of 8 elements")
    out = torch.empty_like(x)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # the caller's current device is restored after the launcher's own
    # cudaSetDevice (see warp_shared._launch)
    with torch.cuda.device(x.device):
        err = lib.fma_dtype_launch(x.data_ptr(), out.data_ptr(), k.data_ptr(),
                                   x.numel(), len(k), kind, x.device.index,
                                   stream)
    if err:
        msg = lib.fma_dtype_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[NAME] += 1
    return out
