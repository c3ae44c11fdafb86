"""ctypes wrapper of the shared-feature bilinear warp kernel
(``csrc/warp_shared.cu``).  The plain PyTorch version of the same function
is ``float_torch.ops.warp.warp_shared_ref``."""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from .build import load

NAME = "warp_shared"
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_INT_MAX = 2 ** 31 - 1


def _lib() -> ctypes.CDLL:
    # every pointer and the stream as c_void_p: undeclared, ctypes would
    # pass a Python int as a 32-bit int and cut the pointer
    lib = load(NAME)
    lib.warp_shared_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.warp_shared_launch.restype = ctypes.c_int
    lib.warp_shared_error_string.argtypes = [ctypes.c_int]
    lib.warp_shared_error_string.restype = ctypes.c_char_p
    return lib


def warp_shared_cuda(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """feat (1, H, W, C) bf16|f32 NHWC-contiguous, grid (B, H, W, 2) f32
    contiguous, both on one CUDA device -> (B, H, W, C) in feat's dtype.
    Raises on anything else."""
    if not (feat.is_cuda and grid.is_cuda and feat.device == grid.device):
        raise ValueError(f"warp_shared_cuda needs feat and grid on one CUDA "
                         f"device, got {feat.device} and {grid.device}")
    if feat.dtype not in _DTYPE_CODE or grid.dtype != torch.float32:
        raise TypeError(f"warp_shared_cuda takes bf16/f32 feat and f32 "
                        f"grid, got {feat.dtype} and {grid.dtype}")
    if feat.ndim != 4 or feat.shape[0] != 1:
        raise ValueError(f"feat must be (1, H, W, C), got {tuple(feat.shape)}")
    _, h, w, c = feat.shape
    if grid.ndim != 4 or tuple(grid.shape[1:]) != (h, w, 2):
        raise ValueError(f"grid must be (B, {h}, {w}, 2), got "
                         f"{tuple(grid.shape)}")
    vec = 16 // feat.element_size()
    if c % vec:
        raise ValueError(f"C={c} must be a multiple of {vec} for "
                         f"{feat.dtype}")
    if not (feat.is_contiguous() and grid.is_contiguous()):
        raise ValueError("feat and grid must be contiguous (NHWC)")
    if feat.data_ptr() % 16 or grid.data_ptr() % 8:
        raise ValueError("feat must be 16-byte and grid 8-byte aligned")
    b = grid.shape[0]
    if max(b, h, w, c) > _INT_MAX:
        raise ValueError("dimension too large")
    out = torch.empty((b, h, w, c), dtype=feat.dtype, device=feat.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = lib.warp_shared_launch(feat.data_ptr(), grid.data_ptr(),
                                 out.data_ptr(), b, h, w, c,
                                 _DTYPE_CODE[feat.dtype], feat.device.index,
                                 stream)
    if err:
        msg = lib.warp_shared_error_string(err).decode()
        raise RuntimeError(f"warp_shared launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES[NAME] += 1
    return out
