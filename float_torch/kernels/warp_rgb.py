"""ctypes wrapper of K2, the shared-map warp with the last 1×1 ToRGB
contracted in its epilogue (``csrc/warp_rgb.cu``).  Its plain PyTorch
version is ``float_torch.ops.warp.warp_rgb_ref``."""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCH_SHAPES, LAUNCHES
from .build import load
from .warp_shared import DTYPE_CODE, check_warp_inputs

NAME = "warp_rgb"
MAX_C = 2048     # wk (3, C) f32 and the output tile fit 48 KB of shared memory


def _lib() -> ctypes.CDLL:
    # every pointer and the stream as c_void_p (see warp_shared._lib)
    lib = load(NAME)
    lib.warp_rgb_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.warp_rgb_launch.restype = ctypes.c_int
    lib.warp_rgb_error_string.argtypes = [ctypes.c_int]
    lib.warp_rgb_error_string.restype = ctypes.c_char_p
    return lib


def warp_rgb_cuda(feat: torch.Tensor, grid: torch.Tensor,
                  wk: torch.Tensor) -> torch.Tensor:
    """feat (1, H, W, C) bf16|f32, grid (B, H, W, 2) f32, wk (3, C) f32,
    all contiguous on one CUDA device -> (B, H, W, 3) in feat's dtype.
    Raises on anything else."""
    check_warp_inputs(NAME, feat, grid, 1)
    c = feat.shape[-1]
    if wk.device != feat.device or wk.dtype != torch.float32 \
            or tuple(wk.shape) != (3, c) or not wk.is_contiguous():
        raise ValueError(f"wk must be a contiguous (3, {c}) f32 tensor on "
                         f"{feat.device}, got {tuple(wk.shape)} {wk.dtype} "
                         f"on {wk.device}")
    if c > MAX_C:
        raise ValueError(f"C={c} > {MAX_C}")
    b, h, w = grid.shape[:3]
    out = torch.empty((b, h, w, 3), dtype=feat.dtype, device=feat.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = lib.warp_rgb_launch(feat.data_ptr(), grid.data_ptr(),
                              wk.data_ptr(), out.data_ptr(), b, h, w, c,
                              DTYPE_CODE[feat.dtype], feat.device.index,
                              stream)
    if err:
        msg = lib.warp_rgb_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[NAME] += 1
    LAUNCH_SHAPES[(NAME, b, h, w, c)] += 1
    return out
