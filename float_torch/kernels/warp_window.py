"""ctypes wrapper of K5, the windowed bilinear warp as selection products
on the tensor cores (``csrc/warp_window_mma.cu``).  Its plain PyTorch
version is ``float_torch.experiments.warp_selection_matmul``'s
``warp_window_ref`` with the overflow pixels taken from
``float_torch.ops.warp.grid_sample_bilinear_ref``."""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCH_SHAPES, LAUNCHES
from .build import load

NAME = "warp_window"
LIB = "warp_window_mma"
TR, TC = 8, 128          # output tile (rows, cols), as on the TPU
# A ring chunk holds 48 KB: one window row of 8-channel blocks must fit.
MAX_WINDOW_COLS = 3072
MMA_FLOPS = 2 * 16 * 8 * 16   # one mma.sync.m16n8k16
_INT_MAX = 2 ** 31 - 1


def _lib() -> ctypes.CDLL:
    # every pointer and the stream as c_void_p (see warp_shared._lib)
    lib = load(LIB)
    lib.warp_window_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    lib.warp_window_launch.restype = ctypes.c_int
    lib.warp_window_error_string.argtypes = [ctypes.c_int]
    lib.warp_window_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(feat: torch.Tensor, grid: torch.Tensor, my: int,
                 mx: int) -> None:
    """Raise unless feat (B, H, W, C) bf16 and grid (B, H, W, 2) f32 are
    contiguous on one CUDA device, H % 8 == 0, W % 128 == 0, C % 8 == 0,
    feat 16-byte and grid 8-byte aligned, my, mx >= 0 and the window at
    most MAX_WINDOW_COLS columns wide."""
    if not (feat.is_cuda and grid.is_cuda and feat.device == grid.device):
        raise ValueError(f"{NAME} needs feat and grid on one CUDA device, "
                         f"got {feat.device} and {grid.device}")
    if feat.dtype != torch.bfloat16 or grid.dtype != torch.float32:
        raise TypeError(f"{NAME} takes bf16 feat and f32 grid, got "
                        f"{feat.dtype} and {grid.dtype}")
    if feat.ndim != 4 or grid.ndim != 4 \
            or tuple(grid.shape) != (*feat.shape[:3], 2):
        raise ValueError(f"feat must be (B, H, W, C) and grid (B, H, W, 2), "
                         f"got {tuple(feat.shape)} and {tuple(grid.shape)}")
    b, h, w, c = feat.shape
    if h % TR or w % TC or c % 8:
        raise ValueError(f"{NAME} needs H % {TR}, W % {TC} and C % 8 == 0, "
                         f"got {h}, {w}, {c}")
    if my < 0 or mx < 0 or min(w, TC + 2 * mx) > MAX_WINDOW_COLS:
        raise ValueError(f"margins my={my}, mx={mx}: need >= 0 and a window "
                         f"of at most {MAX_WINDOW_COLS} columns")
    if not (feat.is_contiguous() and grid.is_contiguous()):
        raise ValueError("feat and grid must be contiguous (NHWC)")
    if feat.data_ptr() % 16 or grid.data_ptr() % 8:
        raise ValueError("feat must be 16-byte and grid 8-byte aligned")
    if max(b * (c // 8), h, w, c) > _INT_MAX:
        raise ValueError("dimension too large")


def warp_window_cuda(feat: torch.Tensor, grid: torch.Tensor, my: int = 8,
                     mx: int = 64,
                     mma_count: torch.Tensor | None = None) -> torch.Tensor:
    """K5: feat (B, H, W, C) bf16 warped by grid (B, H, W, 2) f32 ->
    (B, H, W, C) bf16, in-window pixels by the tensor cores' selection
    products, overflow pixels by the exact warp, in one launch.
    ``mma_count``, a one-element int64 tensor on feat's device, receives
    the number of MMAs issued (added to it).  Raises on anything else."""
    check_inputs(feat, grid, my, mx)
    if mma_count is not None and (mma_count.device != feat.device
                                  or mma_count.dtype != torch.int64
                                  or mma_count.numel() != 1):
        raise ValueError("mma_count must be one int64 on feat's device")
    b, h, w, c = feat.shape
    out = torch.empty_like(feat)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    count = 0 if mma_count is None else mma_count.data_ptr()
    # the caller's current device is restored after the launcher's own
    # cudaSetDevice (see warp_shared._launch)
    with torch.cuda.device(feat.device):
        err = lib.warp_window_launch(feat.data_ptr(), grid.data_ptr(),
                                     out.data_ptr(), b, h, w, c, my, mx,
                                     count, feat.device.index, stream)
    if err:
        msg = lib.warp_window_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[NAME] += 1
    LAUNCH_SHAPES[(NAME, b, h, w, c)] += 1
    return out
