"""ctypes wrapper of K5, the windowed bilinear warp as a gather on the CUDA
cores (``csrc/warp_window.cu``).  Its plain PyTorch version is
``float_torch.experiments.warp_selection_matmul``'s ``warp_window_ref``
with the overflow pixels taken from
``float_torch.ops.warp.grid_sample_bilinear_ref``
(``warp_bilinear_windowed_ref``)."""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCH_SHAPES, LAUNCHES
from .build import load

NAME = "warp_window"
LIB = "warp_window"
TR, TC = 8, 128          # output tile (rows, cols), as on the TPU
_INT_MAX = 2 ** 31 - 1


def _lib() -> ctypes.CDLL:
    # every pointer and the stream as c_void_p (see warp_shared._lib)
    lib = load(LIB)
    lib.warp_window_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.warp_window_launch.restype = ctypes.c_int
    lib.warp_window_error_string.argtypes = [ctypes.c_int]
    lib.warp_window_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(feat: torch.Tensor, grid: torch.Tensor, my: int,
                 mx: int) -> None:
    """Raise unless feat (B, H, W, C) is bf16 and grid (B, H, W, 2) f32,
    H % 8 == 0, W % 128 == 0 and my, mx >= 0 (the function's own rules,
    checked first), and both are contiguous on one CUDA device, grid
    8-byte aligned and feat 16-byte aligned where C % 8 == 0 (any other C
    is read one channel at a time), H * W * C < 2^31 and B <= 65535."""
    if feat.dtype != torch.bfloat16 or grid.dtype != torch.float32:
        raise TypeError(f"{NAME} takes bf16 feat and f32 grid, got "
                        f"{feat.dtype} and {grid.dtype}")
    if feat.ndim != 4 or grid.ndim != 4 \
            or tuple(grid.shape) != (*feat.shape[:3], 2):
        raise ValueError(f"feat must be (B, H, W, C) and grid (B, H, W, 2), "
                         f"got {tuple(feat.shape)} and {tuple(grid.shape)}")
    b, h, w, c = feat.shape
    if h % TR or w % TC:
        raise ValueError(f"{NAME} needs H % {TR} == 0 and W % {TC} == 0, "
                         f"got {h}, {w}")
    if my < 0 or mx < 0:
        raise ValueError(f"margins my={my}, mx={mx} must be >= 0")
    if not (feat.is_cuda and grid.is_cuda and feat.device == grid.device):
        raise ValueError(f"{NAME} needs feat and grid on one CUDA device, "
                         f"got {feat.device} and {grid.device}")
    if not (feat.is_contiguous() and grid.is_contiguous()):
        raise ValueError("feat and grid must be contiguous (NHWC)")
    if (c % 8 == 0 and feat.data_ptr() % 16) or grid.data_ptr() % 8:
        raise ValueError("feat must be 16-byte and grid 8-byte aligned")
    if max(my, mx, h * w * c) > _INT_MAX or b > 65535:
        raise ValueError(f"{NAME} takes H * W * C < 2^31 and B <= 65535")


def warp_window_cuda(feat: torch.Tensor, grid: torch.Tensor, my: int = 8,
                     mx: int = 64) -> torch.Tensor:
    """K5: feat (B, H, W, C) bf16 warped by grid (B, H, W, 2) f32 ->
    (B, H, W, C) bf16: in-window pixels with the selection product's bf16
    weights, overflow pixels by the exact warp, in one launch.  Raises on
    anything else."""
    check_inputs(feat, grid, my, mx)
    b, h, w, c = feat.shape
    out = torch.empty_like(feat)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    # the caller's current device is restored after the launcher's own
    # cudaSetDevice (see warp_shared._launch)
    with torch.cuda.device(feat.device):
        err = lib.warp_window_launch(feat.data_ptr(), grid.data_ptr(),
                                     out.data_ptr(), b, h, w, c, my, mx,
                                     feat.device.index, stream)
    if err:
        msg = lib.warp_window_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[NAME] += 1
    LAUNCH_SHAPES[(NAME, b, h, w, c)] += 1
    return out
