"""ctypes wrappers of the bilinear warp kernels of ``csrc/warp_shared.cu``:
K1 (one map shared by the frames, ``warp_shared_cuda``, staged by the plan
of ``warp_plan.plan_shared``) and K3 (one map per frame,
``warp_per_frame_cuda``).  Their plain PyTorch versions are
``float_torch.ops.warp.warp_shared_ref`` and ``warp_per_frame_ref``."""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCH_SHAPES, LAUNCHES
from .build import load
from .warp_plan import Plan, plan_shared

LIB = "warp_shared"
DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_INT_MAX = 2 ** 31 - 1


def _lib() -> ctypes.CDLL:
    # every pointer and the stream as c_void_p: undeclared, ctypes would
    # pass a Python int as a 32-bit int and cut the pointer
    lib = load(LIB)
    ptrs = [ctypes.c_void_p] * 3
    shape = [ctypes.c_int] * 4                      # B, H, W, C
    tail = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # dtype, device, stream
    lib.warp_shared_launch.argtypes = (ptrs + shape
                                       + [ctypes.c_int] * len(Plan._fields)
                                       + tail)
    lib.warp_per_frame_launch.argtypes = ptrs + shape + tail
    for fn in (lib.warp_shared_launch, lib.warp_per_frame_launch):
        fn.restype = ctypes.c_int
    lib.warp_shared_error_string.argtypes = [ctypes.c_int]
    lib.warp_shared_error_string.restype = ctypes.c_char_p
    return lib


def check_warp_inputs(name: str, feat: torch.Tensor, grid: torch.Tensor,
                      feat_batch: int, any_channels: bool = False) -> None:
    """Raise unless feat (feat_batch, H, W, C) bf16|f32 and grid
    (B, H, W, 2) f32 are contiguous on one CUDA device, grid 8-byte
    aligned, and C a whole number of 16-byte vectors with feat 16-byte
    aligned; ``any_channels`` (K3) takes any other C too, which the kernel
    reads one channel at a time."""
    if not (feat.is_cuda and grid.is_cuda and feat.device == grid.device):
        raise ValueError(f"{name} needs feat and grid on one CUDA device, "
                         f"got {feat.device} and {grid.device}")
    if feat.dtype not in DTYPE_CODE or grid.dtype != torch.float32:
        raise TypeError(f"{name} takes bf16/f32 feat and f32 grid, got "
                        f"{feat.dtype} and {grid.dtype}")
    if feat.ndim != 4 or feat.shape[0] != feat_batch:
        raise ValueError(f"feat must be ({feat_batch}, H, W, C), got "
                         f"{tuple(feat.shape)}")
    _, h, w, c = feat.shape
    if grid.ndim != 4 or tuple(grid.shape[1:]) != (h, w, 2):
        raise ValueError(f"grid must be (B, {h}, {w}, 2), got "
                         f"{tuple(grid.shape)}")
    vec = 16 // feat.element_size()
    if c % vec and not any_channels:
        raise ValueError(f"C={c} must be a multiple of {vec} for "
                         f"{feat.dtype}")
    if not (feat.is_contiguous() and grid.is_contiguous()):
        raise ValueError("feat and grid must be contiguous (NHWC)")
    if (c % vec == 0 and feat.data_ptr() % 16) or grid.data_ptr() % 8:
        raise ValueError("feat must be 16-byte and grid 8-byte aligned")
    if max(grid.shape[0], h, w, c) > _INT_MAX:
        raise ValueError("dimension too large")


def _launch(name: str, feat: torch.Tensor, grid: torch.Tensor,
            plan: Plan | None) -> torch.Tensor:
    """Launch K1 (with its plan) or K3 (plan None) on checked inputs."""
    b = grid.shape[0]
    _, h, w, c = feat.shape
    out = torch.empty((b, h, w, c), dtype=feat.dtype, device=feat.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    args = (feat.data_ptr(), grid.data_ptr(), out.data_ptr(), b, h, w, c)
    tail = (DTYPE_CODE[feat.dtype], feat.device.index, stream)
    if plan is None:
        err = lib.warp_per_frame_launch(*args, *tail)
    else:
        err = lib.warp_shared_launch(*args, *plan, *tail)
    if err:
        msg = lib.warp_shared_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, b, h, w, c)] += 1
    return out


def warp_shared_cuda(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """K1: feat (1, H, W, C) shared by the frames, grid (B, H, W, 2)
    -> (B, H, W, C) in feat's dtype, launched with ``plan_shared``'s plan
    for the shape.  Raises on anything else."""
    check_warp_inputs("warp_shared", feat, grid, 1)
    shape = (grid.shape[0], *feat.shape[1:])
    if math.prod(shape) == 0:
        return feat.new_empty(shape)
    return _launch("warp_shared", feat, grid,
                   plan_shared(*shape, feat.element_size()))


def warp_per_frame_cuda(feat: torch.Tensor,
                        grid: torch.Tensor) -> torch.Tensor:
    """K3: feat (B, H, W, C), any C, frame b warped by grid[b]
    (B, H, W, 2) -> (B, H, W, C) in feat's dtype.  Raises on anything
    else."""
    check_warp_inputs("warp_per_frame", feat, grid, grid.shape[0],
                      any_channels=True)
    return _launch("warp_per_frame", feat, grid, None)
