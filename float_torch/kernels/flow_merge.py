"""ctypes wrapper of K8 (``csrc/flow_merge.cu``): a decode level's flow
merge on channels_last maps, ``flow_merge_cuda``.  Its plain PyTorch
version is ``float_torch.ops.tails.flow_merge_ref``.

Launches count under ``flow_merge``, or ``flow_merge_last`` for the last
level's form, which writes no merged map."""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCH_SHAPES, LAUNCHES
from .build import load
from .styled_tail import DTYPE_CODE, _check_map, _nhwc, _per_frame

LIB = "flow_merge"
NAME = "flow_merge"
NAME_LAST = "flow_merge_last"


def _lib() -> ctypes.CDLL:
    # every pointer and the stream as c_void_p: undeclared, ctypes would
    # pass a Python int as a 32-bit int and cut the pointer
    lib = load(LIB)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.flow_merge_launch.argtypes = (
        [ptr, ptr, i64, i64, i64, ptr, ptr, ptr, ptr]
        + [ctypes.c_int] * 6 + [ptr])      # B, H, W, C, dtype, device; stream
    lib.flow_merge_launch.restype = ctypes.c_int
    lib.flow_merge_error_string.argtypes = [ctypes.c_int]
    lib.flow_merge_error_string.restype = ctypes.c_char_p
    return lib


def flow_merge_cuda(warped: torch.Tensor, out: torch.Tensor,
                    x: torch.Tensor | None = None,
                    scale: torch.Tensor | None = None) -> tuple:
    """K8: warped (B, C, H, W) channels_last bf16|f32 on a card, out
    (B, 3, H, W) ToFlow's raw output in its dtype (any strides), and for
    the merge x (B, C, H, W) like warped with scale (B, C) in its dtype
    -> (feat_warp, merged), both channels_last: mask = sigmoid(out[:, 2]),
    feat_warp = warped * mask, merged = (feat_warp + x * (1 - mask)) *
    scale, in f32 rounded once.  Without scale (the last level) merged is
    None and x is not read.  Raises on anything else."""
    wn = _check_map(warped, NAME)
    b, h, w, c = wn.shape
    dtype, device = warped.dtype, warped.device
    if out.dtype != dtype or out.device != device \
            or tuple(out.shape) != (b, 3, h, w):
        raise ValueError(f"out must be a {dtype} ({b}, 3, {h}, {w}) tensor "
                         f"on {device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    xn = None
    if scale is not None:
        xn = None if x is None else _nhwc("x", x, device)
        if xn is None or x.dtype != dtype or tuple(xn.shape) != (b, h, w, c):
            raise ValueError(
                f"the merge takes x, a {dtype} ({b}, {c}, {h}, {w}) map, "
                f"got {None if x is None else (x.dtype, tuple(x.shape))}")
        _per_frame("scale", scale, b, c, dtype, device)
    z = out[:, 2]
    feat = torch.empty((b, h, w, c), dtype=dtype, device=device)
    merged = None if scale is None else torch.empty_like(feat)
    name = NAME_LAST if scale is None else NAME
    if feat.numel():
        lib = _lib()
        stream = torch.cuda.current_stream(device).cuda_stream
        # the launcher makes the maps' device current; the guard gives the
        # caller back its own current device afterwards
        with torch.cuda.device(device):
            err = lib.flow_merge_launch(
                wn.data_ptr(), z.data_ptr(), *z.stride(),
                None if xn is None else xn.data_ptr(),
                None if scale is None else scale.data_ptr(), feat.data_ptr(),
                None if merged is None else merged.data_ptr(), b, h, w, c,
                DTYPE_CODE[dtype], device.index, stream)
        if err:
            msg = lib.flow_merge_error_string(err).decode()
            raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                               f"({msg})")
        LAUNCHES[name] += 1
        LAUNCH_SHAPES[(name, b, h, w, c)] += 1
    return (feat.permute(0, 3, 1, 2),
            None if merged is None else merged.permute(0, 3, 1, 2))
