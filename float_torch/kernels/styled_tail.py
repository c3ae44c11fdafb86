"""ctypes wrappers of K7 (``csrc/styled_tail.cu``): the decode's StyledConv
tails (``styled_tail_cuda``, up or plain, either ending in the next
convolutions' modulations) and skip upsamplings (``skip_tail_cuda``) on
channels_last maps.  Their plain PyTorch versions are
``float_torch.ops.tails.styled_tail_ref`` (with ``ops.modulated.modulate``)
and ``skip_tail_ref``.

Maps are NCHW tensors held in ``torch.channels_last`` memory, as the
synthesis holds them; each result is one too (an NHWC buffer seen through
``permute``)."""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCH_SHAPES, LAUNCHES
from .build import load

LIB = "styled_tail"
NAME = "styled_tail"       # the one name of K7's launches, every mode
DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_INT_MAX = 2 ** 31 - 1


def _lib() -> ctypes.CDLL:
    # every pointer and the stream as c_void_p: undeclared, ctypes would
    # pass a Python int as a 32-bit int and cut the pointer
    lib = load(LIB)
    ints = [ctypes.c_int] * 4                        # B, Ho, Wo, C
    tail = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # dtype, device, stream
    lib.styled_tail_launch.argtypes = ([ctypes.c_void_p] * 7 + ints
                                       + [ctypes.c_int] + tail)
    lib.skip_tail_launch.argtypes = [ctypes.c_void_p] * 5 + ints + tail
    for fn in (lib.styled_tail_launch, lib.skip_tail_launch):
        fn.restype = ctypes.c_int
    lib.styled_tail_error_string.argtypes = [ctypes.c_int]
    lib.styled_tail_error_string.restype = ctypes.c_char_p
    return lib


def _nhwc(name: str, t: torch.Tensor, device) -> torch.Tensor:
    """The NHWC view of a channels_last (B, C, H, W) map on ``device``;
    raises on anything else."""
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.ndim != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} must be a channels_last (B, C, H, W) map, "
                         f"got shape {tuple(t.shape)}, strides {t.stride()}")
    if max(t.shape) > _INT_MAX:
        raise ValueError("dimension too large")
    return t.permute(0, 2, 3, 1)


def _vector(name: str, v: torch.Tensor, n: int, dtype,
            device) -> torch.Tensor:
    """``v`` as a contiguous (n,) vector of ``dtype`` on ``device``."""
    if v.numel() != n or v.device != device:
        raise ValueError(f"{name} must hold {n} values on {device}, got "
                         f"{tuple(v.shape)} on {v.device}")
    return v.reshape(n).to(dtype).contiguous()


def _run(entry: str, ptrs: tuple, out: torch.Tensor,
         flags: tuple = ()) -> torch.Tensor:
    """Launch ``entry`` on checked inputs: ``ptrs`` (data pointers, None
    for none), then the NHWC ``out`` and its shape, then ``flags``; count the
    launch and return ``out`` as a channels_last NCHW view."""
    b, h, w, c = out.shape
    if out.numel():
        lib = _lib()
        stream = torch.cuda.current_stream(out.device).cuda_stream
        # the launcher makes out's device current; the guard gives the
        # caller back its own current device afterwards
        with torch.cuda.device(out.device):
            err = getattr(lib, entry)(*ptrs, out.data_ptr(), b, h, w, c,
                                      *flags, DTYPE_CODE[out.dtype],
                                      out.device.index, stream)
        if err:
            msg = lib.styled_tail_error_string(err).decode()
            raise RuntimeError(f"{NAME} launch failed: CUDA error {err} "
                               f"({msg})")
        LAUNCHES[NAME] += 1
        LAUNCH_SHAPES[(NAME, b, h, w, c)] += 1
    return out.permute(0, 3, 1, 2)


def _check_map(x: torch.Tensor, name: str = NAME) -> torch.Tensor:
    if not x.is_cuda or x.dtype not in DTYPE_CODE:
        raise TypeError(f"{name} takes a bf16/f32 CUDA map, got {x.dtype} "
                        f"on {x.device}")
    return _nhwc("x", x, x.device)


def _per_frame(name: str, v: torch.Tensor, b: int, c: int, dtype,
               device) -> torch.Tensor:
    """Raise unless ``v`` is a contiguous (b, c) tensor of ``dtype`` on
    ``device``."""
    if v.dtype != dtype or tuple(v.shape) != (b, c) \
            or not v.is_contiguous() or v.device != device:
        raise ValueError(f"{name} must be a contiguous ({b}, {c}) {dtype} "
                         f"tensor on {device}, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")
    return v


def styled_tail_cuda(x: torch.Tensor, demod: torch.Tensor,
                     bias: torch.Tensor, up: bool,
                     scale: torch.Tensor | None = None,
                     scale2: torch.Tensor | None = None):
    """K7's tails: x (B, C, Hi, Wi) channels_last bf16|f32 on a card,
    demod (B, C) f32, bias (C values) -> y (B, C, Ho, Wo) channels_last in
    x's dtype: lrelu(demod * fir(x) + bias) * sqrt(2), fir the up conv's
    pad-(1, 1) 4x4 blur with Ho, Wo = Hi - 1, Wi - 1 (``up``), else the
    identity; times ``scale`` (B, C) in x's dtype where given.  With
    ``scale2`` (B, C) instead (the plain tail only) -> (y, y times
    scale2).  Raises on anything else."""
    xn = _check_map(x)
    b, hi, wi, c = xn.shape
    _per_frame("demod", demod, b, c, torch.float32, x.device)
    scales = [None if v is None else
              _per_frame(name, v, b, c, x.dtype, x.device).data_ptr()
              for name, v in (("scale", scale), ("scale2", scale2))]
    if scale2 is not None and (up or scale is not None):
        raise ValueError("scale2 takes the plain tail and no scale")
    bias = _vector("bias", bias, c, x.dtype, x.device)
    ho, wo = (max(hi - 1, 0), max(wi - 1, 0)) if up else (hi, wi)
    out = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    out2 = None if scale2 is None else torch.empty_like(out)
    y = _run("styled_tail_launch",
             (xn.data_ptr(), demod.data_ptr(), bias.data_ptr(), *scales,
              None if out2 is None else out2.data_ptr()), out, (int(up),))
    return y if out2 is None else (y, out2.permute(0, 3, 1, 2))


def skip_tail_cuda(x: torch.Tensor, skip: torch.Tensor, bias: torch.Tensor,
                   act_bias: torch.Tensor | None = None) -> torch.Tensor:
    """K7's skip mode: x (B, C, H, W) and skip (B, C, H / 2, W / 2)
    channels_last bf16|f32 on one card, bias (and act_bias) C values ->
    (B, C, H, W) channels_last: act(x) + bias + the 2x upsampled skip,
    act(x) = lrelu(x + act_bias) * sqrt(2), or x without act_bias.
    Raises on anything else."""
    xn = _check_map(x)
    b, h, w, c = xn.shape
    if skip.dtype != x.dtype:
        raise TypeError(f"skip must be {x.dtype}, got {skip.dtype}")
    sn = _nhwc("skip", skip, x.device)
    if h % 2 or w % 2 or tuple(sn.shape) != (b, h // 2, w // 2, c):
        raise ValueError(f"skip must be ({b}, {c}, {h // 2}, {w // 2}) "
                         f"under an even x, got {tuple(skip.shape)} under "
                         f"{tuple(x.shape)}")
    bias = _vector("bias", bias, c, x.dtype, x.device)
    if act_bias is not None:
        act_bias = _vector("act_bias", act_bias, c, x.dtype, x.device)
    out = torch.empty((b, h, w, c), dtype=x.dtype, device=x.device)
    return _run("skip_tail_launch",
                (xn.data_ptr(), sn.data_ptr(),
                 None if act_bias is None else act_bias.data_ptr(),
                 bias.data_ptr()), out)
