"""ctypes wrappers of K9 (``csrc/fmt_block.cu``): an FMT block's non-GEMM
passes in f32 arithmetic on f32, bf16 or f16 tensors, each reading a
bias-free linear's output and adding its bias.  Their plain PyTorch
versions are in ``float_torch.ops.fmt_block``.

Launches count under the mode's name: ``fmt_ln_mod``,
``fmt_gate_res_ln_mod``, ``fmt_attn``, ``fmt_bias_gelu``; in
``LAUNCH_SHAPES`` as (name, B, N, 1, C), a (B, N, C) tensor seen as a map
of height N and width 1, C its rows' width (proj's input for the
attention)."""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import LAUNCH_SHAPES, LAUNCHES
from .build import load

LIB = "fmt_block"
LN_MOD = "fmt_ln_mod"
GATE_RES_LN_MOD = "fmt_gate_res_ln_mod"
ATTN = "fmt_attn"
BIAS_GELU = "fmt_bias_gelu"
NAMES = (LN_MOD, GATE_RES_LN_MOD, ATTN, BIAS_GELU)
# the launchers' dtype codes (csrc/fmt_block.cu ``Dtype``)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the ln modes' rows: 4 values for each of a block's 256 threads
MAX_WIDTH = 4 * 256


def inv_sqrt(hd: int) -> float:
    """1 / sqrt(hd) as PyTorch's CUDA division by a Python number forms
    it: the f32 reciprocal of the number rounded to f32, which then
    multiplies."""
    return float(np.float32(1.0) / np.float32(math.sqrt(hd)))


def _lib() -> ctypes.CDLL:
    # every pointer and the stream as c_void_p: undeclared, ctypes would
    # pass a Python int as a 32-bit int and cut the pointer
    lib = load(LIB)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    lib.fmt_ln_mod_launch.argtypes = (
        [ptr] * 4 + [i64, ptr, ptr, i64, ptr, ptr, i64, ptr, ptr, ptr]
        + [i32, i32, f32, i32, i32, ptr])   # rows, D, eps, dtype, device
    lib.fmt_attn_launch.argtypes = (
        [ptr] * 4 + [i32] * 4 + [f32, i32, i32, ptr])  # B, N, H, hd, 1/sqrt
    lib.fmt_bias_gelu_launch.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32,
                                         ptr]
    for fn in (lib.fmt_ln_mod_launch, lib.fmt_attn_launch,
               lib.fmt_bias_gelu_launch):
        fn.restype = ctypes.c_int
    lib.fmt_block_error_string.argtypes = [ctypes.c_int]
    lib.fmt_block_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> bool:
    """``t`` starts on a 4-value boundary (a 16-byte vector in f32)."""
    return t.data_ptr() % (4 * t.element_size()) == 0


def _rows(name: str, t: torch.Tensor, shape: tuple, device,
          dtype=torch.float32) -> int:
    """The row stride of ``t``, a (B, N, C) ``dtype`` tensor on ``device``
    whose rows hold C contiguous values at one stride of a multiple of 4
    values, aligned to 4 values (a slice of a wider product's last dim is
    one); raises on anything else."""
    if t.dtype != dtype or t.device != device or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be a {dtype} {shape} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    b, n, _c = shape
    ld = t.stride(1) if n > 1 else t.stride(0)
    if t.stride(2) != 1 or (n > 1 and b > 1 and t.stride(0) != n * ld) \
            or ld % 4 or not _aligned(t):
        raise ValueError(f"{name} must hold rows of contiguous values at "
                         f"one stride of a multiple of 4 values, aligned "
                         f"to 4 values, got strides {t.stride()}")
    return ld


def _vector(name: str, v: torch.Tensor, c: int, device,
            dtype=torch.float32) -> torch.Tensor:
    """Raise unless ``v`` is a contiguous (c,) ``dtype`` vector on
    ``device``, aligned to 4 values."""
    if v.dtype != dtype or tuple(v.shape) != (c,) \
            or not v.is_contiguous() or v.device != device \
            or not _aligned(v):
        raise ValueError(f"{name} must be a contiguous aligned ({c},) "
                         f"{dtype} vector on {device}, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")
    return v


def _input(name: str, x: torch.Tensor) -> tuple:
    """(B, N, C) of ``x``, a contiguous (B, N, C) f32, bf16 or f16 tensor
    on a card, aligned to 4 values; raises on anything else."""
    if not x.is_cuda or x.dtype not in DTYPES:
        raise TypeError(f"{name} takes float32, bfloat16 or float16 CUDA "
                        f"tensors, got {x.dtype} on {x.device}")
    if x.ndim != 3 or not x.is_contiguous() or not _aligned(x):
        raise ValueError(f"{name} takes a contiguous (B, N, C) tensor "
                         f"aligned to 4 values, got shape {tuple(x.shape)}, "
                         f"strides {x.stride()}")
    return tuple(x.shape)


def _launch(name: str, entry: str, args: tuple, like: torch.Tensor,
            width: int, what: str = "") -> None:
    """Call ``entry`` with ``args`` then the dtype code, the device and
    the stream of ``like``, raise on an error (``what`` added to the
    message), count the launch."""
    lib = _lib()
    device = like.device
    stream = torch.cuda.current_stream(device).cuda_stream
    # the launcher makes the tensors' device current; the guard gives the
    # caller back its own current device afterwards
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, DTYPES[like.dtype], device.index,
                                  stream)
    if err:
        msg = lib.fmt_block_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({msg}){what}")
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, like.shape[0], like.shape[1], 1, width)] += 1


def _ln(name: str, x, y, y_bias, gate, gate_bias, shift, shift_bias,
        scale, scale_bias, eps: float):
    shape = _input(name, x)
    d, dev, dt = shape[2], x.device, x.dtype
    if d % 4 or d > MAX_WIDTH:
        raise ValueError(f"{name} takes rows of a multiple of 4 up to "
                         f"{MAX_WIDTH} values, got {d}")
    lds = [_rows(k, t, shape, dev, dt) for k, t in (("shift", shift),
                                                   ("scale", scale))]
    vec = [_vector(k, v, d, dev, dt).data_ptr() for k, v in (
        ("shift_bias", shift_bias), ("scale_bias", scale_bias))]
    xm = torch.empty_like(x)
    xo, res = None, (None, None, None, 0, None)
    if y is not None:
        _rows("y", y, shape, dev, dt)
        if not y.is_contiguous():
            raise ValueError("y must be contiguous")
        xo = torch.empty_like(x)
        res = (y.data_ptr(),
               None if y_bias is None
               else _vector("y_bias", y_bias, d, dev, dt).data_ptr(),
               gate.data_ptr(), _rows("gate", gate, shape, dev, dt),
               _vector("gate_bias", gate_bias, d, dev, dt).data_ptr())
    if x.numel():
        _launch(name, "fmt_ln_mod_launch",
                (x.data_ptr(), *res, shift.data_ptr(), lds[0], vec[0],
                 scale.data_ptr(), lds[1], vec[1],
                 None if xo is None else xo.data_ptr(), xm.data_ptr(),
                 shape[0] * shape[1], d, eps), x, d)
    return xm if xo is None else (xo, xm)


def ln_mod_cuda(x: torch.Tensor, shift: torch.Tensor,
                shift_bias: torch.Tensor, scale: torch.Tensor,
                scale_bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """K9 ``ln_mod``: x (B, N, D) contiguous f32, bf16 or f16 on a card,
    shift and scale (B, N, D) slices of an adaLN product (rows of D
    contiguous values at one stride) with their (D,) biases, all of x's
    dtype -> LN(x) * (1 + scale + scale_bias) + shift + shift_bias, LN
    non-affine with ``eps``, computed in f32 and rounded to x's dtype
    once.  Raises on anything else."""
    return _ln(LN_MOD, x, None, None, None, None, shift, shift_bias, scale,
               scale_bias, eps)


def gate_res_ln_mod_cuda(x: torch.Tensor, y: torch.Tensor,
                         y_bias: torch.Tensor | None, gate: torch.Tensor,
                         gate_bias: torch.Tensor, shift: torch.Tensor,
                         shift_bias: torch.Tensor, scale: torch.Tensor,
                         scale_bias: torch.Tensor,
                         eps: float = 1e-6) -> tuple:
    """K9 ``gate_res_ln_mod``: as ``ln_mod_cuda`` on x' = x + (gate +
    gate_bias) * (y + y_bias), y (B, N, D) contiguous a linear's output
    and y_bias its bias (None: y holds it) -> (x', the modulated LN of
    x').  Raises on anything else."""
    return _ln(GATE_RES_LN_MOD, x, y, y_bias, gate, gate_bias, shift,
               shift_bias, scale, scale_bias, eps)


def attn_cuda(qkv: torch.Tensor, qkv_bias: torch.Tensor, bias: torch.Tensor,
              heads: int) -> torch.Tensor:
    """K9 ``attn``: qkv (B, N, 3 * heads * hd) contiguous f32, bf16 or f16
    on a card, a qkv linear's output without its bias qkv_bias (3 * heads
    * hd,) of its dtype, bias (N, N) the additive attention bias in f32 ->
    (B, N, heads * hd) in qkv's dtype: softmax(q k^T / sqrt(hd) + bias) v
    for each head in f32, q, k, v with their biases.  Raises on anything
    else, and where a head's N keys and values do not fit a block's shared
    memory on the card (the launcher's ``attn_smem_bytes``)."""
    b, n, w = _input(ATTN, qkv)
    dev = qkv.device
    if heads <= 0 or w % (3 * heads) or (w // (3 * heads)) % 4:
        raise ValueError(f"{ATTN}: qkv's {w} values a row are not 3 x "
                         f"{heads} heads of a multiple of 4")
    hd = w // (3 * heads)
    _vector("qkv_bias", qkv_bias, w, dev, qkv.dtype)
    if bias.dtype != torch.float32 or tuple(bias.shape) != (n, n) \
            or not bias.is_contiguous() or bias.device != dev:
        raise ValueError(f"bias must be a contiguous float32 ({n}, {n}) "
                         f"tensor on {dev}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    out = torch.empty((b, n, heads * hd), dtype=qkv.dtype, device=dev)
    if out.numel():
        _launch(ATTN, "fmt_attn_launch",
                (qkv.data_ptr(), qkv_bias.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), b, n, heads, hd, inv_sqrt(hd)),
                qkv, heads * hd,
                f"; a block stages the {n} keys and values of a head of "
                f"{hd} in shared memory")
    return out


def bias_gelu_cuda(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K9 ``bias_gelu``: y (B, N, F) contiguous f32, bf16 or f16 on a card,
    a linear's output without its bias b (F,) of its dtype ->
    gelu_tanh(y + b), computed in f32 and rounded to y's dtype once.
    Raises on anything else."""
    shape = _input(BIAS_GELU, y)
    _vector("b", b, shape[2], y.device, y.dtype)
    out = torch.empty_like(y)
    if y.numel():
        _launch(BIAS_GELU, "fmt_bias_gelu_launch",
                (y.data_ptr(), b.data_ptr(), out.data_ptr(), y.numel(),
                 shape[2]), y, shape[2])
    return out
