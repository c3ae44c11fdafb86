"""The non-GEMM passes of an FMT block, each reading a bias-free linear's
output and adding that linear's bias: the plain PyTorch versions (the op
sequence of ``float_tpu.models.fmt``, in any dtype) and K9's
(``kernels/csrc/fmt_block.cu``, f32, bf16 or f16 on a card), bundled as
``BlockOps``:

- ``ln_mod``           the modulated LayerNorm of a block's input;
- ``gate_res_ln_mod``  the gated residual of a linear's output, then the
                       modulated LayerNorm of the sum for the next layer;
- ``attn``             the banded multi-head attention of a qkv product;
- ``bias_gelu``        the MLP's tanh GELU of fc1's product.

Each adds a bias exactly where the plain ``linear(x) + b`` did, so the
plain versions run the same ops in the same order as the block did with
biased linears.  ``block_ops`` picks the plain versions for every tensor
off the card and K9 for every tensor on one: an FMT on a card that K9
does not take raises, so no card runs the plain passes unseen.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def _layer_norm(x, eps=LN_EPS):
    """Non-affine LayerNorm (elementwise_affine=False), summed in f32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def _modulate(x, shift, scale):
    return x * (1 + scale) + shift


def ln_mod_ref(x, shift, shift_bias, scale, scale_bias):
    """LN(x) * (1 + scale + scale_bias) + shift + shift_bias."""
    return _modulate(_layer_norm(x), shift + shift_bias, scale + scale_bias)


def gate_res_ln_mod_ref(x, y, y_bias, gate, gate_bias, shift, shift_bias,
                        scale, scale_bias):
    """(x', ``ln_mod_ref(x', ...)``), x' = x + (gate + gate_bias) * (y +
    y_bias); a y_bias of None: y holds its bias."""
    if y_bias is not None:
        y = y + y_bias
    x = x + (gate + gate_bias) * y
    return x, ln_mod_ref(x, shift, shift_bias, scale, scale_bias)


def attn_ref(qkv, qkv_bias, bias, heads: int):
    """Attention of ``heads`` heads from qkv (B, N, 3 * heads * hd) and
    its bias -> (B, N, heads * hd): softmax(q k^T / sqrt(hd) + bias) v,
    the logits and softmax in f32."""
    b, n, w = qkv.shape
    hd = w // (3 * heads)
    qkv = (qkv + qkv_bias).reshape(b, n, 3, heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, N, hd)
    logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(hd) + bias
    att = torch.softmax(logits, dim=-1).to(qkv.dtype)
    return (att @ v).transpose(1, 2).reshape(b, n, heads * hd)


def bias_gelu_ref(y, b):
    return F.gelu(y + b, approximate="tanh")


class BlockOps(NamedTuple):
    """One implementation of each of a block's non-GEMM passes."""
    ln_mod: Callable
    gate_res_ln_mod: Callable
    attn: Callable
    bias_gelu: Callable


PLAIN = BlockOps(ln_mod_ref, gate_res_ln_mod_ref, attn_ref, bias_gelu_ref)


def _k9() -> BlockOps:
    from ..kernels import fmt_block as k9
    return BlockOps(k9.ln_mod_cuda, k9.gate_res_ln_mod_cuda, k9.attn_cuda,
                    k9.bias_gelu_cuda)


def k9_takes(x: torch.Tensor, hd: int) -> bool:
    """K9 computes every pass of the blocks on x (B, N, D) with heads of
    ``hd``: x contiguous f32, bf16 or f16 on a card, D a multiple of 4
    within the ln modes' rows, hd a multiple of 4.  (The attention's
    launcher holds a head's N keys and values to the card's shared memory
    a block, and raises past it.)"""
    from ..kernels import fmt_block as k9
    d = x.shape[-1]
    return (x.is_cuda and x.dtype in k9.DTYPES and x.ndim == 3
            and x.is_contiguous() and d % 4 == 0 and d <= k9.MAX_WIDTH
            and hd % 4 == 0)


def block_ops(x: torch.Tensor, hd: int) -> BlockOps:
    """``PLAIN`` for a tensor off the card; K9 on a card, which raises
    where K9 does not take the blocks (``k9_takes``)."""
    if not x.is_cuda:
        return PLAIN
    if not k9_takes(x, hd):
        raise ValueError(
            f"K9 takes an FMT's blocks on a card as a contiguous (B, N, D) "
            f"float32, bfloat16 or float16 tensor with D and the head "
            f"width multiples of 4 and D <= 1024, got {x.dtype} "
            f"{tuple(x.shape)} with heads of {hd}")
    return _k9()
