"""Flow Matching Transformer (FMT) — DiT-style adaLN-zero transformer
(twin of ``float_tpu.models.fmt``; inference path, no condition dropout).

Param tree (``fmt.*`` keys): x_embedder.proj, t_embedder.mlp.{0,2},
c_embedder, blocks.{i}.{attn.qkv, attn.proj, mlp.fc1, mlp.fc2,
adaLN_modulation.1}, decoder.{adaLN_modulation.1, linear}.  The position
table and the alignment mask are functions of the config, built here.

Attention is matmul + softmax with the additive banded alignment bias.
The linears are products without their biases; the passes between them
(``ops.fmt_block``: LN + modulate, attention, bias + GELU, the gated
residuals) add each bias, by K9 on a card and by the plain ops, which are
the same ops a biased linear gave, anywhere else.  silu(c) is made once a
forward for every block and the head.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fmt_block import BlockOps, block_ops
from ..parallel.sharding import row_parallel


@functools.lru_cache(maxsize=None)
def sinusoid_pos_embed(n_position: int, d_hid: int, device=None):
    """Sinusoidal position table (reference FMT.py:22-40), float32 on
    ``device``, made once per shape and device and shared: callers must
    not write to it.  A table kept on the device is what lets a CUDA
    graph capture the forward (a host copy cannot be captured)."""
    pos = np.arange(n_position)[:, None]
    idx = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (idx // 2) / d_hid)
    table = angle.copy()
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return _shared(table, device)


@functools.lru_cache(maxsize=None)
def alignment_bias(t: int, s: int, expansion: int, device=None):
    """Additive attention bias: 0 inside the +-expansion band, -1e9 outside
    (reference FMT.py:15-19; -1e9 rather than -inf keeps rows finite),
    float32 on ``device``, made once per shape and device and shared as
    ``sinusoid_pos_embed`` is."""
    blocked = np.ones((t, s), dtype=bool)
    for i in range(t):
        blocked[i, max(0, i - expansion): i + expansion + 1] = False
    return _shared(np.where(blocked, -1e9, 0.0), device)


def _shared(table: np.ndarray, device) -> torch.Tensor:
    """``table`` as float32 on ``device``, made outside inference mode so
    that every mode can read the shared tensor."""
    with torch.inference_mode(False):
        return torch.from_numpy(table.astype(np.float32)).to(device)


def _linear(p, x):
    return F.linear(x, p["weight"].to(x.dtype)) + p["bias"].to(x.dtype)


def _product(p, x):
    """``p``'s linear without its bias, which the pass reading the product
    adds (``ops.fmt_block``)."""
    return F.linear(x, p["weight"].to(x.dtype))


def _bias(p, x):
    return p["bias"].to(x.dtype)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """GLIDE-style sinusoidal embedding, cos first (reference FMT.py:107-126)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _t_embedder(p, t):
    h = F.silu(_linear(p["mlp"]["0"], timestep_embedding(t, 256)))
    return _linear(p["mlp"]["2"], h)


def _attention(p, xm, bias, num_heads: int, ops: BlockOps):
    """(proj's output, its bias or None where the output holds it) of the
    attention on the modulated input xm."""
    shards = getattr(p, "tp_shards", None)
    if shards:                 # one head group a model rank (parallel/)
        heads = num_heads // len(shards)
        return row_parallel(shards, xm, lambda s, xs: F.linear(
            ops.attn(_product(s["qkv"], xs), _bias(s["qkv"], xs),
                     bias.to(xs.device), heads),
            s["proj"]["weight"].to(xs.dtype)), p["proj"]["bias"]), None
    att = ops.attn(_product(p["qkv"], xm), _bias(p["qkv"], xm), bias,
                   num_heads)
    return _product(p["proj"], att), _bias(p["proj"], xm)


def _mlp(p, xm, ops: BlockOps):
    """(fc2's output, its bias or None where the output holds it) of the
    MLP on the modulated input xm."""
    shards = getattr(p, "tp_shards", None)
    if shards:                 # a slice of the hidden width a model rank
        return row_parallel(shards, xm, lambda s, xs: F.linear(
            ops.bias_gelu(_product(s["fc1"], xs), _bias(s["fc1"], xs)),
            s["fc2"]["weight"].to(xs.dtype)), p["fc2"]["bias"]), None
    h = ops.bias_gelu(_product(p["fc1"], xm), _bias(p["fc1"], xm))
    return _product(p["fc2"], h), _bias(p["fc2"], xm)


def _adaln(p, sc, parts: int) -> list:
    """An adaLN linear on silu(c) cut in ``parts`` slices of the hidden
    width: [(slice i of the bias-free product, slice i of the bias)]."""
    return list(zip(_product(p, sc).chunk(parts, dim=-1),
                    _bias(p, sc).chunk(parts)))


def _blocks(params, h, sc, bias, *, depth: int, num_heads: int,
            ops: BlockOps):
    """The FMT's blocks and its decoder head on h (B, N, D), sc = silu(c):
    the velocity.  Each block's linears are products without their biases
    and ``ops`` the passes between them: LN + modulate of the block's
    input, the attention, the gated residual with the next LN + modulate
    (the MLP's input), the GELU, then the gated residual with the next
    block's LN + modulate (or the head's).  So the adaLN product of block
    i + 1 is made before block i's last pass."""
    blocks = [params["blocks"][str(i)] for i in range(depth)]
    head = params["decoder"]
    mod = _adaln(blocks[0]["adaLN_modulation"]["1"], sc, 6)
    xm = ops.ln_mod(h, *mod[0], *mod[1])
    for i, p in enumerate(blocks):
        y = _attention(p["attn"], xm, bias, num_heads, ops)
        h, xm = ops.gate_res_ln_mod(h, *y, *mod[2], *mod[3], *mod[4])
        nxt = (_adaln(blocks[i + 1]["adaLN_modulation"]["1"], sc, 6)
               if i + 1 < depth
               else _adaln(head["adaLN_modulation"]["1"], sc, 2))
        y = _mlp(p["mlp"], xm, ops)
        h, xm = ops.gate_res_ln_mod(h, *y, *mod[5], *nxt[0], *nxt[1])
        mod = nxt
    return _linear(head["linear"], xm)


def fmt_forward(params, t, x, wa, wr, we, prev_x, prev_wa, prev_we, *,
                depth: int, num_heads: int, attention_window: int):
    """Inference forward; returns the (B, L'+L, dim_w) velocity.

    t (B,)|(1,) flow time, x (B, L, dim_w), wa (B, L, dim_a), wr (B, dim_w),
    we (B, 1, E) static or (B, L, E) dynamic, prev_x (B, L', dim_w),
    prev_wa (B, L', dim_a), prev_we (B, L', E) when we is dynamic
    (reference FMT.py:277-340)."""
    dynamic = we.shape[1] > 1
    x = torch.cat([prev_x, x], dim=1)
    wa = torch.cat([prev_wa, wa], dim=1)
    total = x.shape[1]
    if dynamic:
        if prev_we is None:
            raise ValueError("dynamic we requires prev_we")
        we = torch.cat([prev_we, we], dim=1)
    else:
        we = we.expand(we.shape[0], total, we.shape[2])

    t_emb = _t_embedder(params["t_embedder"], t)[:, None, :]
    h = _linear(params["x_embedder"]["proj"], x)
    h = h + sinusoid_pos_embed(total, h.shape[-1], h.device).to(h.dtype)[None]

    wr_b = wr[:, None, :].expand(wr.shape[0], total, wr.shape[-1])
    c = _linear(params["c_embedder"],
                torch.cat([wr_b, wa, we.to(wa.dtype)], dim=-1))
    c = t_emb.to(c.dtype) + c

    bias = alignment_bias(total, total, attention_window, h.device)
    hd = params["blocks"]["0"]["attn"]["qkv"]["weight"].shape[0] // (
        3 * num_heads)
    return _blocks(params, h, F.silu(c), bias, depth=depth,
                   num_heads=num_heads, ops=block_ops(h, hd))


def infer_cfg_mode(a_cfg_scale, r_cfg_scale, e_cfg_scale,
                   include_r_cfg: bool) -> str:
    """'skip' when every scale is exactly 1.0 (reference FMT.py:346), else
    '3way' / '4way'."""
    if a_cfg_scale == 1.0 and r_cfg_scale == 1.0 and e_cfg_scale == 1.0:
        return "skip"
    return "4way" if include_r_cfg else "3way"


def fmt_forward_cfg(params, t, x, wa, wr, we, prev_x, prev_wa, prev_we, *,
                    a_cfg_scale=1.0, r_cfg_scale=1.0, e_cfg_scale=1.0,
                    include_r_cfg: bool = False, cfg_mode: str | None = None,
                    depth: int, num_heads: int, attention_window: int):
    """Classifier-free vector field (reference FMT.py:342-401): the CFG
    variants ride the batch, 3-way [uncond(wr) | all_cond | audio_only]
    combined as uncond + a (audio_only - uncond) + e (all - audio_only);
    4-way prepends truly_uncond with r_cfg.  The scales are numbers, or
    0-dim tensors (a CUDA graph's inputs) given with ``cfg_mode``."""
    kw = dict(depth=depth, num_heads=num_heads,
              attention_window=attention_window)
    if cfg_mode is None:
        cfg_mode = infer_cfg_mode(a_cfg_scale, r_cfg_scale, e_cfg_scale,
                                  include_r_cfg)
    if cfg_mode == "skip":
        return fmt_forward(params, t, x, wa, wr, we, prev_x, prev_wa,
                           prev_we, **kw)

    zero = torch.zeros_like
    four = cfg_mode == "4way"
    if four:
        wa_c = torch.cat([zero(wa), zero(wa), wa, wa])
        wr_c = torch.cat([zero(wr), wr, wr, wr])
        we_c = torch.cat([zero(we), zero(we), we, zero(we)])
        pwe_c = None if prev_we is None else torch.cat(
            [zero(prev_we), zero(prev_we), prev_we, zero(prev_we)])
    else:
        wa_c = torch.cat([zero(wa), wa, wa])
        wr_c = torch.cat([wr, wr, wr])
        we_c = torch.cat([zero(we), we, zero(we)])
        pwe_c = None if prev_we is None else torch.cat(
            [zero(prev_we), prev_we, zero(prev_we)])
    n_way = 4 if four else 3
    out = fmt_forward(params, t, torch.cat([x] * n_way), wa_c, wr_c, we_c,
                      torch.cat([prev_x] * n_way),
                      torch.cat([prev_wa] * n_way), pwe_c, **kw)
    if four:
        truly_uncond, uncond, all_cond, audio_only = out.chunk(4)
        return (truly_uncond + _times(r_cfg_scale, uncond - truly_uncond)
                + _times(a_cfg_scale, audio_only - uncond)
                + _times(e_cfg_scale, all_cond - audio_only))
    uncond, all_cond, audio_only = out.chunk(3)
    return (uncond + _times(a_cfg_scale, audio_only - uncond)
            + _times(e_cfg_scale, all_cond - audio_only))


def _times(scale, d):
    """``scale * d`` rounded as for a Python-number scale, which the
    kernel takes in d's math dtype (float32 for a 16-bit d): a tensor
    scale (a CUDA graph's input, float64) is cast to that dtype, and the
    product of a 16-bit d is taken in it too."""
    if isinstance(scale, torch.Tensor):
        math = torch.promote_types(d.dtype, torch.float32)
        return (scale.to(math) * d.to(math)).to(d.dtype)
    return scale * d
