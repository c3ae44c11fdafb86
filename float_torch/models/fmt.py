"""Flow Matching Transformer (FMT) — DiT-style adaLN-zero transformer
(twin of ``float_tpu.models.fmt``; inference path, no condition dropout).

Param tree (``fmt.*`` keys): x_embedder.proj, t_embedder.mlp.{0,2},
c_embedder, blocks.{i}.{attn.qkv, attn.proj, mlp.fc1, mlp.fc2,
adaLN_modulation.1}, decoder.{adaLN_modulation.1, linear}.  The position
table and the alignment mask are functions of the config, built here.

Attention is matmul + softmax with the additive banded alignment bias.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.sharding import row_parallel


@functools.lru_cache(maxsize=None)
def _sinusoid_table_np(n_position: int, d_hid: int) -> np.ndarray:
    """Sinusoidal position table (reference FMT.py:22-40)."""
    pos = np.arange(n_position)[:, None]
    idx = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (idx // 2) / d_hid)
    table = angle.copy()
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def sinusoid_pos_embed(n_position: int, d_hid: int, device=None):
    return torch.from_numpy(_sinusoid_table_np(n_position, d_hid)).to(device)


@functools.lru_cache(maxsize=None)
def _alignment_bias_np(t: int, s: int, expansion: int) -> np.ndarray:
    blocked = np.ones((t, s), dtype=bool)
    for i in range(t):
        blocked[i, max(0, i - expansion): i + expansion + 1] = False
    return np.where(blocked, -1e9, 0.0).astype(np.float32)


def alignment_bias(t: int, s: int, expansion: int, device=None):
    """Additive attention bias: 0 inside the +-expansion band, -1e9 outside
    (reference FMT.py:15-19; -1e9 rather than -inf keeps rows finite)."""
    return torch.from_numpy(_alignment_bias_np(t, s, expansion)).to(device)


def _linear(p, x):
    return F.linear(x, p["weight"].to(x.dtype)) + p["bias"].to(x.dtype)


def _layer_norm(x, eps=1e-6):
    """Non-affine LayerNorm (elementwise_affine=False)."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


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


def _modulate(x, shift, scale):
    return x * (1 + scale) + shift


def _heads(p_qkv, x, bias, heads: int):
    """Attention of the ``heads`` heads whose q, k and v rows ``p_qkv``
    holds -> (B, N, heads * hd), the input of ``proj``."""
    b, n, _ = x.shape
    hd = p_qkv["weight"].shape[0] // (3 * heads)
    qkv = _linear(p_qkv, x).reshape(b, n, 3, heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, N, hd)
    logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(hd) + bias
    att = torch.softmax(logits, dim=-1).to(x.dtype)
    return (att @ v).transpose(1, 2).reshape(b, n, heads * hd)


def _attention(p, x, bias, num_heads: int):
    shards = getattr(p, "tp_shards", None)
    if shards:                 # one head group a model rank (parallel/)
        heads = num_heads // len(shards)
        return row_parallel(shards, x, lambda s, xs: F.linear(
            _heads(s["qkv"], xs, bias.to(xs.device), heads),
            s["proj"]["weight"].to(xs.dtype)), p["proj"]["bias"])
    return _linear(p["proj"], _heads(p["qkv"], x, bias, num_heads))


def _mlp(p, x):
    shards = getattr(p, "tp_shards", None)
    if shards:                 # a slice of the hidden width a model rank
        return row_parallel(shards, x, lambda s, xs: F.linear(
            F.gelu(_linear(s["fc1"], xs), approximate="tanh"),
            s["fc2"]["weight"].to(xs.dtype)), p["fc2"]["bias"])
    return _linear(p["fc2"], F.gelu(_linear(p["fc1"], x), approximate="tanh"))


def _fmt_block(p, x, c, bias, num_heads: int):
    mod = _linear(p["adaLN_modulation"]["1"], F.silu(c))
    (shift_msa, scale_msa, gate_msa,
     shift_mlp, scale_mlp, gate_mlp) = mod.chunk(6, dim=-1)
    x = x + gate_msa * _attention(
        p["attn"], _modulate(_layer_norm(x), shift_msa, scale_msa), bias,
        num_heads)
    return x + gate_mlp * _mlp(
        p["mlp"], _modulate(_layer_norm(x), shift_mlp, scale_mlp))


def _decoder_head(p, x, c):
    shift, scale = _linear(p["adaLN_modulation"]["1"], F.silu(c)).chunk(2, -1)
    return _linear(p["linear"], _modulate(_layer_norm(x), shift, scale))


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
    for i in range(depth):
        h = _fmt_block(params["blocks"][str(i)], h, c, bias, num_heads)
    return _decoder_head(params["decoder"], h, c)


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
    4-way prepends truly_uncond with r_cfg."""
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
        return (truly_uncond + r_cfg_scale * (uncond - truly_uncond)
                + a_cfg_scale * (audio_only - uncond)
                + e_cfg_scale * (all_cond - audio_only))
    uncond, all_cond, audio_only = out.chunk(3)
    return (uncond + a_cfg_scale * (audio_only - uncond)
            + e_cfg_scale * (all_cond - audio_only))
