"""Chunked autoregressive flow-matching sampling (twin of
``float_tpu.runtime.sampling``), as a Python loop over chunks:

    carry = (prev_x, prev_wa, prev_we)      # num_prev_frames of state
    per chunk:  x0 ~ N(0, I) (B, clip, dim_w)
                r_d_chunk = ODE(CFG vector field, x0, linspace(0, 1, nfe))
                carry <- last frames of (r_d_chunk, wa_chunk, we_chunk)

wa/we are edge-padded to whole chunks and the result is trimmed to T.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import FloatConfig
from ..models.fmt import fmt_forward_cfg
from ..ops import odeint_fixed


def pad_to_chunks(x, frames_per_clip: int, n_chunks: Optional[int] = None):
    """Right-pad (B, T, D) along T to whole chunks by edge replication
    (F.pad mode='replicate'); ``n_chunks`` pads to a larger count."""
    b, t, d = x.shape
    target = (n_chunks if n_chunks is not None
              else math.ceil(t / frames_per_clip)) * frames_per_clip
    if target == t:
        return x
    return torch.cat([x, x[:, -1:].expand(b, target - t, d)], dim=1)


def bucket_n_chunks(n: int) -> int:
    """Round a chunk count up to its bucket: 1..5 exact, then multiples of
    5.  Padded chunks trail the real ones, so bucketing is exact."""
    if n <= 5:
        return n
    return math.ceil(n / 5) * 5


def sampler_init_carry(b: int, cfg: FloatConfig, dtype=torch.float32,
                       device=None):
    """Zero autoregressive carry (prev_x, prev_wa, prev_we) for chunk 0."""
    prev = cfg.num_prev_frames
    return (torch.zeros(b, prev, cfg.dim_w, dtype=dtype, device=device),
            torch.zeros(b, prev, cfg.dim_w, dtype=dtype, device=device),
            torch.zeros(b, prev, cfg.dim_e, dtype=dtype, device=device))


def sample_motion_chunk(fmt_params, r_s, wa_t, we_t, carry, x0, *,
                        cfg: FloatConfig, a_cfg_scale, e_cfg_scale,
                        r_cfg_scale, nfe: int, ode_method: str,
                        cfg_mode: Optional[str]):
    """One autoregressive chunk of the CFG-ODE sampler.
    Returns (sample_t (B, clip, dim_w), new_carry)."""
    prev = cfg.num_prev_frames
    dynamic = we_t.shape[1] > 1
    prev_x, prev_wa, prev_we = carry

    def field(tt, zt):
        out = fmt_forward_cfg(
            fmt_params, tt.reshape(1), zt, wa_t, r_s, we_t, prev_x, prev_wa,
            prev_we if dynamic else None,
            a_cfg_scale=a_cfg_scale, e_cfg_scale=e_cfg_scale,
            r_cfg_scale=r_cfg_scale, include_r_cfg=cfg.include_r_cfg,
            cfg_mode=cfg_mode, depth=cfg.fmt_depth, num_heads=cfg.num_heads,
            attention_window=cfg.attention_window)
        return out[:, prev:]

    time_grid = torch.linspace(0.0, 1.0, nfe, device=x0.device)
    sample_t = odeint_fixed(field, x0, time_grid, method=ode_method)
    new_prev_we = we_t[:, -prev:] if dynamic else prev_we
    return sample_t, (sample_t[:, -prev:], wa_t[:, -prev:], new_prev_we)


def sample_motion_chunks(fmt_params, r_s, wa, we, *, cfg: FloatConfig,
                         a_cfg_scale=None, e_cfg_scale=None,
                         r_cfg_scale=None, nfe: Optional[int] = None,
                         ode_method: Optional[str] = None,
                         cfg_mode: Optional[str] = None,
                         generator: Optional[torch.Generator] = None,
                         noise=None):
    """Yield the motion latents of each sampler chunk in order, each
    (B, clip, dim_w); the last one runs past T = wa.shape[1] on edge-padded
    conditions.

    Chunk noise comes from ``generator`` (drawn in f32 on wa's device, one
    chunk after another just before that chunk is integrated, then cast to
    wa's dtype) or from ``noise`` (n_chunks, B, clip, dim_w), which lets a
    test feed the JAX sampler and this one the same numbers."""
    a_s = cfg.a_cfg_scale if a_cfg_scale is None else a_cfg_scale
    e_s = cfg.e_cfg_scale if e_cfg_scale is None else e_cfg_scale
    r_sc = cfg.r_cfg_scale if r_cfg_scale is None else r_cfg_scale
    nfe = cfg.nfe if nfe is None else nfe
    method = cfg.ode_method if ode_method is None else ode_method

    b, t_frames, dim_w = wa.shape
    clip = cfg.num_frames_for_clip
    n_chunks = math.ceil(t_frames / clip)
    dynamic = we.shape[1] > 1
    wa_p = pad_to_chunks(wa, clip)
    we_p = pad_to_chunks(we, clip) if dynamic else we
    if noise is None:
        if generator is None:
            raise ValueError("pass either generator= or noise=")
    else:
        noise = torch.as_tensor(noise).to(device=wa.device, dtype=wa.dtype)
        if tuple(noise.shape) != (n_chunks, b, clip, dim_w):
            raise ValueError(f"noise shape {tuple(noise.shape)} != "
                             f"{(n_chunks, b, clip, dim_w)}")

    carry = sampler_init_carry(b, cfg, wa.dtype, wa.device)
    for c in range(n_chunks):
        if noise is None:
            x0 = torch.randn((b, clip, dim_w), generator=generator,
                             dtype=torch.float32,
                             device=wa.device).to(wa.dtype)
        else:
            x0 = noise[c]
        sl = slice(c * clip, (c + 1) * clip)
        sample_t, carry = sample_motion_chunk(
            fmt_params, r_s, wa_p[:, sl], we_p[:, sl] if dynamic else we,
            carry, x0, cfg=cfg, a_cfg_scale=a_s, e_cfg_scale=e_s,
            r_cfg_scale=r_sc, nfe=nfe, ode_method=method, cfg_mode=cfg_mode)
        yield sample_t


def sample_motion_latents(fmt_params, r_s, wa, we, **kw):
    """Motion latents r_d (B, T, dim_w) for T = wa.shape[1] frames: the
    chunks of ``sample_motion_chunks`` (same keywords) joined and trimmed
    to T."""
    chunks = list(sample_motion_chunks(fmt_params, r_s, wa, we, **kw))
    return torch.cat(chunks, dim=1)[:, :wa.shape[1]]
