"""Frame-batched decode (twin of ``float_tpu.runtime.decode``'s
``decode_latents`` and ``_chunk_core``): a plain loop over frame chunks.

The TPU decode's D/path ratchets, optimistic and fixup programs, steady
probe and pessimist switch exist only for the TPU kernels' static tap
window; the CUDA warp kernel gathers its taps for any displacement and is
exact, so none of them has a counterpart here.
"""
from __future__ import annotations

import math

import torch

from ..models.synthesis import synthesis
from ..ops import warp_shared


def chunk_sizes(t_frames: int, fb: int) -> list:
    """Per-chunk frame counts: full ``fb`` chunks, the last one shrunk to
    the smallest multiple of 4 covering the remainder (250 frames at
    fb=24 decode as 10x24 + 1x12)."""
    n_chunks = math.ceil(t_frames / fb)
    sizes = [fb] * n_chunks
    if n_chunks:
        rem = t_frames - (n_chunks - 1) * fb
        sizes[-1] = min(fb, max(4, math.ceil(rem / 4) * 4))
    return sizes


def decode_chunk(synthesis_params, wa_chunk, feats, size: int,
                 warp=warp_shared, blur_kernel=(1, 3, 3, 1)):
    """(fb, dim_w) latents -> (fb, S, S, 3) f32 frames in [0, 1]."""
    img, _ = synthesis(synthesis_params, wa_chunk, feats, size, warp=warp,
                       blur_kernel=blur_kernel)
    img = (img.float().clamp(-1.0, 1.0) + 1.0) * 0.5
    return img.permute(0, 2, 3, 1)


def decode_latents(synthesis_params, s_r, feats, r_d, *, size: int,
                   decode_batch: int = 8, compute_dtype=torch.float32,
                   warp=warp_shared, blur_kernel=(1, 3, 3, 1)):
    """Decode T frames: s_r (1, dim_w), feats (7 maps, each (1, C, H, W)),
    r_d (T, dim_w) -> (T, size, size, 3) f32 in [0, 1].

    wa = s_r + r_d in f32, cast to ``compute_dtype``; the last chunk pads
    by repeating the last latent and its extra frames are dropped."""
    t_frames = r_d.shape[0]
    sizes = chunk_sizes(t_frames, decode_batch)
    wa = (s_r.float() + r_d.float()).to(compute_dtype)
    t_pad = sum(sizes)
    if t_pad > t_frames:
        wa = torch.cat([wa, wa[-1:].expand(t_pad - t_frames, -1)])
    feats_c = [f.to(compute_dtype).contiguous(memory_format=torch.channels_last)
               for f in feats]
    frames = torch.empty((t_frames, size, size, 3), dtype=torch.float32,
                         device=wa.device)
    lo = 0
    for sz in sizes:
        chunk = decode_chunk(synthesis_params, wa[lo:lo + sz], feats_c, size,
                             warp=warp, blur_kernel=blur_kernel)
        n = min(sz, t_frames - lo)
        frames[lo:lo + n] = chunk[:n]
        lo += sz
    return frames
