"""Time-axis interpolation (twin of ``float_tpu.ops.interp``)."""
from __future__ import annotations

import torch


def linear_interpolate_time(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Linearly resample (B, T, D) along T to ``out_len``,
    align_corners=True: output j reads input position j*(T-1)/(out_len-1)."""
    b, t, d = x.shape
    if out_len == t:
        return x
    if t == 1:
        return x.expand(b, out_len, d)
    if out_len > 1:
        pos = torch.arange(out_len, dtype=torch.float32, device=x.device) \
            * ((t - 1) / (out_len - 1))
    else:
        pos = torch.zeros(1, dtype=torch.float32, device=x.device)
    i0 = torch.floor(pos).long().clamp(0, t - 2)
    frac = (pos - i0.float()).to(x.dtype)[None, :, None]
    return x[:, i0, :] * (1 - frac) + x[:, i0 + 1, :] * frac


def nearest_interpolate_time(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Nearest-neighbour resample (B, T, D) along T to ``out_len``, as
    torch's 'nearest' mode: output j reads input floor(j * T / out_len)."""
    b, t, d = x.shape
    if out_len == t:
        return x
    idx = torch.floor(torch.arange(out_len, dtype=torch.float32,
                                   device=x.device) * (t / out_len)).long()
    return x[:, idx.clamp(0, t - 1), :]
