"""Analytic FLOP accounting — MFU bookkeeping (twin of
``float_tpu.utils.flops``, the same counts).

Counts the multiply-accumulate work (2 FLOPs per MAC) of the hot stages
from the architecture alone, so achieved TFLOP/s and MFU can be derived
from a measured throughput without a profiler trace.

Conventions:
- Matrix work (convs / linears / attention matmuls) is counted exactly
  from the layer shapes (``matmul_flops``); this is the numerator MFU
  conventionally uses, the work the tensor cores can take.
- Elementwise work (warp tap FMAs, blur taps, activations, modulation
  scaling) is reported SEPARATELY (``other_flops``): it runs on the CUDA
  cores, not the tensor cores, so folding it into a tensor-core-peak ratio
  would overstate utilization.

Peak: one NVIDIA H100 SXM, dense BF16 on the tensor cores, 989.4 TFLOP/s
(NVIDIA H100 data sheet, without sparsity, at the 700 W power limit).

Reference architecture being accounted: the Synthesis decoder
(reference src/nodes/models/float/styledecoder.py:447-534) and the FMT
(reference src/nodes/models/float/FMT.py:201-340).
"""
from __future__ import annotations

import math
from typing import Dict

from ..config import CHANNELS_MAP, FloatConfig

H100_BF16_PEAK_FLOPS = 989.4e12


def _n_gather_levels(size: int) -> int:
    """Levels (>= 128²) whose warp is accounted at 25 taps a pixel: the
    tap count ``float_tpu.utils.flops`` gives its kernel levels, kept so
    both packages report the same numbers."""
    return max(0, int(math.log2(size)) - 6)


def synthesis_flops_per_level(size: int = 512, dim_w: int = 512,
                              channels_map: Dict[int, int] = None) -> list:
    """Per-LEVEL (res², matmul FLOPs, other FLOPs) of one Synthesis
    decode.  Level 4 is conv1; 8..size are the pyramid levels."""
    cm = channels_map or CHANNELS_MAP

    def conv(h, w, cin, cout, k):
        return 2.0 * h * w * cin * cout * k * k

    out = []
    c4 = cm[4]
    # conv1: 3x3 at 4² (+ modulation + demod + lrelu)
    out.append((4, conv(4, 4, c4, c4, 3), 3 * 4 * 4 * c4 * 2.0))

    n_levels = int(math.log2(size)) - 2   # 8² .. size²
    inc = c4
    for lvl in range(n_levels):
        res = 2 ** (lvl + 3)
        outc = cm[res]
        h = w = res
        mm = other = 0.0
        # up StyledConv: transposed 3x3 producing res² from (res/2)²
        # = res²·inc·outc·9 MACs (stride-2 transposed conv touches each
        # output once per tap), + 4-tap² separable blur (upfirdn)
        mm += conv(h, w, inc, outc, 3)
        other += 2.0 * h * w * outc * (4 + 4)      # separable 4-tap x/y
        # second StyledConv 3x3
        mm += conv(h, w, outc, outc, 3)
        # modulation scaling + demod + fused lrelu on both convs
        other += 2 * (3.0 * h * w * outc * 2)
        # ToFlow: ModulatedConv2d 1x1 out->3 (+ tanh/sigmoid + grid add)
        mm += conv(h, w, outc, 3, 1)
        other += 6.0 * h * w * 2
        # warp: bilinear taps on the feature map, 25 taps a pixel at the
        # levels >= 128², 4 elsewhere (the reference accounting's mix)
        taps = 25 if lvl >= n_levels - _n_gather_levels(size) else 4
        other += 2.0 * h * w * outc * taps
        # mask merge: feat_warp*mask + input*(1-mask)
        other += 4.0 * h * w * outc
        # ToRGB 1x1 out->3 + skip upsample blur on 3ch
        mm += conv(h, w, outc, 3, 1)
        other += 2.0 * h * w * 3 * 8
        out.append((res, mm, other))
        inc = outc
    return out


def synthesis_flops_per_frame(size: int = 512, dim_w: int = 512,
                              channels_map: Dict[int, int] = None) -> dict:
    """Per-frame FLOPs of one Synthesis decode at ``size``².

    Structure (models/synthesis.py, mirroring reference
    styledecoder.py:447-534): ConstantInput 4² -> conv1 (3x3) -> per
    level [up StyledConv 3x3 (2x), StyledConv 3x3, ToFlow 1x1, warp,
    ToRGB 1x1 + skip upsample].
    """
    levels = synthesis_flops_per_level(size, dim_w, channels_map)
    mm = sum(m for _r, m, _o in levels)
    other = sum(o for _r, _m, o in levels)
    return {"matmul_flops": mm, "other_flops": other,
            "total_flops": mm + other}


def fmt_flops_per_forward(cfg: FloatConfig = FloatConfig(),
                          cfg_batch: int = 3) -> float:
    """One CFG-batched FMT forward (reference FMT.py:271-340):
    tokens n = num_prev_frames + num_frames_for_clip, width dim_h,
    ``cfg_batch``-way batch (3-way CFG default)."""
    n = cfg.num_prev_frames + cfg.num_frames_for_clip
    d = cfg.dim_h
    per_token_block = (
        2.0 * d * 3 * d        # qkv
        + 2.0 * d * d          # attn out proj
        + 2.0 * d * 4 * d * 2  # MLP fc1+fc2 (mlp_ratio 4)
        + 2.0 * d * 6 * d      # adaLN modulation (SiLU -> 6d)
    )
    attn = 2.0 * 2.0 * n * n * d     # QK^T + AV
    per_block = n * per_token_block + attn
    # embedders + head (x_embed, c_embed, t_embed MLP, decoder head)
    dim_c = cfg.dim_w + cfg.dim_a + cfg.dim_e
    embed = n * (2.0 * cfg.dim_w * d + 2.0 * dim_c * d + 2.0 * d * cfg.dim_w
                 + 2.0 * d * 2 * d)  # head adaLN
    embed += 2.0 * 256 * d + 2.0 * d * d   # t_embedder MLP (once per call)
    return cfg_batch * (cfg.fmt_depth * per_block + embed)


def sampling_flops_per_clip(t_frames: int, cfg: FloatConfig = FloatConfig(),
                            cfg_batch: int = 3) -> float:
    """Chunked CFG-ODE sampling cost: ceil(T/clip) chunks x (nfe-1)
    solver steps x stage evals (euler: 1 eval/step)."""
    from ..ops.ode import ODE_TABLEAUS
    n_chunks = math.ceil(t_frames / cfg.num_frames_for_clip)
    evals_per_step = len(ODE_TABLEAUS[cfg.ode_method][2])
    steps = (cfg.nfe - 1) * evals_per_step
    return n_chunks * steps * fmt_flops_per_forward(cfg, cfg_batch)


def decode_mfu(fps: float, size: int = 512,
               peak: float = H100_BF16_PEAK_FLOPS) -> dict:
    """Measured decode throughput (frames/s) -> achieved TFLOP/s and MFU
    against ``peak`` (matmul work only; the elementwise work is reported
    beside it, not in the ratio)."""
    f = synthesis_flops_per_frame(size)
    return {
        "gflop_per_frame_matmul": round(f["matmul_flops"] / 1e9, 2),
        "gflop_per_frame_other": round(f["other_flops"] / 1e9, 2),
        "achieved_tflops": round(f["matmul_flops"] * fps / 1e12, 2),
        "mfu": round(f["matmul_flops"] * fps / peak, 4),
    }
