"""The benchmark's own arithmetic: the H100's peaks, the matrix FLOPs of a
clip and the bytes bound of a warp launch, counted from shapes.

Frozen copies, so that a later change to the program cannot move the
yardstick: the FLOP counts of ``float_torch/utils/flops.py``
(``synthesis_flops_per_level``, ``fmt_flops_per_forward``,
``sampling_flops_per_clip``: matrix work only, 2 FLOPs a multiply-add)
and the warp bound of ``chip_smoke.py`` (``bound``, ``warp_bound``:
the map and grid read once, the output written once, 8·C f32 operations
an output pixel).

Peaks: one NVIDIA H100 SXM at its 700 W limit, NVIDIA's data sheet,
dense rates: 989.4 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3,
67 TFLOP/s f32 on the CUDA cores.
"""
from __future__ import annotations

import math

BF16_PEAK_FLOPS = 989.4e12
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64,
            512: 32, 1024: 16}


def _conv(h, w, cin, cout, k):
    return 2.0 * h * w * cin * cout * k * k


def decode_matmul_flops_per_frame(size: int) -> float:
    """One frame of the synthesis decode: conv1 at 4², then per level the
    up and plain 3x3 styled convs, the 1x1 ToFlow and the 1x1 ToRGB."""
    c4 = CHANNELS[4]
    total = _conv(4, 4, c4, c4, 3)
    inc = c4
    for lvl in range(int(math.log2(size)) - 2):
        res = 2 ** (lvl + 3)
        outc = CHANNELS[res]
        total += (_conv(res, res, inc, outc, 3)
                  + _conv(res, res, outc, outc, 3)
                  + 2 * _conv(res, res, outc, 3, 1))
        inc = outc
    return total


def fmt_flops_per_forward(f: dict, cfg_batch: int = 3) -> float:
    """One CFG-batched FMT forward over num_prev_frames + the chunk."""
    n = f["num_prev_frames"] + int(f["wav2vec_sec"] * f["fps"])
    d = f["dim_h"]
    per_token = (2.0 * d * 3 * d + 2.0 * d * d + 2.0 * d * 4 * d * 2
                 + 2.0 * d * 6 * d)
    per_block = n * per_token + 2.0 * 2.0 * n * n * d
    dim_c = f["dim_w"] + f["dim_a"] + f["dim_e"]
    embed = n * (2.0 * f["dim_w"] * d + 2.0 * dim_c * d + 2.0 * d * f["dim_w"]
                 + 2.0 * d * 2 * d)
    embed += 2.0 * 256 * d + 2.0 * d * d
    return cfg_batch * (f["fmt_depth"] * per_block + embed)


def sampler_flops(t_frames: int, f: dict) -> float:
    """ceil(T / chunk) chunks x (nfe - 1) Euler steps x one forward."""
    chunks = math.ceil(t_frames / int(f["wav2vec_sec"] * f["fps"]))
    return chunks * (f["nfe"] - 1) * fmt_flops_per_forward(f)


def clip_matmul_flops(t_frames: int, f: dict) -> float:
    """A clip's matrix FLOPs: its frames' decode and its sampler."""
    return (decode_matmul_flops_per_frame(f["input_size"]) * t_frames
            + sampler_flops(t_frames, f))


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds: bytes over HBM or f32 operations over the CUDA
    cores, whichever is longer."""
    return max(n_bytes / HBM_BPS, n_ops / F32_FLOPS)


def warp_shared_bound_s(b: int, h: int, w: int, c: int, esize: int) -> float:
    """One K1 launch: a (1, H, W, C) map and a (B, H, W, 2) f32 grid read
    once, (B, H, W, C) written once; 8·C operations an output pixel."""
    n_bytes = h * w * c * esize + b * h * w * 2 * 4 + b * h * w * c * esize
    return bound_s(n_bytes, b * h * w * 8 * c)
