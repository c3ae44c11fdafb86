"""Benchmark: end-to-end talking-portrait generation on one CUDA card (the
port's counterpart of the repository's ``bench.py``).

    python -m float_torch.bench [--reps 10] [--stream]
    python -m float_torch.cli bench [--reps 10] [--stream]

Prints ONE JSON line.  Config = BASELINE config 1: a 512² portrait and
10 s of 16 kHz audio -> 250 frames at 25 fps, wav2vec2-base audio
encoder, the SER emotion predictor, 10 Euler steps with 3-way CFG, bf16
decode in ``FLOAT_DECODE_BATCH`` (24) frame chunks, the sampler in
``FLOAT_SAMPLER_DTYPE`` (float32).  The weights are ``FLOAT_CKPT``
(default ``models/float/FLOAT.safetensors``) when that file exists, else
synthetic (the same shapes and FLOPs as the 617.5 M-parameter model).

Default: after a warm-up, ``--reps`` clips are generated one after the
other, each closed by ``torch.cuda.synchronize()``; ``value`` is the
clip's frames over the median clip seconds.  ``mfu`` is the clip's
matrix FLOPs (decode + sampler, as ``bench.py`` counts them,
``utils.flops``) over the median seconds and the H100's dense bf16 peak.

``--stream``: ``generate_stream(first_chunk=FLOAT_STREAM_FIRST_CHUNK or
8)``; ``value`` is the median time to the first chunk on the host (TTFC),
beside the sustained frames/s of the u8 and 4:2:0 wires.

``vs_baseline`` is null: the port has no recorded baseline of its own
yet, and no number measured on or for a TPU is one.  Without a card the
line has ``value: null`` and an ``error``, and the exit code is 1:
nothing is measured on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .config import FloatConfig
from .utils.flops import (H100_BF16_PEAK_FLOPS, sampling_flops_per_clip,
                          synthesis_flops_per_frame)

N_SAMPLES = 160000                 # 10 s at 16 kHz
METRIC = ("e2e_frames_per_sec_512px", "frames/s/card")
STREAM_METRIC = ("stream_first_chunk_latency_512px", "s")


def config1() -> FloatConfig:
    """BASELINE config 1 as the bench runs it (environment overrides)."""
    return FloatConfig(
        compute_dtype="bfloat16",
        decode_batch=int(os.environ.get("FLOAT_DECODE_BATCH", "24")),
        sampler_dtype=os.environ.get("FLOAT_SAMPLER_DTYPE", "float32"))


def clip_flops(cfg: FloatConfig, t_frames: int) -> dict:
    """A clip's FLOPs as ``bench.py`` counts them: the decode's matrix
    work per frame times the frames plus the CFG-ODE sampler's; the
    elementwise decode work beside it, outside the MFU ratio."""
    syn = synthesis_flops_per_frame(cfg.input_size)
    return {"matmul": syn["matmul_flops"] * t_frames
            + sampling_flops_per_clip(t_frames, cfg),
            "decode_matmul_per_frame": syn["matmul_flops"],
            "decode_other_per_frame": syn["other_flops"]}


def device_info() -> dict:
    """The card's name and count, and its power limit as nvidia-smi
    reports it (null where nvidia-smi cannot be run)."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = None
    return {"device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "power_limit": None if smi is None else smi.split(",")[-1].strip()}


def throughput_line(seconds: list, cfg: FloatConfig, t_frames: int,
                    info: dict) -> dict:
    """The bench's JSON line from the clip seconds of a run."""
    med = statistics.median(seconds)
    flops = clip_flops(cfg, t_frames)
    return {
        "metric": METRIC[0], "value": t_frames / med, "unit": METRIC[1],
        "vs_baseline": None,
        "mfu": flops["matmul"] / med / H100_BF16_PEAK_FLOPS,
        "achieved_tflops": flops["matmul"] / med / 1e12,
        "gflop_per_frame_decode_matmul":
            flops["decode_matmul_per_frame"] / 1e9,
        "gflop_per_frame_decode_other": flops["decode_other_per_frame"] / 1e9,
        "clip_s_median": med, "clip_s_min": min(seconds),
        "clip_s_max": max(seconds), "reps": len(seconds),
        "frames": t_frames, "decode_batch": cfg.decode_batch,
        "sampler_dtype": cfg.sampler_dtype, **info}


def refusal(metric: tuple, error: str) -> dict:
    return {"metric": metric[0], "value": None, "unit": metric[1],
            "vs_baseline": None, "error": error}


def load_pipeline(cfg: FloatConfig):
    """(pipeline on the card, weights): ``FLOAT_CKPT`` when that file
    exists (its path), else the seed-0 synthetic weights."""
    from .runtime.pipeline import FloatPipeline, build_synthetic_pipeline
    ckpt = os.environ.get("FLOAT_CKPT", "models/float/FLOAT.safetensors")
    if os.path.exists(ckpt):
        from .io.checkpoint import load_unified_checkpoint
        return FloatPipeline(load_unified_checkpoint(ckpt), cfg), ckpt
    return build_synthetic_pipeline(cfg), "synthetic"


def _inputs(device):
    """bench.py's inputs: a seeded portrait and three seeded 10 s waves."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, 3, 512, 512)).astype(np.float32) * 0.3
    waves = [rng.standard_normal((1, N_SAMPLES)).astype(np.float32) * 0.1
             for _ in range(3)]
    return (torch.from_numpy(img).to(device),
            [torch.from_numpy(w).to(device) for w in waves])


def _synced() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def run_clips(pipe, reps: int) -> list:
    """Warm-up (one clip per wave, and one more), then ``reps`` clips,
    each timed to its synchronize."""
    img, waves = _inputs(pipe.device)
    for w in range(len(waves) + 1):
        pipe.generate(img, waves[w % len(waves)], emotion="none",
                      seed=15 + w % len(waves))
    seconds = []
    for i in range(reps):
        t0 = _synced()
        pipe.generate(img, waves[i % len(waves)], emotion="none",
                      seed=15 + i)
        seconds.append(_synced() - t0)
    return seconds


def run_stream(pipe, reps: int, first: int) -> dict:
    """TTFC and drain seconds of ``reps`` streams per wire, after two
    warm-up streams of each."""
    img, waves = _inputs(pipe.device)
    out = {}
    for wire in ("u8", "yuv420"):
        for _ in range(2):
            for _part in pipe.generate_stream(img, waves[0], seed=15,
                                              first_chunk=first, wire=wire):
                pass
        ttfc, total, frames = [], [], 0
        for _ in range(reps):
            t0 = _synced()
            frames = 0
            for _start, part in pipe.generate_stream(
                    img, waves[0], seed=15, first_chunk=first, wire=wire):
                if not frames:
                    ttfc.append(time.perf_counter() - t0)
                frames += part.shape[0]
            total.append(time.perf_counter() - t0)
        out[wire] = {"ttfc": ttfc, "total": total, "frames": frames}
    return out


def stream_line(runs: dict, first: int, info: dict) -> dict:
    u8, yuv = runs["u8"], runs["yuv420"]
    return {
        "metric": STREAM_METRIC[0],
        "value": statistics.median(u8["ttfc"]), "unit": STREAM_METRIC[1],
        "vs_baseline": None, "first_chunk_frames": first,
        "ttfc_s_min": min(u8["ttfc"]), "ttfc_s_max": max(u8["ttfc"]),
        "ttfc_yuv420_s_median": statistics.median(yuv["ttfc"]),
        "sustained_fps_u8": u8["frames"] / statistics.median(u8["total"]),
        "sustained_fps_yuv420":
            yuv["frames"] / statistics.median(yuv["total"]),
        "frames": u8["frames"], "reps": len(u8["ttfc"]), **info}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="float_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10,
                    help="timed clips (streams with --stream)")
    ap.add_argument("--stream", action="store_true",
                    help="time to the first chunk and sustained frames/s "
                         "of generate_stream")
    args = ap.parse_args(argv)
    metric = STREAM_METRIC if args.stream else METRIC
    if not torch.cuda.is_available():
        print(json.dumps(refusal(metric, "no CUDA device: the bench "
                                         "measures on the card only")))
        return 1
    cfg = config1()
    pipe, weights = load_pipeline(cfg)
    info = dict(device_info(), weights=weights)
    if args.stream:
        first = int(os.environ.get("FLOAT_STREAM_FIRST_CHUNK", "8"))
        line = stream_line(run_stream(pipe, args.reps, first), first, info)
    else:
        from .runtime.pipeline import audio_num_frames
        line = throughput_line(run_clips(pipe, args.reps), cfg,
                               audio_num_frames(N_SAMPLES, cfg), info)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
