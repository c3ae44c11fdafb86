#!/usr/bin/env python3
"""Drive the PyTorch port (``float_torch``) once on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc`` (the kernels are built from
``float_torch/kernels/csrc`` at first use) and imports nothing of JAX.
Phases, each of which raises on failure (exit code 1):

1. device: a CUDA card must be present;
2. build the hand-written kernels;
3. each kernel against its plain PyTorch version on the card, at the
   decode's shapes, with flows inside and far beyond +-7 px and grids
   that leave the image; both event-timed;
4. the port on the card against the port on the CPU at a tiny config in
   float32 (TF32 off), stage by stage;
5. BASELINE config 1 end to end: 617.5 M synthetic parameters, a 512²
   portrait and 10 s of 16 kHz audio -> 250 frames, emotion predicted by
   the SER, 3-way CFG, 10 Euler steps, bf16 decode in 24-frame chunks;
   the kernel launch count of the timed run is checked;
6. the first decode chunk through the kernel and through the plain warp.

Output: one line per measurement, then a JSON line with every kernel's
numbers, the card's name and power limit as nvidia-smi reports them, and
last the line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Tiny configs of the CPU parity tests (tests/test_pipeline.py's TINY).
TINY_AUDIO = dict(
    conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4)
# The seven synthesis levels of a 512² decode: (size, channels).
LEVELS = ((8, 512), (16, 512), (32, 512), (64, 256), (128, 128), (256, 64),
          (512, 32))
CHECK_LEVELS = ((128, 128), (256, 64), (512, 32), (8, 512))
WARP_KERNEL = {
    "name": "warp_shared",
    "route": "cuda",
    "source": "float_torch/kernels/csrc/warp_shared.cu",
    "replaces": "float_tpu/ops/pallas/shift_warp_v2.py:60",
}
# Tolerances.  bf16 kernel vs plain: four f32 products summed in another
# order, then one bf16 rounding -> 2^-7 of the map's magnitude.  f32: the
# kernel rounds in the plain version's order; allow a few ulp.
BF16_TOL = 2.0 ** -7
F32_TOL = 1e-6
# Card vs CPU at the tiny f32 config: cuBLAS / cuDNN sum in other orders
# (about 1e-7 relative each), carried through 9 Euler steps and 3 CFG
# branches; 1e-3 absolute leaves two orders of magnitude of margin.
TINY_TOL = 1e-3
# bf16 decode, kernel vs plain warp, on [0, 1] frames.
DECODE_TOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def sync_time() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def event_ms(fn, *args, iters: int) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` launches, after a
    warm-up call."""
    fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_grid(kind: str, b: int, size: int, gen: torch.Generator):
    """Sampling grid (b, size, size, 2): pixel-centre identity plus a smooth
    random flow of a few px ("smooth"), of +-20 px ("far"), or a zoom-out
    whose taps leave the image ("out")."""
    amp_px, zoom = {"smooth": (3.0, 1.0), "far": (20.0, 1.0),
                    "out": (5.0, 1.3)}[kind]
    coarse = max(2, size // 32)
    low = torch.randn((b, 2, coarse, coarse), generator=gen, device="cuda")
    low = low / low.abs().amax() * amp_px
    flow = torch.nn.functional.interpolate(low, size=(size, size),
                                           mode="bilinear",
                                           align_corners=False)
    ax = torch.linspace(-1 + 1 / size, 1 - 1 / size, size, device="cuda")
    gy, gx = torch.meshgrid(ax, ax, indexing="ij")
    ident = torch.stack([gx, gy], dim=-1) * zoom
    return (ident + flow.permute(0, 2, 3, 1) * (2.0 / size)).contiguous()


def phase_kernels(gen: torch.Generator) -> dict:
    from float_torch.ops.warp import warp_shared, warp_shared_ref

    max_err = 0.0
    for size, c in CHECK_LEVELS:
        for dtype, batches, kinds in (
                (torch.bfloat16, (24, 12, 1), ("smooth", "far", "out")),
                (torch.float32, (12,), ("far",))):
            feat = torch.randn((1, size, size, c), generator=gen,
                               device="cuda").to(dtype)
            scale = feat.float().abs().max().item()
            tol = (BF16_TOL if dtype == torch.bfloat16 else F32_TOL) * scale
            for b in batches:
                for kind in kinds:
                    grid = make_grid(kind, b, size, gen)
                    out = warp_shared(feat, grid)
                    ref = warp_shared_ref(feat, grid)
                    err = (out.float() - ref.float()).abs().max().item()
                    max_err = max(max_err, err)
                    check(out.shape == ref.shape and err <= tol,
                          f"warp_shared {size}²xC{c} B={b} {dtype} {kind}: "
                          f"max|diff| {err} > {tol}")
            log(f"[kernel] warp_shared {size}^2 C={c} {dtype}: agrees with "
                f"the plain version (tol {tol:.3g})")
    ms = plain_ms = 0.0
    for size, c in LEVELS:
        feat = torch.randn((1, size, size, c), generator=gen,
                           device="cuda").to(torch.bfloat16)
        grid = make_grid("smooth", 24, size, gen)
        k = event_ms(warp_shared, feat, grid, iters=50)
        p = event_ms(warp_shared_ref, feat, grid, iters=5)
        ms += k
        plain_ms += p
        log(f"[kernel] warp_shared {size}^2 C={c} B=24 bf16: kernel {k:.4f} ms"
            f", plain {p:.4f} ms")
    log(f"[kernel] one 24-frame chunk's 7 warps: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def stage_chain(pipe, img, wave, noise) -> dict:
    from float_torch.runtime.pipeline import audio_num_frames
    s_r, lam, feats, r_s = pipe.encode_image(img)
    wa = pipe.encode_audio(wave, audio_num_frames(wave.shape[-1], pipe.cfg))
    we = pipe.emotion_latent(wave, "none")
    r_d = pipe.sample(r_s, wa, we, noise=noise)
    frames = pipe.decode(s_r, feats, r_d)
    return {"s_r": s_r, "r_s_lambda": lam, "r_s": r_s, "wa": wa, "we": we,
            "r_d": r_d, "frames": frames}


def phase_tiny() -> None:
    from float_torch.config import FloatConfig, Wav2Vec2Config
    from float_torch.runtime.pipeline import (audio_num_frames,
                                              build_synthetic_pipeline)
    w2v = Wav2Vec2Config(**TINY_AUDIO, feat_extract_norm="group",
                         conv_bias=False, do_stable_layer_norm=False)
    ser = Wav2Vec2Config(**TINY_AUDIO, feat_extract_norm="layer",
                         conv_bias=True, do_stable_layer_norm=True,
                         num_labels=7)
    cfg = FloatConfig(input_size=64, dim_w=64, dim_a=64, dim_h=64, dim_m=20,
                      dim_e=7, fmt_depth=2, num_heads=4, wav2vec_sec=0.4,
                      num_prev_frames=3, decode_batch=4,
                      compute_dtype="float32")
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, 3, 64, 64)).astype(np.float32) * 0.3
    wave = rng.standard_normal((1, 16000)).astype(np.float32) * 0.1
    t = audio_num_frames(wave.shape[-1], cfg)
    clip = cfg.num_frames_for_clip
    noise = rng.standard_normal(
        (math.ceil(t / clip), 1, clip, cfg.dim_w)).astype(np.float32)
    outs = {dev: stage_chain(build_synthetic_pipeline(cfg, w2v, ser,
                                                      device=dev),
                             img, wave, noise)
            for dev in ("cpu", "cuda")}
    for name, ref in outs["cpu"].items():
        got = outs["cuda"][name].float().cpu()
        err = (got - ref.float()).abs().max().item()
        log(f"[tiny] {name}: card vs cpu max|diff| {err:.3e}")
        check(got.shape == ref.shape and err <= TINY_TOL,
              f"tiny stage {name}: card vs cpu {err} > {TINY_TOL}")


def phase_config1() -> dict:
    from float_torch.config import FloatConfig
    from float_torch.kernels import LAUNCHES
    from float_torch.runtime.pipeline import (audio_num_frames,
                                              build_synthetic_pipeline)

    cfg = FloatConfig(compute_dtype="bfloat16", decode_batch=24)
    t0 = time.perf_counter()
    pipe = build_synthetic_pipeline(cfg, device="cuda")
    n_params = sum(p.numel() for p in pipe.params.parameters())
    log(f"[config1] {n_params / 1e6:.1f} M parameters, built in "
        f"{sync_time() - t0:.1f} s")
    # bench.py's inputs
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, 3, 512, 512)).astype(np.float32) * 0.3
    wave = rng.standard_normal((1, 160000)).astype(np.float32) * 0.1
    t_frames = audio_num_frames(wave.shape[-1], cfg)
    img_d = torch.from_numpy(img).cuda()
    wave_d = torch.from_numpy(wave).cuda()

    t0 = sync_time()
    pipe.generate(img_d, wave_d, emotion="none", seed=15)
    log(f"[config1] warm-up generate {sync_time() - t0:.3f} s")

    # per-stage split, each stage synchronised
    t0 = sync_time()
    s_r, _lam, feats, r_s = pipe.encode_image(img_d)
    t1 = sync_time()
    wa = pipe.encode_audio(wave_d, t_frames)
    t2 = sync_time()
    we = pipe.emotion_latent(wave_d, "none")
    t3 = sync_time()
    r_d = pipe.sample(r_s, wa, we, seed=15)
    t4 = sync_time()
    staged = pipe.decode(s_r, feats, r_d)
    t5 = sync_time()
    stages = {"encode_image": t1 - t0, "encode_audio": t2 - t1,
              "emotion": t3 - t2, "sample": t4 - t3, "decode": t5 - t4}
    for k, v in stages.items():
        log(f"[config1] stage {k}: {v * 1e3:.1f} ms")

    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = sync_time()
    frames = pipe.generate(img_d, wave_d, emotion="none", seed=15)
    latency = sync_time() - t0
    launches = dict(LAUNCHES)
    log(f"[config1] clip latency {latency:.4f} s for {t_frames} frames: "
        f"{t_frames / latency:.2f} frames/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
        f"launches {launches}")

    check(tuple(frames.shape) == (t_frames, 512, 512, 3),
          f"frames shape {tuple(frames.shape)}")
    check(bool(torch.isfinite(frames).all()), "non-finite frames")
    lo, hi = frames.min().item(), frames.max().item()
    check(0.0 <= lo and hi <= 1.0, f"frames outside [0, 1]: {lo}..{hi}")
    n_chunks = math.ceil(t_frames / cfg.decode_batch)
    want = len(LEVELS) * n_chunks
    check(launches.get(WARP_KERNEL["name"], 0) == want,
          f"warp_shared launched {launches} times in the timed run, "
          f"expected {want}")
    rerun = (frames - staged).abs().max().item()
    log(f"[config1] timed run vs stage-by-stage run: max|diff| {rerun:.3e}")
    check(rerun <= DECODE_TOL, f"generate vs stage chain differ by {rerun}")

    # 6. first decode chunk, kernel warp vs plain warp, both on the card
    from float_torch.ops.warp import warp_shared, warp_shared_ref
    from float_torch.runtime.decode import decode_chunk
    wa_c = (s_r.float() + r_d[0, :cfg.decode_batch]).to(pipe.compute_dtype)
    feats_c = [f.to(pipe.compute_dtype) for f in feats]
    with torch.inference_mode():
        a = decode_chunk(pipe.syn_cast, wa_c, feats_c, 512, warp=warp_shared)
        b = decode_chunk(pipe.syn_cast, wa_c, feats_c, 512,
                         warp=warp_shared_ref)
    diff = (a - b).abs()
    log(f"[decode] first chunk, kernel vs plain warp: max|diff| "
        f"{diff.max().item():.3e}, mean|diff| {diff.mean().item():.3e}")
    check(diff.max().item() <= DECODE_TOL,
          f"decode chunk kernel vs plain {diff.max().item()} > {DECODE_TOL}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import float_torch  # noqa: F401  (fails outside a checkout)
    from float_torch.kernels import build

    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = build.build("warp_shared")
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    warp = phase_kernels(gen)
    phase_tiny()
    launches = phase_config1()
    check("jax" not in sys.modules, "jax was imported")

    kernels = [dict(WARP_KERNEL, launches=launches.get(WARP_KERNEL["name"], 0),
                    **warp)]
    log(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
