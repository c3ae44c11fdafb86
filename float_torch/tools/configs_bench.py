"""The five BASELINE configs at full size on one CUDA card, one
subprocess per config with its own timeout, one markdown table out (twin
of tools/configs_bench.py):

    python -m float_torch.tools.configs_bench [--only N] [--reps 3]
        [--out TABLE.md]

Configs (BASELINE.md; the parameters in ``CONFIGS``):
  1. default: 512² + 10 s audio, SER emotion, 10 Euler steps, 25 fps
     (``python -m float_torch.bench``'s line);
  2. emotion-conditioned: named emotion, a_cfg 2.0 / e_cfg 3.5;
  3. long audio 60 s (1500 frames), sampler_dtype float32 vs bfloat16;
  4. dynamic per-frame emotion (SER over 2 s windows, nearest upsample);
  5. two-face reinsert compositing: fixed detector boxes -> aligned crops
     -> generate both faces -> composite back frame by frame on the host.

Each config runs on the bench's pipeline (``FLOAT_CKPT`` when that file
exists, else synthetic weights; ``FLOAT_DECODE_BATCH``, default 24).
Timing: warm-up runs on the timed seeds, then each run is closed by
``torch.cuda.synchronize()``; configs 1, 2 and 4 report the median of
``--reps`` runs, configs 3 and 5 one run after one warm-up (as
tools/configs_bench.py).  Configs 1-4 stay on the device; config 5's
output is host frames by nature.  Each config prints one JSON line, then
the table; a config that fails or outlives ``TIMEOUT_S`` gets a row with
its error, and the exit code is 1.  Without a card nothing is measured.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SAMPLING_RATE = 16000
# x1, y1, x2, y2, score on a 768 x 1024 scene (tools/configs_bench.py)
BOXES = [(150.0, 200.0, 350.0, 420.0, 0.99),
         (620.0, 180.0, 840.0, 430.0, 0.98)]
CONFIGS = {
    1: {"desc": "default 10 s / 512²", "seconds": 10},
    2: {"desc": "emotion CFG (a 2.0 / e 3.5, named)", "seconds": 10,
        "emotion": "happy", "a_cfg_scale": 2.0, "e_cfg_scale": 3.5},
    3: {"desc": "long audio 60 s (1500 frames)", "seconds": 60,
        "sampler_dtypes": ("float32", "bfloat16")},
    4: {"desc": "dynamic per-frame emotion (2 s windows)", "seconds": 10,
        "window_s": 2.0},
    5: {"desc": "two-face reinsert compositing (streamed)", "seconds": 10,
        "scene": (768, 1024), "boxes": BOXES},
}
TIMEOUT_S = 900


def _synced() -> float:
    import torch
    torch.cuda.synchronize()
    return time.perf_counter()


def _runs(fn, reps: int, warm: int) -> list:
    """``warm`` untimed calls fn(0..warm-1), then the seconds of ``reps``
    calls fn(0..reps-1), each closed by a synchronize."""
    for i in range(warm):
        fn(i)
    secs = []
    for i in range(reps):
        t0 = _synced()
        fn(i)
        secs.append(_synced() - t0)
    return secs


def _row(n: int, frames: int, secs: list, note: str) -> dict:
    med = statistics.median(secs)
    return {"config": n, "desc": CONFIGS[n]["desc"], "frames": frames,
            "seconds": med, "fps": frames / med, "runs": len(secs),
            "seconds_min": min(secs), "seconds_max": max(secs),
            "note": note}


def config2(pipe, img, wave, reps: int) -> dict:
    p = CONFIGS[2]
    kw = {k: p[k] for k in ("emotion", "a_cfg_scale", "e_cfg_scale")}
    frames = []
    secs = _runs(lambda i: frames.append(
        pipe.generate(img, wave, seed=15 + i, **kw).shape[0]), reps, reps)
    return _row(2, frames[-1], secs, "on the device")


def config3(pipe, img, wave, reps: int) -> dict:
    from ..runtime.pipeline import FloatPipeline
    secs, frames = {}, 0
    for sdt in CONFIGS[3]["sampler_dtypes"]:
        p = pipe if sdt == pipe.cfg.sampler_dtype else FloatPipeline(
            pipe.params, pipe.cfg.replace(sampler_dtype=sdt))

        def run(i, p=p):
            nonlocal frames
            frames = p.generate(img, wave, seed=15 + i).shape[0]

        secs[sdt] = _runs(run, 1, 1)
    bf16 = secs["bfloat16"][0]
    return _row(3, frames, secs["float32"],
                f"on the device; sampler_dtype bf16 A/B: "
                f"{frames / bf16:.1f} fps ({bf16:.3f} s)")


def config4(pipe, img, wave, reps: int) -> dict:
    import torch
    from ..ops import nearest_interpolate_time
    from ..runtime.pipeline import audio_num_frames
    cfg = pipe.cfg
    t = audio_num_frames(wave.shape[-1], cfg)
    win = int(CONFIGS[4]["window_s"] * cfg.sampling_rate)
    frames = []

    def run(i):
        with torch.inference_mode():
            s_r, _lam, feats, r_s = pipe.encode_image(img)
            wa = pipe.encode_audio(wave, t)
            seq = torch.stack([pipe.predict_emotion(wave[:, lo:lo + win])
                               for lo in range(0, wave.shape[-1], win)], 1)
            we = nearest_interpolate_time(seq, t)         # (1, T, E)
            r_d = pipe.sample(r_s, wa, we, seed=15 + i)
            frames.append(pipe.decode(s_r, feats, r_d).shape[0])

    secs = _runs(run, reps, reps)
    n_win = math.ceil(wave.shape[-1] / win)
    return _row(4, frames[-1], secs,
                f"on the device, {n_win} windowed SER forwards")


def config5(pipe, img, wave, reps: int) -> dict:
    import torch
    from ..image.composite import composite_faces_stream
    from ..image.face_align import face_align_crop
    from ..runtime.pipeline import audio_num_frames
    p = CONFIGS[5]
    t = audio_num_frames(wave.shape[-1], pipe.cfg)
    h, w = p["scene"]
    rng = np.random.default_rng(0)
    scene = (rng.random((h, w, 3)) * 255).astype(np.uint8)

    def det(im):
        k = im.shape[0] / h
        return [(x1 * k, y1 * k, x2 * k, y2 * k, s)
                for x1, y1, x2, y2, s in p["boxes"]]

    frames = []

    def run(i):
        faces = []
        for idx in (1, 2):
            crop, bbox = face_align_crop(scene, pipe.cfg.input_size,
                                         index=idx, detector=det)
            model_in = torch.from_numpy(
                (crop.astype(np.float32) / 127.5 - 1.0)
                .transpose(2, 0, 1)[None].copy()).to(pipe.device)
            s_r, _lam, feats, r_s = pipe.encode_image(model_in)
            wa = pipe.encode_audio(wave, t)
            we = pipe.emotion_latent(wave, "none")
            r_d = pipe.sample(r_s, wa, we, seed=15 + i + idx)
            faces.append((pipe.decode_to_host(s_r, feats, r_d), bbox))
        n = 0
        for fr in composite_faces_stream(scene, faces):
            if fr.shape != (h, w, 3) or fr.dtype != np.uint8:
                raise RuntimeError(f"composited frame {fr.shape} {fr.dtype}")
            n += 1
        if n != t:
            raise RuntimeError(f"{n} composited frames, expected {t}")
        frames.append(n * len(faces))

    secs = _runs(run, 1, 1)
    return _row(5, frames[-1], secs,
                "wall incl. 2 clips' uint8 host wire and the per-frame "
                "compositor")


RUNNERS = {2: config2, 3: config3, 4: config4, 5: config5}


def run_one(n: int, reps: int) -> dict:
    """Config n (2-5) in this process on the bench's pipeline."""
    import torch
    from ..bench import config1, load_pipeline
    pipe, weights = load_pipeline(config1())
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((1, 3, 512, 512))
                           .astype(np.float32) * 0.3).to(pipe.device)
    n_samples = CONFIGS[n]["seconds"] * SAMPLING_RATE
    wave = torch.from_numpy(rng.standard_normal((1, n_samples))
                            .astype(np.float32) * 0.1).to(pipe.device)
    row = RUNNERS[n](pipe, img, wave, reps)
    row["weights"] = weights
    return row


def _command(n: int, reps: int) -> list:
    if n == 1:
        return [sys.executable, "-m", "float_torch.bench", "--reps",
                str(reps)]
    return [sys.executable, "-m", "float_torch.tools.configs_bench",
            "--run", str(n), "--reps", str(reps)]


def parse(n: int, returncode: int, out: str, err: str) -> dict:
    """A config's row from its subprocess's output."""
    if returncode == 0 and n == 1:
        j = json.loads(out.strip().splitlines()[-1])
        return {"config": 1, "desc": CONFIGS[1]["desc"],
                "frames": j["frames"], "seconds": j["clip_s_median"],
                "fps": j["value"], "runs": j["reps"],
                "seconds_min": j["clip_s_min"],
                "seconds_max": j["clip_s_max"],
                "note": f"float_torch.bench; MFU {j['mfu']:.4f}",
                "weights": j["weights"]}
    m = re.search(r"^RESULT (.*)$", out, re.M)
    if returncode == 0 and m:
        return json.loads(m.group(1))
    return {"config": n, "error": (err or out).strip().splitlines()[-20:]}


def run_config(n: int, reps: int, timeout: float = TIMEOUT_S):
    """(row, wall seconds) of config n in a subprocess of its own."""
    t0 = time.perf_counter()
    try:
        p = subprocess.run(_command(n, reps), cwd=ROOT, capture_output=True,
                           text=True, timeout=timeout,
                           env=dict(os.environ, PYTHONPATH=ROOT))
        row = parse(n, p.returncode, p.stdout, p.stderr)
    except subprocess.TimeoutExpired:
        row = {"config": n, "error": [f"timed out after {timeout} s"]}
    return row, time.perf_counter() - t0


def table(rows: list) -> str:
    """The markdown table of tools/configs_bench.py."""
    lines = ["| config | frames | steady s | fps | note |",
             "|---|---|---|---|---|"]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['config']} | — | — | — | "
                         f"ERROR {r['error']} |")
        else:
            lines.append(f"| {r['config']}. {r['desc']} | {r['frames']} | "
                         f"{r['seconds']:.3f} | {r['fps']:.1f} | "
                         f"{r['note']} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", type=int, default=0, choices=range(0, 6),
                    help="run config N alone (0: all five)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed runs of configs 1, 2 and 4")
    ap.add_argument("--out", default="", help="also write the table here")
    ap.add_argument("--run", type=int, default=0, choices=(0, 2, 3, 4, 5),
                    help=argparse.SUPPRESS)   # one config, in this process
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("configs_bench: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    if args.run:
        print("RESULT " + json.dumps(run_one(args.run, args.reps)))
        return 0
    rows = []
    for n in CONFIGS:
        if args.only and n != args.only:
            continue
        print(f"== config {n}", flush=True)
        row, wall = run_config(n, args.reps)
        row["wall_incl_startup_s"] = wall
        print(json.dumps(row), flush=True)
        rows.append(row)
    text = table(rows)
    print("\n" + text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
