"""Traffic kind ``clip``: one client, back-to-back one-shot clips through
``FloatPipeline.generate``, the output left on the device.

Mix parameters: ``seconds`` of 16 kHz audio a clip; each clip its own
seeded portrait, wave and sampler seed.  The traced run's clips go stage
by stage (encode_image, encode_audio, emotion_latent, sample, decode),
each stage a span."""
from __future__ import annotations

import itertools
import time

from harness import seeded
from harness.clips import audio_frames, expected, inputs  # noqa: F401
from harness.compare import frame_mae_max
from harness.main import Request


def requests(run):
    n = int(run.mix["seconds"] * run.model["float"]["sampling_rate"])
    for i in itertools.count():
        yield Request(i, {"seed": seeded.sub_seed(run.seed, 2, i),
                          "samples": n})


def warm(run):
    """The window's one shape, on each path the run takes."""
    n = int(run.mix["seconds"] * run.model["float"]["sampling_rate"])
    for k, staged in enumerate((False, True) if run.traced else (False,)):
        serve(run, Request(-1, {"seed": seeded.sub_seed(run.seed, 3, k),
                                "samples": n}), staged)
    run.spans.clear()


def serve(run, req, staged=False):
    img, wave, seed = inputs(run, req.params)
    pipe, i = run.pipe, req.index
    emotion = run.model["emotion"]
    run.sync()
    req.t0 = time.perf_counter()
    if staged:
        with run.span("encode_image", i):
            s_r, _lam, feats, r_s = pipe.encode_image(img)
        with run.span("encode_audio", i):
            wa = pipe.encode_audio(wave, audio_frames(run, wave.shape[-1]))
        with run.span("emotion_latent", i):
            we = pipe.emotion_latent(wave, emotion)
        with run.span("sample", i):
            r_d = pipe.sample(r_s, wa, we, seed=seed)
        with run.span("decode", i):
            frames = pipe.decode(s_r, feats, r_d)
    else:
        frames = pipe.generate(img, wave, emotion=emotion, seed=seed)
        run.sync()
    req.t1 = time.perf_counter()
    req.frames = frames.shape[0]
    run.keep(i, frames)


def numbers(run, req, got, want) -> dict:
    return {"frame_mae_max": frame_mae_max(got.float(), want)}
