"""Traffic kind ``stream``: one client, back-to-back utterances through
``FloatPipeline.generate_stream``, every chunk delivered to the host on
the mix's ``wire`` with a first chunk of ``first_chunk`` frames.

Mix parameters: ``lengths_s``, the utterance lengths in whole seconds;
every block of len(lengths_s) requests holds each length once, in an
order drawn from the seed, so every seed sends the same work.  Each
utterance its own seeded portrait and wave.  The traced run's requests
go stage by stage (encode_image, encode_audio, emotion_latent, sample,
then ``decode_to_host`` on the uint8 wire)."""
from __future__ import annotations

import itertools
import math
import time

import numpy as np
import torch

from harness import seeded
from harness.main import Request
from harness.clips import audio_frames, expected, inputs  # noqa: F401
from harness.compare import frame_mae_max


def _length(run, index: int) -> int:
    lengths = run.mix["lengths_s"]
    block, k = divmod(index, len(lengths))
    rng = np.random.default_rng(seeded.sub_seed(run.seed, 4, block))
    return int(lengths[rng.permutation(len(lengths))[k]])


def _request(run, index: int, seed: int) -> Request:
    sr = run.model["float"]["sampling_rate"]
    secs = _length(run, index) if index >= 0 else -index
    return Request(index, {"seed": seed, "samples": secs * sr})


def requests(run):
    for i in itertools.count():
        yield _request(run, i, seeded.sub_seed(run.seed, 2, i))


def longest(run, index: int) -> bool:
    """Whether the request is of the mix's longest length; the sample
    held against the reference has one of them."""
    return _length(run, index) == max(run.mix["lengths_s"])


def warm(run):
    """One utterance of each length, on each path the run takes."""
    for k, secs in enumerate(sorted(set(run.mix["lengths_s"]))):
        for staged in (False, True) if run.traced else (False,):
            serve(run, _request(run, -secs, seeded.sub_seed(run.seed, 3, k)),
                  staged)
    run.spans.clear()


def serve(run, req, staged=False):
    if run.mix["wire"] != "u8":
        raise ValueError("the stream kind compares uint8 RGB frames")
    img, wave, seed = inputs(run, req.params)
    pipe, i = run.pipe, req.index
    emotion = run.model["emotion"]
    t_frames = audio_frames(run, wave.shape[-1])
    run.sync()
    req.t0 = time.perf_counter()
    if staged:
        with run.span("encode_image", i):
            s_r, _lam, feats, r_s = pipe.encode_image(img)
        with run.span("encode_audio", i):
            wa = pipe.encode_audio(wave, t_frames)
        with run.span("emotion_latent", i):
            we = pipe.emotion_latent(wave, emotion)
        with run.span("sample", i):
            r_d = pipe.sample(r_s, wa, we, seed=seed)
        with run.span("decode_to_host", i):
            f32 = pipe.decode_to_host(s_r, feats, r_d)
        parts = [np.rint(f32 * 255.0).astype(np.uint8)]
        req.chunks = math.ceil(t_frames / (run.model["float"]["wav2vec_sec"]
                                           * run.model["float"]["fps"]))
    else:
        parts = []
        for _start, part in pipe.generate_stream(
                img, wave, emotion=emotion, seed=seed,
                first_chunk=run.mix["first_chunk"], wire=run.mix["wire"]):
            if req.ttfc is None:
                req.ttfc = time.perf_counter() - req.t0
            parts.append(part)
    req.t1 = time.perf_counter()
    req.frames = sum(p.shape[0] for p in parts)
    run.keep(i, parts)


def _wire(frames) -> torch.Tensor:
    """Frames in [0, 1] as the uint8 wire delivers them."""
    return torch.round(frames * 255.0) / 255.0


def numbers(run, req, got, want) -> dict:
    """The uint8 frames against the reference's, rounded as the wire
    rounds them (half to even); ``got`` the chunks, or the control's
    frames."""
    if isinstance(got, list):
        got = torch.from_numpy(np.concatenate(got)).to(want.device) / 255.0
    else:
        got = _wire(got)
    return {"frame_mae_max": frame_mae_max(got, _wire(want))}
