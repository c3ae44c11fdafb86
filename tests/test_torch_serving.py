"""The port's host-delivery entry points (decode_to_host, generate_stream,
generate_batch, prepared sources, progress) hold the invariants that
float_tpu's tests/test_serving.py and tests/test_pipeline.py pin for the
JAX pipeline: the stream equals generate, the first-chunk ramp, batches
equal serial runs (ragged too), progress on completion, a prepared source
equals generate.  Tiny config, float32, on the CPU."""
import math

import numpy as np
import pytest
import torch

from float_torch.models import init as t_init
from float_torch.ops.yuv420 import rgb01_to_i420
from float_torch.runtime.pipeline import (audio_num_frames,
                                          build_synthetic_pipeline)
from torch_parity import TINY, TINY_SER, TINY_W2V, randn

U8_TOL = 1 / 255.0 + 1e-5      # one step of the uint8 wire


def _pipeline(cfg):
    """The tiny pipeline with 32 channels at every image level: these
    tests hold the port against itself, and the default map's 512-channel
    levels would make each decode most of the file's CPU time."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_init, "CHANNELS_MAP", dict.fromkeys(t_init.CHANNELS_MAP,
                                                         32))
        return build_synthetic_pipeline(cfg, TINY_W2V, TINY_SER,
                                        device="cpu")


@pytest.fixture(scope="module")
def pipe():
    return _pipeline(TINY)


@pytest.fixture(scope="module")
def pipe8():
    return _pipeline(TINY.replace(decode_batch=8))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    return randn(rng, 1, 3, 64, 64, scale=0.3), randn(rng, 1, 16000,
                                                      scale=0.1)


@pytest.fixture(scope="module")
def ref_clip(pipe, inputs):
    img, wave = inputs
    return pipe.generate(img, wave, emotion="happy", seed=3).numpy()


def _stream(pipe, img, wave, **kw):
    starts, parts = [], []
    for start, frames in pipe.generate_stream(img, wave, emotion="happy",
                                              seed=3, **kw):
        starts.append(start)
        parts.append(frames)
    return starts, parts


def test_generate_stream_matches_generate(pipe, inputs, ref_clip):
    """Streamed chunks join to the one-shot clip: the same noise from the
    same generator, the same chunk math."""
    starts, parts = _stream(pipe, *inputs, uint8_transfer=False)
    got = np.concatenate(parts)
    assert starts == sorted(starts) and starts[0] == 0
    assert got.shape == ref_clip.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref_clip, atol=2e-5, rtol=0)


def test_generate_stream_first_chunk_ramp(pipe8, inputs, ref_clip):
    """first_chunk makes the first dispatch small (rounded up to 4 frames);
    later chunks are full decode_batch; the frames are unchanged."""
    starts, parts = _stream(pipe8, *inputs, uint8_transfer=False,
                            first_chunk=3)
    assert [p.shape[0] for p in parts] == [4, 8, 8, 5]
    assert starts == [0, 4, 12, 20]
    np.testing.assert_allclose(np.concatenate(parts), ref_clip, atol=2e-5,
                               rtol=0)
    # a first_chunk above decode_batch clamps to decode_batch
    _, parts = _stream(pipe8, *inputs, uint8_transfer=False, first_chunk=99)
    assert parts[0].shape[0] == 8
    np.testing.assert_allclose(np.concatenate(parts), ref_clip, atol=2e-5,
                               rtol=0)


def test_generate_stream_wires(pipe, inputs, ref_clip):
    """"u8" yields round(frames·255); "yuv420" yields the 4:2:0 planes of
    the frames (one quantisation step of slack for f32 rounding)."""
    _, u8 = _stream(pipe, *inputs, wire="u8", first_chunk=4)
    u8 = np.concatenate(u8)
    assert u8.dtype == np.uint8 and u8.shape == ref_clip.shape
    want = np.round(ref_clip * 255.0)
    assert np.abs(u8.astype(int) - want).max() <= 1
    _, yuv = _stream(pipe, *inputs, wire="yuv420", first_chunk=4)
    yuv = np.concatenate(yuv)
    want = rgb01_to_i420(torch.from_numpy(ref_clip)).numpy()
    assert yuv.dtype == np.uint8 and yuv.shape == (25, 96, 64)
    assert np.abs(yuv.astype(int) - want.astype(int)).max() <= 1
    with pytest.raises(ValueError):
        next(pipe.generate_stream(*inputs, emotion="happy", wire="rgb"))


def test_generate_stream_decodes_before_sampling_ends(pipe, inputs):
    """The first decoded chunk is yielded before the last sampler chunk is
    integrated (the interleaving contract)."""
    events = []
    gen = pipe.generate_stream(*inputs, emotion="happy", seed=3,
                               progress=lambda *e: events.append(e))
    next(gen)
    n_chunks = math.ceil(25 / TINY.num_frames_for_clip)
    assert [e for e in events if e[0] == "sample"] == [("sample", 1,
                                                        n_chunks)]
    list(gen)
    decode = [e for e in events if e[0] == "decode"]
    assert [e[1] for e in decode] == list(range(1, 8))
    assert {e[2] for e in decode} == {7}
    assert [e for e in events if e[0] == "sample"][-1] == ("sample", n_chunks,
                                                           n_chunks)


def test_generate_stream_progress_counts_the_ramp(pipe8, inputs):
    """With a first-chunk ramp the decode progress total is the number of
    dispatches: 24 frames at decode_batch 8 and first_chunk 4 are 4 + 8 +
    8 + 4 frames, four chunks, not ceil(24 / 8) = 3."""
    img, wave = inputs
    n = 15360                      # 24 frames at 25 fps
    assert audio_num_frames(n, TINY) == 24
    events = []
    _, parts = _stream(pipe8, img, wave[:, :n], first_chunk=4,
                       progress=lambda *e: events.append(e))
    assert [p.shape[0] for p in parts] == [4, 8, 8, 4]
    decode = [e for e in events if e[0] == "decode"]
    assert decode == [("decode", i, 4) for i in range(1, 5)]


def test_decode_to_host_matches_device_decode(pipe, inputs):
    img, wave = inputs
    t = audio_num_frames(8000, TINY)
    s_r, _lam, feats, r_s = pipe.encode_image(img)
    wa = pipe.encode_audio(wave[:, :8000], t)
    we = pipe.emotion_latent(None, "happy")
    r_d = pipe.sample(r_s, wa, we, seed=4)
    dev = pipe.decode(s_r, feats, r_d).numpy()
    host = pipe.decode_to_host(s_r, feats, r_d)
    assert host.shape == dev.shape and host.dtype == np.float32
    np.testing.assert_allclose(host, dev, atol=1.0 / 255 + 1e-6)
    exact = pipe.decode_to_host(s_r, feats, r_d, uint8_transfer=False)
    np.testing.assert_allclose(exact, dev, atol=1e-6)


def test_decode_to_host_progress_fires_on_completion(pipe, inputs):
    img, wave = inputs
    t = audio_num_frames(16000, TINY)
    s_r, _lam, feats, r_s = pipe.encode_image(img)
    r_d = pipe.sample(r_s, pipe.encode_audio(wave, t),
                      pipe.emotion_latent(wave, "happy"), seed=1)
    events = []
    pipe.decode_to_host(s_r, feats, r_d, progress=lambda *e: events.append(e))
    n = math.ceil(t / TINY.decode_batch)
    assert events == [("decode", i, n) for i in range(1, n + 1)]


def test_generate_progress_stages(pipe, inputs):
    events = []
    pipe.generate(*inputs, emotion="happy", seed=3,
                  progress=lambda *e: events.append(e))
    n = math.ceil(25 / TINY.decode_batch)
    assert events == ([("encode_image", 1, 1), ("encode_audio", 1, 1),
                       ("emotion", 1, 1), ("sample", 1, 1)]
                      + [("decode", i, n) for i in range(1, n + 1)])


def test_generate_with_prepared_source(pipe, inputs, ref_clip):
    """source= skips the encoder forward and gives the same frames;
    img=None without a source raises."""
    img, wave = inputs
    src = pipe.prepare_source(img)
    events = []
    got = pipe.generate(None, wave, emotion="happy", seed=3, source=src,
                        progress=lambda *e: events.append(e))
    np.testing.assert_array_equal(got.numpy(), ref_clip)
    assert events[0] == ("reuse_source", 1, 1)
    first = next(iter(pipe.generate_stream(None, wave, emotion="happy",
                                           seed=3, source=src,
                                           uint8_transfer=False)))
    np.testing.assert_allclose(first[1], ref_clip[:first[1].shape[0]],
                               atol=2e-6)
    with pytest.raises(ValueError):
        pipe.generate(None, wave, emotion="happy")


def test_generate_stream_fps_override(pipe, inputs):
    img, wave = inputs
    t_double = audio_num_frames(8000, TINY.replace(fps=TINY.fps * 2))
    total = sum(f.shape[0] for _s, f in pipe.generate_stream(
        img, wave[:, :8000], seed=1, emotion="happy", fps=TINY.fps * 2))
    assert total == t_double > audio_num_frames(8000, TINY)


def _serial(pipe, img, wave, seed):
    return pipe.generate(img, wave, emotion="happy", seed=seed).numpy()


def test_generate_batch_matches_serial(pipe, inputs):
    img, wave = inputs
    img2 = randn(np.random.default_rng(23), 1, 3, 64, 64, scale=0.3)
    imgs = np.concatenate([img, img2])
    waves = np.concatenate([wave, wave * 0.5])
    outs = pipe.generate_batch(imgs, waves, emotion="happy", seeds=[15, 16])
    assert len(outs) == 2
    for i, seed in enumerate((15, 16)):
        ref = _serial(pipe, imgs[i:i + 1], waves[i:i + 1], seed)
        assert outs[i].shape == ref.shape and outs[i].dtype == np.float32
        np.testing.assert_allclose(outs[i], ref, atol=U8_TOL)


def test_generate_batch_ragged_matches_serial(pipe, inputs):
    """Mixed-length clips in one call: the audio encodes once per length
    group, the decode shares one dispatch stream, and every clip equals
    its solo generate (no padding touches the audio features)."""
    img, wave = inputs
    waves = [wave[0], wave[0, :8000] * 0.5, wave[0] * 0.8]
    imgs = np.concatenate([img, img * 0.9, img])
    events = []
    outs = pipe.generate_batch(imgs, waves, emotion="happy",
                               seeds=[15, 16, 17],
                               progress=lambda *e: events.append(e))
    assert [o.shape[0] for o in outs] == [25, 13, 25]
    for i, seed in enumerate((15, 16, 17)):
        ref = _serial(pipe, imgs[i:i + 1], waves[i][None], seed)
        np.testing.assert_allclose(outs[i], ref, atol=U8_TOL)
    decode = [e for e in events if e[0] == "decode"]
    assert [e[1] for e in decode] == list(range(1, 7 + 4 + 7 + 1))


def test_generate_batch_equal_length_list_is_one_batch(pipe, inputs,
                                                       monkeypatch):
    """A ragged list whose lengths match encodes its audio once, as one
    batch, and still matches serial; default seeds are cfg.seed + i."""
    from float_torch.runtime import pipeline as tpl
    img, wave = inputs
    calls = []
    real = tpl._encode_audio           # every audio encode of the pipeline
    monkeypatch.setattr(tpl, "_encode_audio", lambda p, w, *a: calls.append(
        tuple(w.shape)) or real(p, w, *a))
    outs = pipe.generate_batch(np.concatenate([img, img]),
                               [wave[0], wave[0] * 0.5], emotion="happy")
    assert calls == [(2, 16000)]
    monkeypatch.undo()
    for i, w in enumerate((wave[0], wave[0] * 0.5)):
        ref = _serial(pipe, img, w[None], TINY.seed + i)
        np.testing.assert_allclose(outs[i], ref, atol=U8_TOL)
