"""The port's slice as a whole: float_torch's FloatPipeline stage chain
against float_tpu's, stage by stage, at tests/test_pipeline.py's TINY
config in float32 on CPU (1 s of audio, 25 frames).  Both samplers are
driven with the same numpy noise through ``noise=``; the JAX decode runs
the exact XLA-gather warp (use_warp_kernel=False)."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from float_tpu.runtime import pipeline as jp
from float_tpu.runtime import sampling as j_sampling
from float_tpu.runtime.decode import _chunk_sizes
from float_tpu.runtime.decode import decode_latents as j_decode
from float_tpu.runtime.sampling import sample_motion_latents as j_sample
from float_torch.runtime import pipeline as tp
from float_torch.runtime import sampling as t_sampling
from float_torch.runtime.decode import chunk_sizes
from torch_parity import TINY, TINY_SER, TINY_W2V, max_err, randn

ATOL = 1e-4
STAGES = ("s_r", "r_s_lambda", "r_s", "feats", "wa", "we", "r_d", "frames")


@pytest.fixture(scope="module")
def pipes():
    return (jp.build_synthetic_pipeline(TINY, TINY_W2V, TINY_SER),
            tp.build_synthetic_pipeline(TINY, TINY_W2V, TINY_SER))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    img = randn(rng, 1, 3, 64, 64, scale=0.3)
    wave = randn(rng, 1, 16000, scale=0.1)
    t = tp.audio_num_frames(wave.shape[-1], TINY)
    clip = TINY.num_frames_for_clip
    noise = randn(rng, math.ceil(t / clip), 1, clip, TINY.dim_w)
    return img, wave, t, noise


def _port_chain(pipe, img, wave, t, noise):
    s_r, lam, feats, r_s = pipe.encode_image(img)
    wa = pipe.encode_audio(wave, t)
    we = pipe.emotion_latent(wave, "none")
    r_d = pipe.sample(r_s, wa, we, noise=noise)
    return dict(s_r=s_r, r_s_lambda=lam, r_s=r_s, feats=feats, wa=wa, we=we,
                r_d=r_d, frames=pipe.decode(s_r, feats, r_d))


@pytest.fixture(scope="module")
def chains(pipes, inputs):
    jpipe, tpipe = pipes
    img, wave, t, noise = inputs
    s_r, lam, feats, r_s = jpipe.encode_image(jnp.asarray(img))
    wa = jpipe.encode_audio(jnp.asarray(wave), t)
    we = jpipe.emotion_latent(jnp.asarray(wave), "none")
    r_d = j_sample(jpipe.params["fmt"], r_s, wa, we, cfg=TINY,
                   noise=jnp.asarray(noise), cfg_mode="3way")
    frames = j_decode(jpipe.params["synthesis"], s_r, feats, r_d[0], size=64,
                      decode_batch=TINY.decode_batch,
                      compute_dtype=jnp.float32, use_warp_kernel=False)
    want = dict(s_r=s_r, r_s_lambda=lam, r_s=r_s, feats=feats, wa=wa, we=we,
                r_d=r_d, frames=frames)
    return want, _port_chain(tpipe, img, wave, t, noise)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_float_tpu(chains, stage):
    want, got = chains
    if stage == "feats":
        assert len(got[stage]) == len(want[stage])
        for g, w in zip(got[stage], want[stage]):
            assert g.shape == w.shape and max_err(g, w) <= ATOL
        return
    assert tuple(got[stage].shape) == tuple(want[stage].shape)
    assert max_err(got[stage], want[stage]) <= ATOL


def test_frames_in_range(chains):
    _, got = chains
    f = got["frames"]
    assert f.shape == (25, 64, 64, 3) and f.dtype == torch.float32
    assert torch.isfinite(f).all() and f.min() >= 0 and f.max() <= 1


def test_generate_equals_stage_chain(pipes, inputs):
    """generate == its own stages with the same generator seed; another
    seed gives other frames."""
    _, pipe = pipes
    img, wave, t, _ = inputs
    s_r, _lam, feats, r_s = pipe.encode_image(img)
    wa = pipe.encode_audio(wave, t)
    we = pipe.emotion_latent(wave, "none")
    r_d = pipe.sample(r_s, wa, we, seed=15)
    staged = pipe.decode(s_r, feats, r_d)
    frames = pipe.generate(img, wave, emotion="none", seed=15)
    assert torch.equal(frames, staged)
    other = pipe.generate(img, wave, emotion="none", seed=16)
    assert (other - frames).abs().max() > 0


def test_named_emotion_and_fps(pipes, inputs):
    _, pipe = pipes
    img, wave, t, _ = inputs
    we = pipe.emotion_latent(None, "happy")
    assert we.shape == (1, 1, 7) and we[0, 0, 3] == 1
    frames = pipe.generate(img, wave[:, :8000], emotion="happy", seed=1,
                           fps=50.0)
    assert frames.shape == (tp.audio_num_frames(8000, TINY.replace(fps=50.0)),
                            64, 64, 3)


def test_windowed_emotion_matches_float_tpu():
    """Clips longer than ser_max_sec predict over windows (0.4 s windows
    of 1 s of audio here: two full windows and a 0.2 s tail)."""
    cfg = dataclasses.replace(TINY, ser_max_sec=0.4)
    wave = randn(np.random.default_rng(9), 1, 16000, scale=0.1)
    want = jp.build_synthetic_pipeline(cfg, TINY_W2V, TINY_SER) \
        .predict_emotion(jnp.asarray(wave))
    got = tp.build_synthetic_pipeline(cfg, TINY_W2V, TINY_SER) \
        .predict_emotion(wave)
    assert max_err(got, want) <= 1e-6


@pytest.mark.parametrize("t,clip,fb", [(250, 50, 24), (25, 10, 4), (7, 10, 8),
                                        (96, 50, 24), (1, 50, 24)])
def test_chunking_helpers_match_float_tpu(t, clip, fb):
    assert chunk_sizes(t, fb) == _chunk_sizes(t, fb, bucketed=True)
    n = math.ceil(t / clip)
    assert t_sampling.bucket_n_chunks(n) == j_sampling.bucket_n_chunks(n)
    x = randn(np.random.default_rng(t), 2, t, 3)
    want = j_sampling.pad_to_chunks(jnp.asarray(x), clip, n + 1)
    got = t_sampling.pad_to_chunks(torch.from_numpy(x), clip, n + 1)
    assert max_err(got, want) == 0.0
