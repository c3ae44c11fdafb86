"""float_torch.models against float_tpu.models at small sizes, in float32
on CPU, with float_tpu's weights carried over by params_to_state_dict."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from float_tpu.models import audio_encoder as j_audio
from float_tpu.models import encoder as j_encoder
from float_tpu.models import fmt as j_fmt
from float_tpu.models import init as j_init
from float_tpu.models import synthesis as j_synthesis
from float_tpu.models import wav2vec2 as j_w2v
from float_torch.models import audio_encoder as t_audio
from float_torch.models import encoder as t_encoder
from float_torch.models import fmt as t_fmt
from float_torch.models import synthesis as t_synthesis
from float_torch.models import wav2vec2 as t_w2v
from torch_parity import (TINY, TINY_SER, TINY_W2V, max_err, port_params,
                          randn)

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny shapes gain nothing from torch's thread pool, whose
    threads, one per core by default, spin between ops: under the suite's
    parallel workers they oversubscribe the CPU and slow every file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synthesis_case():
    """size 128, B=2: five levels (8² … 128²) of warps through the
    dispatcher; the JAX side is synthesis_cl with the exact XLA gather."""
    size, style_dim = 128, 64
    jp = j_init.init_synthesis(size, style_dim, 20, seed=1)
    rng = np.random.default_rng(0)
    wa = randn(rng, 2, style_dim)
    chans = [512, 512, 512, 256, 128]
    feats = [randn(rng, 1, c, 2 ** (3 + i), 2 ** (3 + i))
             for i, c in enumerate(chans)]
    want_img, want_flow = j_synthesis.synthesis_cl(
        jp, jnp.asarray(wa),
        [jnp.transpose(jnp.asarray(f), (0, 2, 3, 1)) for f in feats], size,
        use_warp_kernel=False)
    with torch.inference_mode():
        got_img, got_flow = t_synthesis.synthesis(
            port_params(jp), torch.from_numpy(wa),
            [torch.from_numpy(f) for f in feats], size)
    return want_img, want_flow, got_img, got_flow


def test_synthesis_image(synthesis_case):
    want_img, _, got_img, _ = synthesis_case
    assert got_img.shape == (2, 3, 128, 128)
    assert max_err(got_img.permute(0, 2, 3, 1), want_img) <= ATOL


def test_synthesis_flow64(synthesis_case):
    _, want_flow, _, got_flow = synthesis_case
    assert max_err(got_flow, want_flow) <= ATOL


def test_direction():
    jp = j_init.init_synthesis(64, 64, 20, seed=1)["direction"]
    alpha = randn(np.random.default_rng(1), 3, 20)
    want = j_synthesis.direction(jp, jnp.asarray(alpha))
    got = t_synthesis.direction(port_params(jp), torch.from_numpy(alpha))
    assert max_err(got, want) <= 1e-6


@pytest.fixture(scope="module")
def encoder_case():
    jp = j_init.init_encoder(64, 64, 20, seed=0)
    img = randn(np.random.default_rng(2), 1, 3, 64, 64, scale=0.3)
    want = j_encoder.encode_image(jp, jnp.asarray(img), 64, 64)
    with torch.inference_mode():
        got = t_encoder.encode_image(port_params(jp), torch.from_numpy(img), 64)
    return want, got


@pytest.mark.parametrize("out", ["s_r", "r_s_lambda", "feats"])
def test_encode_image(encoder_case, out):
    want, got = encoder_case
    i = ["s_r", "r_s_lambda", "feats"].index(out)
    if out == "feats":
        assert len(got[2]) == len(want[2]) == 4
        for g, w in zip(got[2], want[2]):
            assert max_err(g, w) <= ATOL
    else:
        assert max_err(got[i], want[i]) <= ATOL


def test_encode_audio():
    params = {"wav2vec2": j_init.init_wav2vec2(TINY_W2V, 2),
              "audio_projection": j_init.init_audio_projection(
                  TINY_W2V.num_hidden_layers * TINY_W2V.hidden_size,
                  TINY.dim_w, 3)}
    wave = randn(np.random.default_rng(3), 1, 15000, scale=0.1)
    want = j_audio.encode_audio(params, jnp.asarray(wave), 25, TINY, TINY_W2V)
    with torch.inference_mode():
        got = t_audio.encode_audio(port_params(params), torch.from_numpy(wave),
                                   25, TINY, TINY_W2V)
    assert got.shape == (1, 25, TINY.dim_w)
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("cfg", [TINY_SER, dataclasses.replace(
    TINY_SER, feat_extract_norm="group", do_stable_layer_norm=False)],
    ids=["pre_ln_large", "post_ln_base"])
def test_predict_emotion(cfg):
    jp = j_init.init_wav2vec2(cfg, 4)
    wave = randn(np.random.default_rng(4), 2, 8000, scale=0.1)
    want = j_w2v.predict_emotion(jp, jnp.asarray(wave), cfg)
    with torch.inference_mode():
        got = t_w2v.predict_emotion(port_params(jp), torch.from_numpy(wave),
                                    cfg)
    assert got.shape == (2, 7)
    assert max_err(got, want) <= 1e-6


@pytest.mark.parametrize("cfg_mode,dynamic", [
    ("3way", False), ("4way", False), ("skip", False), ("3way", True)])
def test_fmt_forward_cfg(cfg_mode, dynamic):
    jp = j_init.init_fmt(TINY, seed=5)
    rng = np.random.default_rng(5)
    clip, prev, b = TINY.num_frames_for_clip, TINY.num_prev_frames, 1
    inputs = dict(
        t=np.asarray([0.3], np.float32), x=randn(rng, b, clip, TINY.dim_w),
        wa=randn(rng, b, clip, TINY.dim_a), wr=randn(rng, b, TINY.dim_w),
        we=randn(rng, b, clip if dynamic else 1, TINY.dim_e),
        prev_x=randn(rng, b, prev, TINY.dim_w),
        prev_wa=randn(rng, b, prev, TINY.dim_a),
        prev_we=randn(rng, b, prev, TINY.dim_e) if dynamic else None)
    kw = dict(a_cfg_scale=2.0, e_cfg_scale=1.3, r_cfg_scale=0.7,
              cfg_mode=cfg_mode, depth=TINY.fmt_depth,
              num_heads=TINY.num_heads,
              attention_window=TINY.attention_window)
    want = j_fmt.fmt_forward_cfg(
        jp, **{k: None if v is None else jnp.asarray(v)
               for k, v in inputs.items()}, **kw)
    with torch.inference_mode():
        got = t_fmt.fmt_forward_cfg(
            port_params(jp), **{k: None if v is None else torch.from_numpy(v)
                                for k, v in inputs.items()}, **kw)
    assert got.shape == (b, prev + clip, TINY.dim_w)
    assert max_err(got, want) <= ATOL


def _audio_params():
    return {"wav2vec2": j_init.init_wav2vec2(TINY_W2V, 2),
            "audio_projection": j_init.init_audio_projection(
                TINY_W2V.num_hidden_layers * TINY_W2V.hidden_size,
                TINY.dim_w, 3)}


def test_encode_audio_with_prev():
    params = _audio_params()
    rng = np.random.default_rng(6)
    per_frame = TINY.sampling_rate / TINY.fps
    wave = randn(rng, 1, int(TINY.num_frames_for_clip * per_frame), scale=0.1)
    prev = randn(rng, 1, int(TINY.num_prev_frames * per_frame), scale=0.1)
    want = j_audio.encode_audio_with_prev(params, jnp.asarray(wave),
                                          jnp.asarray(prev), TINY, TINY_W2V)
    with torch.inference_mode():
        got = t_audio.encode_audio_with_prev(
            port_params(params), torch.from_numpy(wave),
            torch.from_numpy(prev), TINY, TINY_W2V)
    assert got.shape == want.shape == (
        1, TINY.num_prev_frames + TINY.num_frames_for_clip, TINY.dim_w)
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("n", [400, 4001, 15000])
@pytest.mark.parametrize("cfg", [TINY_W2V, TINY_SER], ids=["base", "large"])
def test_feat_extract_output_length(cfg, n):
    got = t_w2v.feat_extract_output_length(n, cfg)
    assert got == j_w2v.feat_extract_output_length(n, cfg)
    wave = torch.zeros(1, n)
    params = port_params(j_init.init_wav2vec2(cfg, 7))
    with torch.inference_mode():
        feats = t_w2v.feature_extractor(params["feature_extractor"], wave, cfg)
    assert feats.shape[1] == got


def test_feature_extract_and_encode():
    jp = j_init.init_wav2vec2(TINY_W2V, 5)
    wave = randn(np.random.default_rng(7), 2, 4000, scale=0.1)
    want_feats = j_w2v.feature_extract(jp, jnp.asarray(wave), 10, TINY_W2V)
    want = j_w2v.encode(jp, want_feats, TINY_W2V)
    tp = port_params(jp)
    with torch.inference_mode():
        feats = t_w2v.feature_extract(tp, torch.from_numpy(wave), 10,
                                      TINY_W2V)
        got = t_w2v.encode(tp, feats, TINY_W2V)
        whole = t_w2v.wav2vec2_frame_features(tp, torch.from_numpy(wave), 10,
                                              TINY_W2V)
    assert feats.shape == (2, 10, TINY_W2V.conv_dim[-1])
    assert max_err(feats, want_feats) <= ATOL
    assert len(got.hidden_states) == len(want.hidden_states) \
        == TINY_W2V.num_hidden_layers + 1
    for g, w in zip((got.last_hidden_state, *got.hidden_states),
                    (want.last_hidden_state, *want.hidden_states)):
        assert max_err(g, w) <= ATOL
    assert torch.equal(whole.last_hidden_state, got.last_hidden_state)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("cfg", [TINY_W2V, TINY_SER], ids=["base", "large"])
def test_wav2vec2_standard(cfg, masked):
    jp = j_init.init_wav2vec2(cfg, 8)
    wave = randn(np.random.default_rng(8), 2, 3200, scale=0.1)
    mask = None
    if masked:
        mask = np.ones((2, 3200), np.int32)
        mask[1, 2000:] = 0
    want = j_w2v.wav2vec2_standard(
        jp, jnp.asarray(wave), cfg,
        attention_mask=None if mask is None else jnp.asarray(mask))
    with torch.inference_mode():
        got = t_w2v.wav2vec2_standard(
            port_params(jp), torch.from_numpy(wave), cfg,
            attention_mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == want.shape == (
        2, t_w2v.feat_extract_output_length(3200, cfg), cfg.hidden_size)
    assert max_err(got, want) <= ATOL
