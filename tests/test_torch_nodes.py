"""The 24 node functions of float_torch.api.nodes against their
float_tpu.api.nodes twins, at tests/torch_parity.py's tiny configs on the
CPU, every model read from one tiny model store (a unified
FLOAT.safetensors, the part files cut from it, two HF folders) written by
the port's own safetensors writer, with 32 channels at every image level.

Both samplers draw the same numpy noise: the nodes' own noise comes from
JAX's PRNG on one side and a torch.Generator on the other, so each side's
sampler is patched (``patch_samplers``) to pass ``noise=`` to
``sample_motion_latents``.

Tolerances: latents and features within 1e-4; frames, which both sides
round to whole uint8 levels on the wire, and face crops, which both sides
resize in uint8, within one level (1/255 + 1e-4);
parameters, architectures, dicts and boxes equal.  The refusals (batch
mismatch, missing checkpoint without ``allow_synthetic``, ...) raise the
same exception types on both sides."""
import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from float_tpu.api import nodes as j_nodes
from float_tpu.api.types import FloatPipe as JFloatPipe
from float_tpu.io import checkpoint as j_ckpt
from float_tpu.models.fmt import infer_cfg_mode as j_infer_cfg_mode
from float_tpu.runtime import pipeline as jp
from float_tpu.runtime.sampling import sample_motion_latents as j_sample
from float_torch import config as t_config
from float_torch.api import nodes as t_nodes
from float_torch.io.download import extract_part
from float_torch.models import init as t_init
from float_torch.io.checkpoint import save_safetensors
from test_torch_checkpoint import flatten, unified_flat, write_hf_dir
from torch_parity import TINY, TINY_SER, TINY_W2V, np32

ATOL = 1e-4
FRAME_TOL = 1 / 255 + 1e-4
PT_TINY = t_config.FloatConfig(**dataclasses.asdict(TINY))
PT_W2V = t_config.Wav2Vec2Config(**dataclasses.asdict(TINY_W2V))
PT_SER = t_config.Wav2Vec2Config(**dataclasses.asdict(TINY_SER))
SEED = 9
N_AUDIO = 5512            # 0.25 s at 22.05 kHz -> 4000 samples at 16 kHz


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _narrow_channels():
    """32 channels at every image level while the tiny store is written
    and the port builds its pipelines (tests/test_torch_serving.py's
    narrowing): the default map's 512-channel levels would make each
    decode most of the file's CPU time.  float_tpu reads the widths from
    the same file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_init, "CHANNELS_MAP",
                   dict.fromkeys(t_init.CHANNELS_MAP, 32))
        yield


def noise_for(seed: int, shape) -> np.ndarray:
    """The sampler noise both sides draw for ``seed``: (n_chunks, B, clip,
    dim_w) from a numpy generator."""
    return np.random.default_rng(seed % 2 ** 32).standard_normal(
        shape).astype(np.float32)


def _noise_shape(cfg, wa):
    clip = cfg.num_frames_for_clip
    return (math.ceil(wa.shape[1] / clip), wa.shape[0], clip, cfg.dim_w)


# float_tpu's sampler under one jit (its pipeline jits it too), so calls of
# one shape share a compile; the CFG scales are traced, as cfg_mode is given
_j_sample_jit = jax.jit(j_sample, static_argnames=("cfg", "nfe", "ode_method",
                                                   "cfg_mode"))


def patch_samplers(mp):
    """Make both packages' ``FloatPipeline.sample`` draw ``noise_for(seed)``
    (``mp``: a pytest MonkeyPatch)."""
    from float_torch.runtime import pipeline as tpl
    port_sample = tpl.FloatPipeline.sample

    def jax_side(self, r_s, wa, we, *, seed=None, a_cfg_scale=None,
                 e_cfg_scale=None, r_cfg_scale=None, nfe=None,
                 ode_method=None):
        cfg = self.cfg
        a_s = cfg.a_cfg_scale if a_cfg_scale is None else a_cfg_scale
        e_s = cfg.e_cfg_scale if e_cfg_scale is None else e_cfg_scale
        r_sc = cfg.r_cfg_scale if r_cfg_scale is None else r_cfg_scale
        nz = noise_for(cfg.seed if seed is None else seed,
                       _noise_shape(cfg, wa))
        return _j_sample_jit(
            self.params["fmt"], r_s, wa, we, cfg=cfg,
            a_cfg_scale=jnp.float32(a_s), e_cfg_scale=jnp.float32(e_s),
            r_cfg_scale=jnp.float32(r_sc), nfe=cfg.nfe if nfe is None else nfe,
            ode_method=cfg.ode_method if ode_method is None else ode_method,
            noise=nz, cfg_mode=j_infer_cfg_mode(a_s, r_sc, e_s,
                                                cfg.include_r_cfg))

    def port_side(self, r_s, wa, we, *, seed=None, **kw):
        nz = noise_for(self.cfg.seed if seed is None else seed,
                       _noise_shape(self.cfg, wa))
        return port_sample(self, r_s, wa, we, noise=nz, **kw)

    mp.setattr(jp.FloatPipeline, "sample", jax_side)
    mp.setattr(tpl.FloatPipeline, "sample", port_side)


# ---------------------------------------------------------------------------
# the tiny model store and the two pipes
# ---------------------------------------------------------------------------

PARTS = {"encoder": "float/motion_autoencoder/encoder.safetensors",
         "decoder": "float/motion_autoencoder/decoder.safetensors",
         "projection": "float/audio_projections/projection.safetensors",
         "fmt": "float/fmt/fmt.safetensors"}
W2V_DIR = "audio/wav2vec2-base-960h"
SER_DIR = "audio/wav2vec-english-speech-emotion-recognition"


def write_store(root: Path, params) -> Path:
    """<root>/float/FLOAT.safetensors, the four part files cut from it by
    ``extract_part`` and the two HF folders, in the model-store layout."""
    unified = root / "float" / "FLOAT.safetensors"
    unified.parent.mkdir(parents=True)
    save_safetensors(unified_flat(params), str(unified))
    for key, rel in PARTS.items():
        assert extract_part(str(unified), key, str(root / rel))
    write_hf_dir(root / W2V_DIR, PT_W2V,
                 flatten(params["audio_encoder"]["wav2vec2"]))
    emo = dict(params["emotion"])
    cls = emo.pop("classifier")
    ser = flatten(emo, "wav2vec2")
    ser.update(flatten(cls, "classifier"))
    write_hf_dir(root / SER_DIR, PT_SER, ser)
    return root


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_store(tmp_path_factory.mktemp("store"),
                       t_init.init_pipeline(PT_TINY, PT_W2V, PT_SER, seed=0))


@pytest.fixture(scope="module")
def pipes(store):
    unified = str(store / "float" / "FLOAT.safetensors")
    tp = t_nodes.load_float_models(unified, target_device="cpu", cfg=PT_TINY,
                                   w2v_cfg=PT_W2V, ser_cfg=PT_SER)
    jpipe = JFloatPipe(jp.FloatPipeline(j_ckpt.load_unified_checkpoint(
        unified), TINY, TINY_W2V, TINY_SER), TINY, weights="real")
    return tp, jpipe


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    img = rng.random((64, 64, 3)).astype(np.float32)
    big = rng.random((100, 80, 3)).astype(np.float32)
    audio = {"waveform": (rng.standard_normal((1, 1, N_AUDIO)) * 0.1
                          ).astype(np.float32), "sample_rate": 22050}
    return img, big, audio


def stub_detector(img):
    return [(20.0, 30.0, 200.0, 260.0, 0.99)]


# ---------------------------------------------------------------------------
# both sides, node by node
# ---------------------------------------------------------------------------

def _regular(tp, jpipe, inputs, store):
    img, _big, audio = inputs
    out = {}
    jload = j_nodes.load_float_models(   # float_tpu builds lazily: its
        str(store / "float" / "FLOAT.safetensors"), cfg=TINY)  # params only
    out["load_float_models"] = (
        {"params": dict(tp.pipeline.params.state_dict()),
         "weights": tp.weights, "fe": dataclasses.asdict(tp.fe)},
        {"params": flatten(jload.pipeline.params), "weights": jload.weights,
         "fe": dataclasses.asdict(jload.fe)})
    out["float_process"] = tuple(
        dict(zip(("frames", "audio", "fps"), side.float_process(
            img[None], audio, pipe, emotion="none", seed=SEED)))
        for side, pipe in ((t_nodes, tp), (j_nodes, jpipe)))
    return out


def _advanced(side, pipe, inputs):
    img, big, audio = inputs
    out = {}
    crops, boxes = side.float_image_face_align(big, 64, detector=stub_detector)
    out["float_image_face_align"] = {"crops": crops, "bboxes": boxes}
    out["float_advanced_parameters"] = side.float_advanced_parameters(
        nfe=5, r_cfg_scale=1.5)
    app, lam = side.float_encode_image_to_latents(pipe, img[None])
    out["float_encode_image_to_latents"] = {
        "h_source": app.h_source, "feats": app.feats, "r_s_lambda": lam}
    r_s = side.float_get_identity_reference(pipe, lam)
    out["float_get_identity_reference"] = {"r_s": r_s}
    wa, t, processed = side.float_encode_audio_to_wa(pipe, audio)
    out["float_encode_audio_to_wa"] = {"wa": wa, "t": t,
                                       "processed": processed}
    we = side.float_encode_emotion_to_we(pipe, processed, "none")
    out["float_encode_emotion_to_we"] = {
        "we": we, "we_happy": side.float_encode_emotion_to_we(pipe, None,
                                                              "happy")}
    r_d = side.float_sample_motion_sequence(pipe, r_s, wa, we,
                                            audio_num_frames=t, seed=SEED)
    out["float_sample_motion_sequence"] = {"r_d": r_d}
    frames, fps = side.float_decode_latents_to_images(pipe, app, r_d)
    out["float_decode_latents_to_images"] = {"frames": frames, "fps": fps}
    return out


def _very_advanced(side, store, inputs, device_kw):
    img, _big, audio = inputs
    out = {}
    w2v = side.load_wav2vec_model(str(store / W2V_DIR), **device_kw)
    proj = side.load_audio_projection(str(store / PARTS["projection"]),
                                      **device_kw)
    emo = side.load_emotion_model(str(store / SER_DIR), **device_kw)
    enc = side.load_float_encoder(str(store / PARTS["encoder"]), **device_kw)
    syn = side.load_float_synthesis(str(store / PARTS["decoder"]),
                                    blur_kernel="[1, 3, 3, 1]", **device_kw)
    fmt = side.load_fmt_model(str(store / PARTS["fmt"]),
                              num_heads=TINY.num_heads,
                              num_prev_frames=TINY.num_prev_frames,
                              wav2vec_sec=TINY.wav2vec_sec, **device_kw)

    def params(mod):
        return (dict(mod.state_dict()) if isinstance(mod, torch.nn.Module)
                else flatten(mod))

    out["load_wav2vec_model"] = {"params": params(w2v.params),
                                 "config": dataclasses.asdict(w2v.config),
                                 "sr": w2v.expected_sr}
    out["load_audio_projection"] = {"params": params(proj.params),
                                    "dims": (proj.input_dim,
                                             proj.output_dim)}
    out["load_emotion_model"] = {"params": params(emo.params),
                                 "labels": emo.id2label, "dim_e": emo.dim_e}
    out["load_float_encoder"] = {"params": params(enc.params),
                                 "arch": (enc.input_size, enc.dim,
                                          enc.dim_motion)}
    out["load_float_synthesis"] = {"params": params(syn.params),
                                   "arch": (syn.size, syn.style_dim,
                                            syn.motion_dim,
                                            tuple(syn.blur_kernel))}
    out["load_fmt_model"] = {"params": params(fmt.params),
                             "options": fmt.construction_options,
                             "dims": (fmt.cfg.dim_a, fmt.cfg.dim_h,
                                      fmt.cfg.fmt_depth)}

    feats, processed, t = side.audio_preprocess_and_feature_extract(w2v,
                                                                    audio)
    out["audio_preprocess_and_feature_extract"] = {
        "features": feats, "processed": processed, "t": t}
    wa = side.apply_audio_projection(proj, feats)
    out["apply_audio_projection"] = {"wa": wa}
    we = side.extract_emotion(emo, audio, "none")
    out["extract_emotion"] = {"we": we,
                              "we_happy": side.extract_emotion(emo, None,
                                                               "happy")}
    we_dyn, seq = side.extract_emotion_dynamic(emo, audio, t,
                                               chunk_duration_sec=0.1)
    out["extract_emotion_dynamic"] = {"we": we_dyn, "seq": seq}
    app, lam = side.apply_float_encoder(enc, img)
    out["apply_float_encoder"] = {"h_source": app.h_source,
                                  "feats": app.feats, "r_s_lambda": lam}
    r_s = side.get_identity_reference_va(syn, lam)
    out["get_identity_reference_va"] = {"r_s": r_s}
    r_d = side.sample_motion_sequence_va(fmt, r_s, wa, we_dyn,
                                         audio_num_frames=t, nfe=5,
                                         a_cfg_scale=2.0, e_cfg_scale=1.5,
                                         seed=SEED)
    out["sample_motion_sequence_va"] = {"r_d": r_d}
    frames, fps = side.apply_float_synthesis(syn, app, r_d, decode_batch=4,
                                             use_warp_kernel=False)
    out["apply_float_synthesis"] = {"frames": frames, "fps": fps}
    return out


def _va_noise(monkeypatch, module, drop):
    """Patch ``module.sample_motion_latents`` to take the noise of
    ``noise_for(SEED)`` instead of the node's own PRNG (``drop``)."""
    orig = module.sample_motion_latents

    def sample(fmt_params, r_s, wa, we, **kw):
        kw.pop(drop)
        return orig(fmt_params, r_s, wa, we,
                    noise=noise_for(SEED, _noise_shape(kw["cfg"], wa)), **kw)
    monkeypatch.setattr(module, "sample_motion_latents", sample)


@pytest.fixture(scope="module")
def results(pipes, inputs, store):
    tp, jpipe = pipes
    with pytest.MonkeyPatch.context() as mp:
        patch_samplers(mp)
        out = dict(_regular(tp, jpipe, inputs, store))
        got, want = (_advanced(t_nodes, tp, inputs),
                     _advanced(j_nodes, jpipe, inputs))
        out.update({k: (got[k], want[k]) for k in got})
        _va_noise(mp, t_nodes, "generator")
        _va_noise(mp, j_nodes, "key")
        got = _very_advanced(t_nodes, store, inputs, {"device": "cpu"})
        want = _very_advanced(j_nodes, store, inputs, {})
    out.update({k: (got[k], want[k]) for k in got})
    return out


NODES = (
    "load_float_models", "float_process",
    "float_image_face_align", "float_advanced_parameters",
    "float_encode_image_to_latents", "float_get_identity_reference",
    "float_encode_audio_to_wa", "float_encode_emotion_to_we",
    "float_sample_motion_sequence", "float_decode_latents_to_images",
    "load_wav2vec_model", "load_audio_projection", "load_emotion_model",
    "load_float_encoder", "load_float_synthesis", "load_fmt_model",
    "audio_preprocess_and_feature_extract", "apply_audio_projection",
    "extract_emotion", "extract_emotion_dynamic", "apply_float_encoder",
    "get_identity_reference_va", "sample_motion_sequence_va",
    "apply_float_synthesis",
)


def assert_close(got, want, name, path=""):
    """Arrays and tensors within the tolerance their name implies
    (frames: one uint8 level; parameters: equal; else ATOL); containers
    recursively; everything else equal."""
    if isinstance(want, dict) and isinstance(got, dict):
        assert sorted(map(str, got)) == sorted(map(str, want)), path
        for k in want:
            assert_close(got[k], want[k], name, f"{path}.{k}")
    elif isinstance(want, (list, tuple)) and not np.isscalar(want):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, name, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, torch.Tensor)) or hasattr(want,
                                                                 "shape"):
        g, w = np32(got), np32(want)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        if ".params" in path or name == "load_float_models":
            np.testing.assert_array_equal(g, w, err_msg=path)
            return
        tol = FRAME_TOL if path.startswith((".frames", ".crops")) else ATOL
        err = float(np.abs(g - w).max()) if g.size else 0.0
        assert err <= tol, (path, err, tol)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", NODES)
def test_node_matches_float_tpu(results, name):
    got, want = results[name]
    assert_close(got, want, name)


def test_every_node_function_is_covered():
    public = {n for n in dir(j_nodes) if not n.startswith("_")
              and callable(getattr(j_nodes, n))
              and getattr(getattr(j_nodes, n), "__module__", "")
              == j_nodes.__name__}
    assert public - {"safe_parse_list_str"} == set(NODES)
    assert all(callable(getattr(t_nodes, n)) for n in NODES)


def test_outputs_are_tensors_and_frames_numpy(results):
    got, _ = results["float_sample_motion_sequence"]
    assert isinstance(got["r_d"], torch.Tensor) and got["r_d"].device.type \
        == "cpu"
    frames = results["float_process"][0]["frames"]
    # 0.25 s of audio at 25 fps: ceil(6.25) frames
    assert isinstance(frames, np.ndarray) and frames.shape == (7, 64, 64, 3)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _refusal_cases(tp, jpipe, store):
    r = torch.zeros(2, PT_TINY.dim_w)
    wa = torch.zeros(1, 5, PT_TINY.dim_w)
    we = torch.zeros(1, 1, 7)
    bad_img = np.zeros((1, 32, 32, 3), np.float32)
    return {
        "sample_batch_mismatch": (
            ValueError, lambda s, p: s.float_sample_motion_sequence(
                p, r if s is t_nodes else r.numpy(),
                wa if s is t_nodes else wa.numpy(),
                we if s is t_nodes else we.numpy())),
        "encode_wrong_size": (
            ValueError, lambda s, p: s.float_encode_image_to_latents(
                p, bad_img)),
        "decode_batch_mismatch": (
            ValueError, lambda s, p: s.float_decode_latents_to_images(
                p, s.float_encode_image_to_latents(
                    p, np.zeros((1, 64, 64, 3), np.float32))[0],
                wa.repeat(2, 1, 1) if s is t_nodes
                else np.repeat(wa.numpy(), 2, axis=0))),
        "emotion_needs_audio": (
            ValueError, lambda s, p: s.float_encode_emotion_to_we(p, None,
                                                                  "none")),
        "missing_checkpoint": (
            FileNotFoundError, lambda s, p: s.load_float_models(
                "FLOAT.safetensors", models_root=str(store / "nowhere"),
                **({"target_device": "cpu"} if s is t_nodes else {}))),
        "bad_blur_string": (
            ValueError, lambda s, p: s.safe_parse_list_str("[1, 3, 'x']")),
    }


@pytest.mark.parametrize("case", [
    "sample_batch_mismatch", "encode_wrong_size", "decode_batch_mismatch",
    "emotion_needs_audio", "missing_checkpoint", "bad_blur_string"])
def test_refusals_match_float_tpu(pipes, store, case, monkeypatch):
    from float_torch.io import download as t_download
    from float_tpu.io import download as j_download
    for mod in (t_download, j_download):   # no network in a test
        monkeypatch.setattr(mod, "download_file", lambda url, dest: False)
    tp, jpipe = pipes
    exc, call = _refusal_cases(tp, jpipe, store)[case]
    for side, pipe in ((t_nodes, tp), (j_nodes, jpipe)):
        with pytest.raises(exc):
            call(side, pipe)


def test_load_float_models_device_mapping(store):
    """target_device "cpu" is the CPU; any other value asks for the card,
    which this machine does not have: the loader raises rather than fall
    back to the CPU."""
    unified = str(store / "float" / "FLOAT.safetensors")
    kw = dict(cfg=PT_TINY, w2v_cfg=PT_W2V, ser_cfg=PT_SER)
    pipe = t_nodes.load_float_models(unified, target_device="cpu", **kw)
    assert pipe.pipeline.device.type == "cpu"
    assert t_nodes.node_device("CPU").type == "cpu"
    if not torch.cuda.is_available():
        for target in ("cuda", "tpu"):
            with pytest.raises(RuntimeError, match="CUDA"):
                t_nodes.load_float_models(unified, target_device=target, **kw)


def test_emotion_attention_mask_matches_float_tpu(store):
    """An xlsr-style SER config (return_attention_mask=true): the node on an
    AUDIO batch, and the SER itself on a ragged padded batch whose mask
    shapes the encoder pass, on both sides within ATOL."""
    from float_tpu.audio.features import FeatureExtractorConfig as JFE
    from float_tpu.models.wav2vec2 import predict_emotion as j_predict
    from float_torch.audio.features import FeatureExtractorConfig as TFE
    from float_torch.audio.features import extract_features
    from float_torch.models.wav2vec2 import predict_emotion as t_predict
    rng = np.random.default_rng(5)
    audio = {"waveform": (rng.standard_normal((2, 1, 4000)) * 0.1
                          ).astype(np.float32), "sample_rate": 16000}
    got_pipe = t_nodes.load_emotion_model(str(store / SER_DIR), device="cpu")
    want_pipe = j_nodes.load_emotion_model(str(store / SER_DIR))
    got_pipe.fe = TFE(return_attention_mask=True)
    want_pipe.fe = JFE(return_attention_mask=True)
    got = t_nodes.extract_emotion(got_pipe, audio)
    want = j_nodes.extract_emotion(want_pipe, audio)
    assert tuple(got.shape) == (2, 1, 7)
    assert np.abs(np32(got) - np32(want)).max() <= ATOL

    waves = [audio["waveform"][0, 0, :2500], audio["waveform"][1, 0]]
    batch, mask = extract_features(waves, got_pipe.fe, return_mask=True)
    got = t_predict(got_pipe.params, torch.from_numpy(batch),
                    got_pipe.config, attention_mask=torch.from_numpy(mask))
    want = jax.jit(j_predict, static_argnames="cfg")(
        want_pipe.params, batch, cfg=want_pipe.config, attention_mask=mask)
    assert np.abs(np32(got) - np32(want)).max() <= ATOL
    unmasked = t_predict(got_pipe.params, torch.from_numpy(batch),
                         got_pipe.config)
    assert np.abs(np32(unmasked) - np32(got)).max() > ATOL
