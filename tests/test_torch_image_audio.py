"""The port's host-side image and audio modules (float_torch.image.*,
float_torch.audio.*, io.video's wav writer) against OpenCV and against
their float_tpu twins.

Tolerances:
- ``image.transform.resize`` against ``cv2.resize`` (INTER_AREA and
  INTER_CUBIC; shrink, grow, mixed and non-integer ratios): at most
  1e-4 × 255 on float32 images of 0..255, at most 1 level on uint8;
- ``face_align_crop`` with a stub detector: the bbox equal, the crop
  within 1 level;
- the composites: within 1e-4 on [0, 1] frames (the uint8 stream within
  1 level);
- rgba, resample, features, wav writing: equal."""
import sys
import wave as wavmod

import cv2
import numpy as np
import pytest
import torch

from float_tpu.audio import features as j_features
from float_tpu.audio import resample as j_resample
from float_tpu.image import composite as j_composite
from float_tpu.image import face_align as j_face
from float_tpu.image import rgba as j_rgba
from float_tpu.image import transform as j_transform
from float_tpu.io import video as j_video
from float_torch.audio import features as t_features
from float_torch.audio import resample as t_resample
from float_torch.image import composite as t_composite
from float_torch.image import face_align as t_face
from float_torch.image import rgba as t_rgba
from float_torch.image import transform as t_transform
from float_torch.io import video as t_video

RESIZE_TOL_F32 = 1e-4 * 255
COMPOSITE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

RESIZE_CASES = {   # (H, W) -> dsize (width, height)
    "shrink": ((96, 128), (32, 24)),
    "grow": ((24, 32), (96, 72)),
    "mixed": ((131, 47), (64, 64)),
    "non_integer": ((103, 77), (41, 59)),
}


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("interp", ["INTER_AREA", "INTER_CUBIC"])
@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_matches_cv2(case, interp, dtype):
    (h, w), dsize = RESIZE_CASES[case]
    rng = np.random.default_rng(len(case))
    img = (rng.random((h, w, 3)) * 255).astype(dtype)
    flag = getattr(cv2, interp)
    got = t_transform.resize(img, dsize, interpolation=getattr(t_transform,
                                                               interp))
    want = cv2.resize(img, dsize, interpolation=flag)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= (RESIZE_TOL_F32 if dtype == "float32" else 1), err


@pytest.mark.parametrize("scale", [360 / 517, 360 / 211])
def test_resize_by_factor_matches_cv2(scale):
    """dsize (0, 0) with fx = fy: the face detector's 360-row resize."""
    img = (np.random.default_rng(3).random((517 if scale < 1 else 211, 300,
                                            3)) * 255).astype(np.uint8)
    interp = "INTER_AREA" if scale < 1 else "INTER_CUBIC"
    got = t_transform.resize(img, (0, 0), fx=scale, fy=scale,
                             interpolation=getattr(t_transform, interp))
    want = cv2.resize(img, (0, 0), fx=scale, fy=scale,
                      interpolation=getattr(cv2, interp))
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1


def test_to_model_input_matches_float_tpu():
    img = (np.random.default_rng(4).random((90, 70, 3)) * 255).astype(np.uint8)
    got = t_transform.to_model_input(img, 64)
    want = j_transform.to_model_input(img, 64)
    assert got.shape == want.shape == (1, 3, 64, 64)
    assert np.abs(got - want).max() <= 1 / 127.5 + 1e-6


def test_load_image_file(tmp_path, monkeypatch):
    img = np.random.default_rng(5).random((8, 6, 4)).astype(np.float32)
    np.save(tmp_path / "a.npy", img)
    np.testing.assert_array_equal(
        t_transform.load_image_file(str(tmp_path / "a.npy")), img)
    u8 = (img * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), cv2.cvtColor(u8, cv2.COLOR_RGBA2BGRA))
    from float_tpu.cli import load_image_file
    np.testing.assert_array_equal(
        t_transform.load_image_file(str(tmp_path / "a.png")),
        load_image_file(str(tmp_path / "a.png")))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="a.png"):
        t_transform.load_image_file(str(tmp_path / "a.png"))


# ---------------------------------------------------------------------------
# face alignment
# ---------------------------------------------------------------------------

def _stub(boxes):
    return lambda img: [tuple(b) for b in boxes]


FACE_CASES = {
    # detections on the 360-row detector image: (x1, y1, x2, y2, score)
    "one_face": [(100.0, 80.0, 180.0, 190.0, 0.99)],
    "edge_face": [(-13.0, -7.0, 61.0, 95.0, 0.999)],
    "second_face": [(10.0, 20.0, 90.0, 110.0, 0.98),
                    (200.0, 150.0, 260.0, 230.0, 0.97)],
    "low_score": [(100.0, 80.0, 180.0, 190.0, 0.5)],
    "index_past_end": [(40.0, 60.0, 120.0, 160.0, 0.99)],
}


@pytest.mark.parametrize("case", sorted(FACE_CASES))
@pytest.mark.parametrize("rows", [517, 211])
def test_face_align_crop_matches_float_tpu(case, rows):
    img = (np.random.default_rng(rows).random((rows, 300, 3)) * 255
           ).astype(np.uint8)
    index = {"second_face": 2, "index_past_end": 3}.get(case, 1)
    det = _stub(FACE_CASES[case])
    got, got_box = t_face.face_align_crop(img, 64, index=index, detector=det)
    want, want_box = j_face.face_align_crop(img, 64, index=index,
                                            detector=det)
    assert got_box == want_box
    assert got.shape == want.shape == (64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1


def test_face_align_default_detector_needs_face_alignment(monkeypatch):
    """Without face_alignment both raise ImportError, and allow_fallback
    takes the same center crop."""
    monkeypatch.setitem(sys.modules, "face_alignment", None)
    monkeypatch.setattr(t_face, "_fa_detector", None)
    monkeypatch.setattr(j_face, "_fa_detector", None)
    img = (np.random.default_rng(0).random((120, 90, 3)) * 255).astype(
        np.uint8)
    for mod in (t_face, j_face):
        with pytest.raises(ImportError, match="face_alignment"):
            mod.face_align_crop(img, 64)
    got, got_box = t_face.face_align_crop(img, 64, allow_fallback=True)
    want, want_box = j_face.face_align_crop(img, 64, allow_fallback=True)
    assert got_box == want_box
    assert np.abs(got.astype(int) - want).max() <= 1


# ---------------------------------------------------------------------------
# compositing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def faces():
    rng = np.random.default_rng(11)
    return rng.random((3, 64, 64, 3)).astype(np.float32)


COMPOSITE_CASES = {   # (background shape, bbox, feather)
    "shrink_inside": ((100, 120, 3), (10, 20, 40, 40), 0),
    "grow_clipped": ((90, 80, 3), (-15, 30, 96, 96), 0),
    "feather": ((100, 120, 3), (30, 5, 50, 50), 6),
    "per_frame_bg": ((3, 70, 90, 3), (5, 5, 70, 70), 3),
    "uint8_scale_bg": ((60, 60, 3), (0, 0, 60, 60), 0),
}


@pytest.mark.parametrize("case", sorted(COMPOSITE_CASES))
def test_composite_frames_matches_float_tpu(case, faces):
    shape, bbox, feather = COMPOSITE_CASES[case]
    bg = np.random.default_rng(len(case)).random(shape).astype(np.float32)
    if case == "uint8_scale_bg":
        bg = bg * 255
    got = t_composite.composite_face_frames(bg, faces, bbox, feather=feather)
    want = j_composite.composite_face_frames(bg, faces, bbox,
                                             feather=feather)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= COMPOSITE_TOL
    one_bg = bg[0] if bg.ndim == 4 else bg
    got1 = t_composite.composite_face(one_bg, faces[0], bbox, feather)
    want1 = j_composite.composite_face(one_bg, faces[0], bbox, feather)
    assert np.abs(got1 - want1).max() <= COMPOSITE_TOL


def test_composite_stream_matches_float_tpu(faces):
    bg = np.random.default_rng(2).random((80, 100, 3)).astype(np.float32)
    spec = [(faces, (5, 5, 40, 40)), (faces[::-1], (50, 20, 80, 80))]
    got = np.stack(list(t_composite.composite_faces_stream(bg, spec, 4)))
    want = np.stack(list(j_composite.composite_faces_stream(bg, spec, 4)))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1


# ---------------------------------------------------------------------------
# rgba, audio, wav
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["blend_with_color", "discard_alpha",
                                      "replace_with_color", "bogus"])
@pytest.mark.parametrize("color", ["#3366CC", "#12", "#zzzzzz"])
def test_rgba_matches_float_tpu(strategy, color):
    rng = np.random.default_rng(1)
    img = rng.random((2, 9, 7, 4)).astype(np.float32)
    img[0, :3, :3, 3] = 0.0
    assert t_rgba.hex_to_rgb_uint8(color) == j_rgba.hex_to_rgb_uint8(color)
    np.testing.assert_array_equal(
        t_rgba.image_to_uint8(img, strategy, color),
        j_rgba.image_to_uint8(img, strategy, color))


@pytest.mark.parametrize("sr_in", [16000, 22050, 44100, 8000])
def test_resample_matches_float_tpu(sr_in):
    rng = np.random.default_rng(sr_in)
    audio = {"waveform": rng.standard_normal((2, 2, sr_in // 10)).astype(
        np.float32), "sample_rate": sr_in}
    np.testing.assert_array_equal(t_resample.comfy_audio_to_mono_16k(audio),
                                  j_resample.comfy_audio_to_mono_16k(audio))
    np.testing.assert_array_equal(t_resample.to_mono(audio["waveform"][0]),
                                  j_resample.to_mono(audio["waveform"][0]))


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("side", ["right", "left"])
def test_features_match_float_tpu(mask, side):
    rng = np.random.default_rng(3)
    waves = [rng.standard_normal(n).astype(np.float32) * 0.2 + 0.1
             for n in (900, 1300, 400)]
    fe_t = t_features.FeatureExtractorConfig(return_attention_mask=mask,
                                             padding_side=side,
                                             padding_value=-0.5)
    fe_j = j_features.FeatureExtractorConfig(return_attention_mask=mask,
                                             padding_side=side,
                                             padding_value=-0.5)
    got = t_features.extract_features(waves, fe_t, return_mask=True)
    want = j_features.extract_features(waves, fe_j, return_mask=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_preprocessor_config_and_wav_io(tmp_path):
    (tmp_path / "preprocessor_config.json").write_text(
        '{"do_normalize": false, "sampling_rate": 8000}')
    got = t_features.load_preprocessor_config(str(tmp_path))
    want = j_features.load_preprocessor_config(str(tmp_path))
    assert (got.do_normalize, got.sampling_rate) == (
        want.do_normalize, want.sampling_rate) == (False, 8000)
    audio = np.random.default_rng(0).standard_normal((2, 777)).astype(
        np.float32) * 0.4
    t_video.write_wav(str(tmp_path / "t.wav"), audio, 8000)
    j_video.write_wav(str(tmp_path / "j.wav"), audio, 8000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = t_resample.read_wav_file(str(tmp_path / "t.wav"))
    want, _ = j_resample.read_wav_file(str(tmp_path / "t.wav"))
    assert sr == 8000
    np.testing.assert_array_equal(got, want)
    with wavmod.open(str(tmp_path / "t.wav")) as w:
        assert w.getnchannels() == 2


def test_write_video_without_a_writer_raises(tmp_path, monkeypatch):
    """Neither cv2 nor ffmpeg: write_video raises, it never skips."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(t_video, "have_ffmpeg", lambda: False)
    assert t_video.video_backend() == ""
    frames = np.zeros((2, 8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="neither"):
        t_video.write_video(str(tmp_path / "v.mp4"), frames, 25.0)


def test_write_video_with_cv2(tmp_path):
    frames = np.random.default_rng(0).random((3, 16, 16, 3)).astype(np.float32)
    path = str(tmp_path / "v.mp4")
    assert t_video.video_backend() == "cv2"
    assert t_video.write_video(path, frames, 25.0) == ""
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 3


def test_video_backend_falls_back_to_ffmpeg(monkeypatch):
    """Without cv2, an ffmpeg binary on PATH is the writer."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(t_video, "have_ffmpeg", lambda: True)
    assert t_video.video_backend() == "ffmpeg"
