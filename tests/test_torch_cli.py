"""The port's command-line interface (float_torch.cli) in process with
``--device cpu``: ``inspect`` (its output equal to float_tpu's on the same
file), ``generate`` with and without ``--stream`` (mp4 of the expected
frame count; .npy outputs of the two within one uint8 level), ``workflow``,
``graph`` (example_workflows/graph_regular.json from a tiny model store)
and ``--help``.  The tiny configs of tests/torch_parity.py reach the
loader through a patched ``float_torch.api.nodes.load_float_models``
(tests/test_graph.py's monkeypatch pattern); the tiny unified checkpoint
is written by the port's writer, 32 channels at every image level; one
torch thread."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from float_tpu import cli as j_cli
from float_torch import cli
from float_torch import config as t_config
from float_torch.api import nodes as t_nodes
from float_torch.io.checkpoint import save_safetensors, unified_state_dict
from float_torch.io.video import write_wav
from float_torch.models import init as t_init
from float_torch.models.init import init_pipeline, params_to_state_dict
from torch_parity import TINY, TINY_SER, TINY_W2V

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT_TINY = t_config.FloatConfig(**dataclasses.asdict(TINY))
PT_W2V = t_config.Wav2Vec2Config(**dataclasses.asdict(TINY_W2V))
PT_SER = t_config.Wav2Vec2Config(**dataclasses.asdict(TINY_SER))
N_AUDIO = 16000                 # 1 s -> 25 frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _narrow_channels():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_init, "CHANNELS_MAP",
                   dict.fromkeys(t_init.CHANNELS_MAP, 32))
        yield


@pytest.fixture(autouse=True)
def _tiny_loader(monkeypatch):
    """Every load_float_models call of the CLI gets the tiny configs; a
    config the CLI passes (its --decode-batch) keeps its decode_batch.
    Yields the configs loaded."""
    load = t_nodes.load_float_models
    loaded = []

    def tiny(*args, **kw):
        cfg = kw.get("cfg")
        kw["cfg"] = PT_TINY if cfg is None else PT_TINY.replace(
            decode_batch=cfg.decode_batch)
        for key, val in (("w2v_cfg", PT_W2V), ("ser_cfg", PT_SER)):
            if kw.get(key) is None:
                kw[key] = val
        loaded.append(kw["cfg"])
        return load(*args, **kw)

    monkeypatch.setattr(t_nodes, "load_float_models", tiny)
    yield loaded


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """<root>/float/FLOAT.safetensors at the tiny configs, a portrait and
    1 s of audio as .npy and as .wav."""
    root = tmp_path_factory.mktemp("cli")
    ckpt = root / "float" / "FLOAT.safetensors"
    ckpt.parent.mkdir()
    save_safetensors(unified_state_dict(params_to_state_dict(
        init_pipeline(PT_TINY, PT_W2V, PT_SER, seed=0))), str(ckpt))
    rng = np.random.default_rng(3)
    np.save(root / "img.npy", rng.random((64, 64, 3)).astype(np.float32))
    aud = (rng.standard_normal(N_AUDIO) * 0.1).astype(np.float32)
    np.save(root / "aud.npy", aud)
    write_wav(str(root / "aud.wav"), aud, 16000)
    return root


def _mp4_frames(path) -> int:
    import cv2
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_inspect_matches_reference(store, capsys):
    ckpt = str(store / "float" / "FLOAT.safetensors")
    cli.main(["inspect", ckpt])
    got = capsys.readouterr().out
    j_cli.main(["inspect", ckpt])
    assert got == capsys.readouterr().out
    n = sum(p.numel() for p in params_to_state_dict(
        init_pipeline(PT_TINY, PT_W2V, PT_SER)).values())
    assert f"{n / 1e6:.1f} M params" in got.splitlines()[0]
    assert "synthesis arch:" in got and "fmt arch:" in got


def _generate(store, out, *extra):
    cli.main(["generate", "--checkpoint",
              str(store / "float" / "FLOAT.safetensors"),
              "--image", str(store / "img.npy"), "--output", str(out),
              "--device", "cpu", "--no-progress", *extra])


@pytest.mark.parametrize("stream", [False, True])
def test_generate_writes_mp4(store, tmp_path, capsys, stream):
    out = tmp_path / "out.mp4"
    audio = store / ("aud.wav" if stream else "aud.npy")
    _generate(store, out, "--audio", str(audio),
              *(["--stream"] if stream else []))
    printed = capsys.readouterr().out
    assert "generated 25 frames" in printed and f"wrote {out}" in printed
    assert ("first frames after" in printed) == stream
    assert _mp4_frames(out) == 25


def test_generate_stream_equals_oneshot(store, tmp_path):
    """The --stream frames and the one-shot frames, both float32 through a
    uint8 wire (generate_stream's and float_process's), within one uint8
    level."""
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    _generate(store, a, "--audio", str(store / "aud.npy"))
    _generate(store, b, "--audio", str(store / "aud.npy"), "--stream")
    one, streamed = np.load(a), np.load(b)
    assert one.shape == streamed.shape == (25, 64, 64, 3)
    assert one.dtype == streamed.dtype == np.float32
    assert np.abs(one - streamed).max() <= 1 / 255 + 1e-4


def test_generate_decode_batch(store, tmp_path, _tiny_loader):
    """--decode-batch reaches the loaded config; the clip keeps its 25
    frames in 12-frame decode chunks."""
    out = tmp_path / "out.npy"
    _generate(store, out, "--audio", str(store / "aud.npy"),
              "--decode-batch", "12")
    assert [c.decode_batch for c in _tiny_loader] == [12]
    assert np.load(out).shape == (25, 64, 64, 3)


def test_workflow(store, tmp_path):
    cfg = tmp_path / "wf.json"
    cfg.write_text(json.dumps({
        "checkpoint": str(store / "float" / "FLOAT.safetensors"),
        "image": str(store / "img.npy"), "audio": str(store / "aud.npy")}))
    cli.main(["workflow", str(cfg), "--output", str(tmp_path / "wf"),
              "--device", "cpu"])
    assert np.load(tmp_path / "wf.npy").shape == (25, 64, 64, 3)


def test_graph_regular(store, tmp_path, capsys):
    """graph_regular.json end to end: LoadFloatModelsOpt reads the tiny
    store's FLOAT.safetensors onto the CPU, VHS_VideoCombine writes the
    mp4."""
    out = tmp_path / "graph_out"
    cli.main(["graph", os.path.join(REPO, "example_workflows",
                                    "graph_regular.json"),
              "--models-root", str(store), "--inputs-dir", str(store),
              "--output-dir", str(out), "--image", "img.npy",
              "--audio", "aud.npy", "--device", "cpu", "--no-progress"])
    (mp4,) = out.rglob("*.mp4")
    assert f"wrote {mp4}" in capsys.readouterr().out
    assert _mp4_frames(mp4) == 25


def test_help_and_refusals(capsys):
    with pytest.raises(SystemExit) as info:
        cli.main(["--help"])
    assert info.value.code == 0
    out = capsys.readouterr().out
    for cmd in ("generate", "inspect", "workflow", "graph", "serve"):
        assert cmd in out
    with pytest.raises(SystemExit) as info:
        cli.main(["bench"])              # no card: no measurement, exit 1
    assert info.value.code == 1
    with pytest.raises(ValueError, match="both axes"):
        cli.main(["serve", "--mesh", "data=2", "--device", "cpu"])
    proc = subprocess.run([sys.executable, "-m", "float_torch.cli", "--help"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0 and "serve" in proc.stdout
