"""The port's measurement entry points on the CPU: float_torch.bench's
FLOP and MFU arithmetic against float_tpu/utils/flops.py's counts at
config 1, its refusal without a card, ``cli bench``'s dispatch;
float_torch.tools.configs_bench's five configs against
tools/configs_bench.py's parameters, its parsing and its table; and
float_torch.tools.serve_load_bench's base lane against a tiny CPU server.

Nothing here measures: every number of a card comes from a run on the
card (chip_smoke.py).  Every subprocess, request and join has a timeout.
"""
import ast
import dataclasses
import importlib.util
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from float_tpu.config import FloatConfig as JFloatConfig
from float_tpu.utils import flops as j_flops
from float_torch import bench, cli
from float_torch.api.types import FloatPipe
from float_torch.models import init as t_init
from float_torch.runtime.pipeline import build_synthetic_pipeline
from float_torch.tools import configs_bench as cb
from float_torch.tools import serve_load_bench as slb
from float_torch import config as t_config
from torch_parity import TINY, TINY_SER, TINY_W2V

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# float_torch.bench
# ---------------------------------------------------------------------------

def test_clip_flops_match_float_tpu():
    """bench.py counts a clip as the decode's MXU FLOPs a frame times the
    frames plus the sampler's (bench.py:139-153); the port counts the
    same work under its own names."""
    cfg = bench.config1()
    jcfg = JFloatConfig(compute_dtype="bfloat16", decode_batch=24)
    t = 250
    syn = j_flops.synthesis_flops_per_frame(512)
    want = syn["mxu_flops"] * t + j_flops.sampling_flops_per_clip(t, jcfg)
    got = bench.clip_flops(cfg, t)
    assert got["matmul"] == pytest.approx(want, rel=1e-12)
    assert got["decode_matmul_per_frame"] == syn["mxu_flops"]
    assert got["decode_other_per_frame"] == syn["vpu_flops"]


def test_throughput_line_arithmetic():
    cfg = bench.config1()
    secs = [1.2, 0.8, 1.0, 0.9, 1.1]
    info = {"device": "card", "device_count": 1, "power_limit": "700 W"}
    line = bench.throughput_line(secs, cfg, 250, info)
    flops = bench.clip_flops(cfg, 250)["matmul"]
    assert line["metric"] == "e2e_frames_per_sec_512px"
    assert line["vs_baseline"] is None
    assert line["clip_s_median"] == 1.0
    assert (line["clip_s_min"], line["clip_s_max"]) == (0.8, 1.2)
    assert line["value"] == pytest.approx(250.0)
    assert line["mfu"] == pytest.approx(flops / 1.0 / 989.4e12)
    assert line["achieved_tflops"] == pytest.approx(flops / 1e12)
    assert line["gflop_per_frame_decode_matmul"] == pytest.approx(
        j_flops.synthesis_flops_per_frame(512)["mxu_flops"] / 1e9)
    assert line["power_limit"] == "700 W" and line["reps"] == 5
    assert 0 < line["mfu"] < 1


def test_stream_line():
    runs = {"u8": {"ttfc": [0.3, 0.1, 0.2], "total": [2.0, 1.0, 1.5],
                   "frames": 250},
            "yuv420": {"ttfc": [0.2, 0.2, 0.4], "total": [1.0, 1.0, 2.0],
                       "frames": 250}}
    line = bench.stream_line(runs, 8, {"device": "card"})
    assert line["value"] == 0.2 and line["vs_baseline"] is None
    assert line["sustained_fps_u8"] == pytest.approx(250 / 1.5)
    assert line["sustained_fps_yuv420"] == pytest.approx(250.0)
    assert line["first_chunk_frames"] == 8


@pytest.mark.parametrize("extra", [[], ["--stream"]])
def test_bench_refuses_without_a_card(extra):
    """No card: one JSON line with value null and an error, exit 1, and
    no pipeline built (the run takes seconds, not a 617.5 M init)."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "float_torch.bench",
                           *extra], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    (line,) = [json.loads(x) for x in proc.stdout.splitlines()]
    assert line["value"] is None and line["vs_baseline"] is None
    assert "CUDA" in line["error"]
    assert line["metric"] == ("stream_first_chunk_latency_512px" if extra
                              else "e2e_frames_per_sec_512px")


def test_cli_bench_dispatch(monkeypatch):
    seen = []
    monkeypatch.setattr(bench, "main", lambda argv: seen.append(argv) or 0)
    with pytest.raises(SystemExit) as info:
        cli.main(["bench", "--stream", "--reps", "3"])
    assert info.value.code == 0
    with pytest.raises(SystemExit):
        cli.main(["bench"])
    assert seen == [["--reps", "3", "--stream"], ["--reps", "10"]]


# ---------------------------------------------------------------------------
# float_torch.tools.configs_bench
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_configs():
    return _load_reference_tool("configs_bench")


def test_configs_match_tools_configs_bench(reference_configs):
    """The five configs' parameters are tools/configs_bench.py's."""
    snip = reference_configs.SNIPPETS
    assert sorted(cb.CONFIGS) == [1, 2, 3, 4, 5]
    assert sorted(snip) == [2, 3, 4, 5]
    c2 = cb.CONFIGS[2]
    assert (f'emotion="{c2["emotion"]}", seed=15 + i,\n'
            f'                      a_cfg_scale={c2["a_cfg_scale"]}, '
            f'e_cfg_scale={c2["e_cfg_scale"]}') in snip[2]
    for n in (2, 4, 5):
        samples = cb.CONFIGS[n]["seconds"] * cb.SAMPLING_RATE
        assert f"standard_normal((1, {samples}))" in snip[n]
    assert f"standard_normal((1, {60 * cb.SAMPLING_RATE}))" in snip[3]
    assert cb.CONFIGS[3]["seconds"] == 60
    assert re.search(r'for sdt in \("float32", "bfloat16"\)', snip[3])
    assert cb.CONFIGS[3]["sampler_dtypes"] == ("float32", "bfloat16")
    assert (f"win = int({cb.CONFIGS[4]['window_s']} * cfg.sampling_rate)"
            in snip[4])
    boxes = ast.literal_eval(re.search(r"BOXES = (\[.*?\])", snip[5],
                                       re.S).group(1))
    assert boxes == cb.CONFIGS[5]["boxes"] == cb.BOXES
    h, w = cb.CONFIGS[5]["scene"]
    assert f"rng.random(({h}, {w}, 3))" in snip[5]
    src = open(os.path.join(REPO, "tools", "configs_bench.py")).read()
    assert '"desc": "default 10 s / 512²"' in src
    for n in (2, 3, 4, 5):
        assert f'"desc": "{cb.CONFIGS[n]["desc"]}"' in snip[n]


def test_configs_table(reference_configs):
    rows = [{"config": 1, "desc": "default 10 s / 512²", "frames": 250,
             "seconds": 0.91234, "fps": 274.0178, "note": "n1"},
            {"config": 3, "error": ["boom"]}]
    text = cb.table(rows).splitlines()
    src = open(os.path.join(REPO, "tools", "configs_bench.py")).read()
    assert f'"{text[0]}"' in src and f'"{text[1]}"' in src
    assert text[2] == "| 1. default 10 s / 512² | 250 | 0.912 | 274.0 | n1 |"
    assert text[3] == "| 3 | — | — | — | ERROR ['boom'] |"


def test_configs_parse_and_timeout(monkeypatch):
    line = {"value": 270.0, "frames": 250, "clip_s_median": 0.925,
            "clip_s_min": 0.9, "clip_s_max": 1.0, "reps": 3, "mfu": 0.05,
            "weights": "synthetic"}
    row = cb.parse(1, 0, "noise\n" + json.dumps(line) + "\n", "")
    assert (row["fps"], row["seconds"], row["runs"]) == (270.0, 0.925, 3)
    assert "MFU 0.0500" in row["note"]
    row = cb.parse(2, 0, 'x\nRESULT {"config": 2, "fps": 1.0}\n', "")
    assert row == {"config": 2, "fps": 1.0}
    row = cb.parse(4, 1, "", "Traceback\nRuntimeError: boom\n")
    assert row["config"] == 4 and row["error"][-1] == "RuntimeError: boom"
    monkeypatch.setattr(cb, "_command", lambda n, reps: [
        sys.executable, "-c", "import time; time.sleep(30)"])
    row, wall = cb.run_config(2, 1, timeout=1.0)
    assert "timed out" in row["error"][0] and wall < 20


def test_tools_refuse_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cb.main([]) == 1
    assert slb.main([]) == 1
    assert "nothing measured" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# float_torch.tools.serve_load_bench
# ---------------------------------------------------------------------------

def test_serve_load_base_lane_on_cpu():
    """The base and delivered lanes against a TINY CPU server (32
    channels at every image level): two clients of one request each, no
    error, every frame counted."""
    cfg = t_config.FloatConfig(**dataclasses.asdict(TINY))
    w2v = t_config.Wav2Vec2Config(**dataclasses.asdict(TINY_W2V))
    ser = t_config.Wav2Vec2Config(**dataclasses.asdict(TINY_SER))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(t_init, "CHANNELS_MAP",
                       dict.fromkeys(t_init.CHANNELS_MAP, 32))
            pipe = build_synthetic_pipeline(cfg, w2v, ser, device="cpu")
        out = slb.run_load(FloatPipe(pipe, cfg, weights="synthetic"),
                           clip_sec=0.5, reqs=1, timeout=60)
    finally:
        torch.set_num_threads(n)
    frames = math.ceil(0.5 * cfg.fps)
    assert out["errors"] == [] and out["requests"] == 2
    assert out["frames"] == 2 * frames
    assert out["latency_seconds"]["count"] == 2
    assert out["client_med_ttfc_s"] <= out["client_med_stream_s"]
    for enc in ("raw", "jpeg"):
        assert out["delivered"][enc]["frames"] == frames
    assert (out["delivered"]["jpeg"]["wire_kb_per_frame"]
            < out["delivered"]["raw"]["wire_kb_per_frame"])
    assert out["overload"] is None and out["soak"] is None
    assert out["device"] == "cpu"
    assert "| requests (2 clients × 1, 0.5 s clips) | 2 sent, 0 errors |" \
        in slb.table(out, 1)
