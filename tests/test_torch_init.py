"""float_torch.models.init draws float_tpu's synthetic weights bit for bit
without JAX; its trees load into the port's modules with one strict
load_state_dict; the port never imports JAX."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from float_tpu.models import init as j_init
from float_torch.models import init as t_init
from float_torch.runtime.pipeline import FloatPipeline
from torch_parity import TINY, TINY_SER, TINY_W2V

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMPONENTS = {
    "encoder": lambda m: m.init_encoder(64, 64, 20, seed=0),
    "synthesis": lambda m: m.init_synthesis(64, 64, 20, seed=1),
    "wav2vec2": lambda m: m.init_wav2vec2(TINY_W2V, seed=2),
    "ser": lambda m: m.init_wav2vec2(TINY_SER, seed=6),
    "audio_projection": lambda m: m.init_audio_projection(64, 64, seed=3),
    "fmt": lambda m: m.init_fmt(TINY, seed=5),
}


@pytest.mark.parametrize("name", sorted(COMPONENTS))
def test_init_bit_identical(name):
    want = COMPONENTS[name](j_init)
    got = COMPONENTS[name](t_init)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (_, g), (_, w) in zip(got_leaves, want_leaves):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_pipeline_params_load_strict():
    params = t_init.init_pipeline(TINY, TINY_W2V, TINY_SER, seed=0)
    sd = t_init.params_to_state_dict(params)
    skeleton = t_init.empty_pipeline(TINY, TINY_W2V, TINY_SER)
    assert sorted(skeleton.state_dict()) == sorted(sd)
    skeleton.load_state_dict(sd, strict=True)
    assert torch.equal(skeleton["synthesis"]["convs"]["0"]["conv"]["weight"],
                       torch.from_numpy(params["synthesis"]["convs"]["0"]
                                        ["conv"]["weight"]))
    assert "fmt.blocks.1.adaLN_modulation.1.weight" in sd
    assert not any(p.requires_grad for p in skeleton.parameters())


def test_pipeline_refuses_incomplete_params():
    params = t_init.init_pipeline(TINY, TINY_W2V, TINY_SER, seed=0)
    del params["fmt"]["decoder"]["linear"]["bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        FloatPipeline(params, TINY, TINY_W2V, TINY_SER, device="cpu")


def test_synthesis_cast_once():
    pipe = FloatPipeline(t_init.init_pipeline(TINY, TINY_W2V, TINY_SER),
                         TINY.replace(compute_dtype="bfloat16"), TINY_W2V,
                         TINY_SER, device="cpu")
    assert {p.dtype for p in pipe.syn_cast.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in pipe.params.parameters()} == {torch.float32}
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _run_port_code(code: str, timeout: int = 120):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_port_never_imports_jax():
    code = ("import sys, float_torch, float_torch.runtime.pipeline, "
            "float_torch.kernels.warp_shared, float_torch.api.nodes, "
            "float_torch.api.comfy, float_torch.runtime.graph, "
            "float_torch.runtime.workflow, float_torch.io.checkpoint, "
            "float_torch.serve, float_torch.client, float_torch.cli, "
            "float_torch.utils.flops, float_torch.utils.inspect, "
            "float_torch.utils.logging, float_torch.utils.profiling, "
            "float_torch.tools.parity_check, "
            "float_torch.tools.readiness_check, "
            "float_torch.tools.extract_parts, "
            "float_torch.tools.save_combined, "
            "float_torch.tools.check_versions; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'float_tpu')); "
            "assert not bad, bad")
    _run_port_code(code)


def test_cli_serve_client_run_without_jax():
    """``cli --help``, a server with a tiny CPU pipeline answering /health
    and a stream through the port's FloatClient, in one process that
    imports neither JAX nor float_tpu."""
    code = """
import sys, threading
import numpy as np, torch
torch.set_num_threads(1)
from float_torch import cli
try:
    cli.main(["--help"])
except SystemExit as exc:
    assert exc.code == 0
from float_torch.api.types import FloatPipe
from float_torch.client import FloatClient
from float_torch.config import FloatConfig, Wav2Vec2Config
from float_torch.models import init as t_init
from float_torch.runtime.pipeline import build_synthetic_pipeline
from float_torch.serve import make_server
t_init.CHANNELS_MAP = dict.fromkeys(t_init.CHANNELS_MAP, 32)
audio = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3),
             conv_stride=(5, 2, 2), hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
cfg = FloatConfig(input_size=64, dim_w=64, dim_a=64, dim_h=64, dim_m=20,
                  dim_e=7, fmt_depth=2, num_heads=4, wav2vec_sec=0.4,
                  num_prev_frames=3, decode_batch=4, compute_dtype="float32")
pipe = build_synthetic_pipeline(
    cfg, Wav2Vec2Config(**audio, feat_extract_norm="group"),
    Wav2Vec2Config(**audio, feat_extract_norm="layer", conv_bias=True,
                   do_stable_layer_norm=True, num_labels=7), device="cpu")
httpd = make_server(FloatPipe(pipe, cfg, weights="synthetic"), port=0)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
c = FloatClient(f"http://127.0.0.1:{httpd.server_address[1]}")
assert c.health()["device"] == "cpu"
rng = np.random.default_rng(0)
n = sum(f.shape[0] for _, f in c.stream(
    rng.random((64, 64, 3)).astype(np.float32),
    (rng.standard_normal(4000) * 0.1).astype(np.float32)))
httpd.shutdown()
assert n == 7, n
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "float_tpu"))
assert not bad, bad
print("ok", n)
"""
    assert "ok 7" in _run_port_code(code)


# The card's machine has no safetensors, cv2 nor PIL: with the three
# blocked, a tiny unified checkpoint written by the port loads and
# graph_regular.json (VHS_VideoCombine muted) runs on the CPU.
_BLOCKED_PATH = """
import sys
for name in ("safetensors", "cv2", "PIL"):
    sys.modules[name] = None
import json, os, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from float_torch.api.comfy import GraphContext, run_comfy_workflow
from float_torch.config import FloatConfig, Wav2Vec2Config
from float_torch.io.checkpoint import save_safetensors, unified_state_dict
from float_torch.models import init as t_init
from float_torch.models.init import init_pipeline, params_to_state_dict
t_init.CHANNELS_MAP = dict.fromkeys(t_init.CHANNELS_MAP, 32)  # cheap decode
audio = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3),
             conv_stride=(5, 2, 2), hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
w2v = Wav2Vec2Config(**audio, feat_extract_norm="group")
ser = Wav2Vec2Config(**audio, feat_extract_norm="layer", conv_bias=True,
                     do_stable_layer_norm=True, num_labels=7)
cfg = FloatConfig(input_size=64, dim_w=64, dim_a=64, dim_h=64, dim_m=20,
                  dim_e=7, fmt_depth=2, num_heads=4, wav2vec_sec=0.4,
                  num_prev_frames=3, decode_batch=4, compute_dtype="float32")
flat = unified_state_dict(params_to_state_dict(init_pipeline(cfg, w2v, ser)))
with tempfile.TemporaryDirectory() as d:
    os.makedirs(os.path.join(d, "float"))
    save_safetensors(flat, os.path.join(d, "float", "FLOAT.safetensors"))
    rng = np.random.default_rng(0)
    np.save(os.path.join(d, "img.npy"), rng.random((64, 64, 3), np.float32))
    np.save(os.path.join(d, "aud.npy"),
            rng.standard_normal(4000).astype(np.float32) * 0.1)
    wf = json.load(open("example_workflows/graph_regular.json"))
    for node in wf["nodes"]:
        if node["type"] == "VHS_VideoCombine":
            node["mode"] = 2
    ctx = GraphContext(device="cpu", models_root=d, inputs_dir=d,
                       output_dir=d, overrides={
                           "LoadImage": {"image": "img.npy"},
                           "LoadAudio": {"audio": "aud.npy"},
                           "LoadFloatModelsOpt": {"cfg": cfg, "w2v_cfg": w2v,
                                                  "ser_cfg": ser}})
    results, ctx = run_comfy_workflow(wf, ctx)
frames = results["4"][0]
assert frames.shape == (7, 64, 64, 3) and np.isfinite(frames).all()
assert results["3"][0].weights == "real" and not ctx.artifacts
for name in ("safetensors", "cv2", "PIL"):
    assert sys.modules[name] is None, name
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "float_tpu"))
assert not bad, bad
print("ok", frames.shape)
"""


def test_node_path_runs_without_safetensors_cv2_pil():
    assert "ok (7, 64, 64, 3)" in _run_port_code(_BLOCKED_PATH, timeout=300)
