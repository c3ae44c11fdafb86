"""The port's workflow-graph executor (float_torch.runtime.graph +
api.comfy) and JSON workflow runner (runtime.workflow) against
float_tpu's, on the CPU at tests/torch_parity.py's tiny configs.

- The format-level cases of tests/test_graph.py (widget binding, reroute,
  mute and bypass, subgraph flattening, cycles and dangling links), as
  parametrised tests over the port's executor; the flattened
  graph_regular.json equals float_tpu's.
- example_workflows/graph_regular.json end to end: the port reads the
  tiny FLOAT.safetensors through LoadFloatModelsOpt; float_tpu runs its
  tiny pipeline of the same weights.  The five run_workflow configs of
  example_workflows/ (default, emotion, long_audio, dynamic_emotion,
  insert_two_faces) on both packages, with short audio and the
  center-crop face fallback (no face_alignment here).
- GraphContext.device and LoadFloatModelsOpt's target_device widget.

Both samplers draw the same numpy noise (test_torch_nodes.patch_samplers);
the tiny store has 32 channels at every image level.
Tolerance: frames, which both sides round to whole uint8 levels on the
wire, within one level (1/255 + 1e-4); the composited frames of
insert_two_faces also pass through the two packages' resizes (float32,
within 1e-4 of each other) before that rounding."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from float_tpu.api import comfy as j_comfy
from float_tpu.api.types import FloatPipe as JFloatPipe
from float_tpu.io import checkpoint as j_ckpt
from float_tpu.runtime import graph as j_graph
from float_tpu.runtime import pipeline as jp
from float_tpu.runtime.workflow import run_workflow as j_run_workflow
from float_torch.api import comfy as t_comfy
from float_torch.api import nodes as t_nodes
from float_torch.runtime import graph as t_graph
from float_torch.runtime.graph import (MODE_BYPASS, MODE_MUTE, GraphError,
                                       bind_widget_values, flatten_graph,
                                       run_graph)
from float_torch.runtime.workflow import run_workflow as t_run_workflow
from float_torch.models import init as t_init
from test_torch_checkpoint import flatten
from test_torch_nodes import (PT_SER, PT_TINY, PT_W2V, patch_samplers,
                              write_store)
from torch_parity import TINY, TINY_SER, TINY_W2V

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKFLOWS = os.path.join(REPO, "example_workflows")
REGULAR = os.path.join(WORKFLOWS, "graph_regular.json")
FRAME_TOL = 1 / 255 + 1e-4
N_AUDIO = 4000            # 0.25 s at 16 kHz: 7 frames


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


# ---------------------------------------------------------------------------
# format level
# ---------------------------------------------------------------------------

def _widget(name, link=None):
    return {"name": name, "widget": {"name": name}, "link": link}


BIND_CASES = {
    "list_with_seed_control": (
        {"inputs": [_widget("a_cfg_scale"), _widget("seed"), _widget("fps"),
                    {"name": "ref_image", "link": 3}],
         "widgets_values": [2.0, 15, "fixed", 25.0]},
        {"a_cfg_scale": 2.0, "seed": 15, "fps": 25.0}),
    "dict_form": (
        {"inputs": [_widget("frame_rate"), _widget("format")],
         "widgets_values": {"frame_rate": 25, "format": "video/mp4",
                            "extra_ui_state": {"x": 1}}},
        {"frame_rate": 25, "format": "video/mp4"}),
    "short_values": (
        {"inputs": [_widget("a"), _widget("b")], "widgets_values": [1]},
        {"a": 1}),
}


@pytest.mark.parametrize("case", sorted(BIND_CASES))
def test_bind_widget_values(case):
    node, want = BIND_CASES[case]
    assert bind_widget_values(node) == want == j_graph.bind_widget_values(
        node)


def _prim(nid, value=None, link=None, mode=0):
    return {"id": nid, "type": "PrimitiveFloat", "mode": mode,
            "inputs": [_widget("value", link)],
            "outputs": [{"name": "FLOAT", "type": "FLOAT"}],
            "widgets_values": [] if value is None else [value]}


def _reroute(nid, link_in):
    return {"id": nid, "type": "Reroute", "mode": 0,
            "inputs": [{"name": "", "link": link_in}],
            "outputs": [{"name": ""}]}


ERROR_CASES = {
    "unknown_node_type": (
        {"nodes": [{"id": 1, "type": "NoSuchNode", "inputs": [],
                    "outputs": [], "mode": 0}], "links": []}, "NoSuchNode"),
    "cycle": (
        {"nodes": [{"id": 1, "type": "PrimitiveFloat", "mode": 0,
                    "inputs": [{"name": "value", "link": 1}],
                    "outputs": [{"name": "y"}]},
                   {"id": 2, "type": "PrimitiveFloat", "mode": 0,
                    "inputs": [{"name": "value", "link": 2}],
                    "outputs": [{"name": "y"}]}],
         "links": [[1, 2, 0, 1, 0, "*"], [2, 1, 0, 2, 0, "*"]]}, "cycle"),
    "reroute_cycle": (
        {"nodes": [_reroute(1, 2), _reroute(2, 1), _prim(3, link=3)],
         "links": [[1, 2, 0, 1, 0, "*"], [2, 1, 0, 2, 0, "*"],
                   [3, 1, 0, 3, 0, "*"]]}, "cycle"),
    "dangling_link": (
        {"nodes": [_reroute(1, 99), _prim(3, link=3)],
         "links": [[3, 1, 0, 3, 0, "*"]]}, "link 99"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_malformed_graphs_raise(case):
    wf, match = ERROR_CASES[case]
    with pytest.raises(GraphError, match=match):
        run_graph(wf, t_comfy.ADAPTERS, t_comfy.GraphContext(device="cpu"))


def _subgraph_wf(mode):
    sg = {"id": "aaaa", "name": "wrap", "inputNode": {"id": -10},
          "outputNode": {"id": -20},
          "inputs": [{"name": "x", "type": "FLOAT"}],
          "outputs": [{"name": "y", "type": "FLOAT"}],
          "nodes": [{"id": 5, "type": "ExplodingNode", "mode": 0,
                     "inputs": [{"name": "x", "link": 0}],
                     "outputs": [{"name": "y"}]}],
          "links": [{"id": 0, "origin_id": -10, "origin_slot": 0,
                     "target_id": 5, "target_slot": 0, "type": "FLOAT"},
                    {"id": 1, "origin_id": 5, "origin_slot": 0,
                     "target_id": -20, "target_slot": 0, "type": "FLOAT"}]}
    return {"definitions": {"subgraphs": [sg]},
            "nodes": [_prim(1, 7.0),
                      {"id": 2, "type": "aaaa", "mode": mode,
                       "inputs": [{"name": "x", "link": 1, "type": "FLOAT"}],
                       "outputs": [{"name": "y", "type": "FLOAT",
                                    "links": [2]}]},
                      _prim(3, link=2)],
            "links": [[1, 1, 0, 2, 0, "FLOAT"], [2, 2, 0, 3, 0, "FLOAT"]]}


RUN_CASES = {
    # (workflow, key of the node read, its outputs)
    "reroute_passthrough": (
        {"nodes": [_prim(1, 3.5), _reroute(2, 1), _prim(3, link=2)],
         "links": [[1, 1, 0, 2, 0, "FLOAT"], [2, 2, 0, 3, 0, "FLOAT"]]},
        "3", [3.5]),
    "converted_widget_prefers_link": (
        {"nodes": [_prim(1, 30.0), _prim(2, 25.0, link=1)],
         "links": [[1, 1, 0, 2, 0, "FLOAT"]]}, "2", [30.0]),
    "mute_propagates_none": (
        {"nodes": [_prim(1, 4.0, mode=MODE_MUTE), _prim(2, link=1)],
         "links": [[1, 1, 0, 2, 0, "FLOAT"]]}, "2", [0.0]),
    "muted_subgraph_instance": (_subgraph_wf(MODE_MUTE), "3", [0.0]),
    "bypassed_subgraph_instance": (_subgraph_wf(MODE_BYPASS), "3", [7.0]),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_graph_execution_semantics(case):
    """Each case runs on both executors with the same results; a muted or
    bypassed subgraph instance never expands its body."""
    wf, key, want = RUN_CASES[case]
    assert run_graph(wf, t_comfy.ADAPTERS,
                     t_comfy.GraphContext(device="cpu"))[key] == want
    assert j_graph.run_graph(wf, j_comfy.ADAPTERS,
                             j_comfy.GraphContext())[key] == want
    nodes = flatten_graph(wf)
    assert not any(n.type in ("ExplodingNode", "Reroute")
                   for n in nodes.values())


@pytest.mark.parametrize("name", ["graph_regular.json", "subgraph"])
def test_flatten_matches_float_tpu(name):
    wf = (json.load(open(REGULAR)) if name == "graph_regular.json"
          else _subgraph_wf(0))
    got = {k: dataclasses.asdict(n) for k, n in flatten_graph(wf).items()}
    want = {k: dataclasses.asdict(n)
            for k, n in j_graph.flatten_graph(wf).items()}
    assert got == want
    assert t_graph._toposort(flatten_graph(wf)) == j_graph._toposort(
        j_graph.flatten_graph(wf))


def test_adapters_cover_float_tpu(monkeypatch):
    """The same 39 node types; FloatImageFaceAlign reads the 'index'
    widget (the two-face insert workflows use index=2)."""
    assert sorted(t_comfy.ADAPTERS) == sorted(j_comfy.ADAPTERS)
    assert len(t_comfy.ADAPTERS) == 39
    assert len(set(t_comfy.ADAPTERS.values())) == 37
    seen = {}

    def fake(image, **kw):
        seen.update(kw)
        return np.zeros((1, 4, 4, 3), np.float32), [(0, 0, 4, 4)]
    monkeypatch.setattr(t_nodes, "float_image_face_align", fake)
    t_comfy.ADAPTERS["FloatImageFaceAlign"](
        t_comfy.GraphContext(device="cpu"),
        {"image": np.zeros((1, 8, 8, 3)), "index": 2, "size": 64})
    assert seen["face_index"] == 2 and seen["input_size"] == 64


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_store(tmp_path_factory.mktemp("store"),
                       t_init.init_pipeline(PT_TINY, PT_W2V, PT_SER, seed=0))


@pytest.fixture(scope="module")
def io_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("graph_io")
    rng = np.random.default_rng(7)
    np.save(d / "img.npy", rng.random((64, 64, 3)).astype(np.float32))
    np.save(d / "aud.npy",
            (rng.standard_normal(N_AUDIO) * 0.1).astype(np.float32))
    return d


@pytest.fixture(scope="module")
def jax_pipe(store):
    params = j_ckpt.load_unified_checkpoint(
        str(store / "float" / "FLOAT.safetensors"))
    return JFloatPipe(jp.FloatPipeline(params, TINY, TINY_W2V, TINY_SER),
                      TINY, weights="real")


@pytest.fixture(scope="module")
def port_pipe(store):
    return t_nodes.load_float_models(
        str(store / "float" / "FLOAT.safetensors"), target_device="cpu",
        cfg=PT_TINY, w2v_cfg=PT_W2V, ser_cfg=PT_SER)


IO_OVERRIDES = {"LoadImage": {"image": "img.npy"},
                "LoadAudio": {"audio": "aud.npy"}}


def test_graph_regular_matches_float_tpu(store, io_dir, jax_pipe, tmp_path):
    """The port loads FLOAT.safetensors through LoadFloatModelsOpt (the
    bundled widget says "tpu": the context's device, the CPU here) and
    writes the VHS_VideoCombine mp4."""
    ctx = t_comfy.GraphContext(
        device="cpu", models_root=str(store), inputs_dir=str(io_dir),
        output_dir=str(tmp_path / "t"),
        overrides=dict(IO_OVERRIDES, LoadFloatModelsOpt={
            "cfg": PT_TINY, "w2v_cfg": PT_W2V, "ser_cfg": PT_SER}))
    jctx = j_comfy.GraphContext(inputs_dir=str(io_dir),
                                output_dir=str(tmp_path / "j"),
                                float_pipe=jax_pipe, overrides=IO_OVERRIDES)
    with pytest.MonkeyPatch.context() as mp:
        patch_samplers(mp)
        got, ctx = t_comfy.run_comfy_workflow(REGULAR, ctx)
        want, _ = j_comfy.run_comfy_workflow(REGULAR, jctx)
    pipe = got["3"][0]
    assert pipe.weights == "real" and pipe.pipeline.device.type == "cpu"
    frames = got["4"][0]
    assert isinstance(frames, np.ndarray) and frames.shape == (7, 64, 64, 3)
    assert np.abs(frames - np.asarray(want["4"][0])).max() <= FRAME_TOL
    assert got["4"][2] == want["4"][2] == 25.0
    assert len(ctx.artifacts) == 1 and ctx.artifacts[0].endswith(".mp4")
    assert os.path.getsize(ctx.artifacts[0]) > 0


def _workflow(name, img, wave):
    with open(os.path.join(WORKFLOWS, name + ".json")) as f:
        wf = json.load(f)
    wf.update(image=img, audio=wave, face_align="fallback")
    if name == "insert_two_faces":
        wf["image"] = np.random.default_rng(3).random(
            (80, 100, 3)).astype(np.float32)
    return wf


@pytest.mark.parametrize("name", ["default", "emotion", "long_audio",
                                  "dynamic_emotion", "insert_two_faces"])
def test_run_workflow_matches_float_tpu(name, io_dir, jax_pipe, port_pipe):
    img = np.load(io_dir / "img.npy")
    wave = np.load(io_dir / "aud.npy")
    with pytest.MonkeyPatch.context() as mp:
        patch_samplers(mp)
        got = t_run_workflow(_workflow(name, img, wave), output="",
                             pipe=port_pipe)
        want = j_run_workflow(_workflow(name, img, wave), output="",
                              pipe=jax_pipe)
    assert got.shape == want.shape
    assert got.shape[0] == 7 and got.shape[-1] == 3
    assert np.abs(got - np.asarray(want)).max() <= FRAME_TOL


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

LOADER_ONLY = {"nodes": [n for n in json.load(open(REGULAR))["nodes"]
                         if n["type"] == "LoadFloatModelsOpt"], "links": []}


@pytest.mark.parametrize("ctx_device,widget", [
    ("cpu", "tpu"), ("cpu", "cuda"), ("cuda", "cpu"), ("cuda", "tpu")])
def test_target_device_mapping(store, ctx_device, widget):
    """A "cpu" widget or a CPU context runs the pipe on the CPU; otherwise
    it goes to the card, and without one the node fails instead of
    falling back to the CPU."""
    wf = json.loads(json.dumps(LOADER_ONLY))
    wf["nodes"][0]["widgets_values"][1] = widget
    ctx = t_comfy.GraphContext(
        device=ctx_device, models_root=str(store),
        overrides={"LoadFloatModelsOpt": {"cfg": PT_TINY, "w2v_cfg": PT_W2V,
                                          "ser_cfg": PT_SER}})
    on_cpu = "cpu" in (ctx_device, widget)
    if on_cpu or torch.cuda.is_available():
        results, _ = t_comfy.run_comfy_workflow(wf, ctx)
        assert results["3"][0].pipeline.device.type == (
            "cpu" if on_cpu else "cuda")
    else:
        with pytest.raises(GraphError, match="CUDA"):
            t_comfy.run_comfy_workflow(wf, ctx)


# ---------------------------------------------------------------------------
# the Very Advanced loaders through their adapters, and the model store
# ---------------------------------------------------------------------------

LOADERS = ("LoadWav2VecModel", "LoadAudioProjectionLayer",
           "LoadEmotionRecognitionModel", "LoadFloatEncoderModel",
           "LoadFloatSynthesisModel", "LoadFMTModel")


@pytest.fixture(scope="module")
def bare_store(store, tmp_path_factory):
    """Only FLOAT.safetensors and the HF folders: each loader adapter cuts
    its part file from the unified file on first use."""
    root = tmp_path_factory.mktemp("bare")
    (root / "float").mkdir()
    (root / "float" / "FLOAT.safetensors").symlink_to(
        store / "float" / "FLOAT.safetensors")
    (root / "audio").symlink_to(store / "audio")
    return root


def _outputs(values):
    """Adapter outputs as comparable values: a model pipe -> its
    parameters and plain fields."""
    out = []
    for v in values:
        if dataclasses.is_dataclass(v):
            fields = {}
            for f in dataclasses.fields(v):
                x = getattr(v, f.name)
                if f.name == "params":
                    x = (x.state_dict() if isinstance(x, torch.nn.Module)
                         else flatten(x))
                    x = {k: np.asarray(t, dtype=np.float32)
                         for k, t in x.items()}
                elif dataclasses.is_dataclass(x):
                    x = dataclasses.asdict(x)
                fields[f.name] = x
            v = fields
        out.append(v)
    return out


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(map(str, got)) == sorted(map(str, want)), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("node_type", LOADERS)
def test_loader_adapters_match_float_tpu(node_type, bare_store):
    """Default widgets and model-store resolution: the port's adapter cuts
    a missing part file from the unified file with its own writer, and
    float_tpu's then reads that file with the safetensors package; the
    outputs are equal."""
    ctx = t_comfy.GraphContext(device="cpu", models_root=str(bare_store))
    jctx = j_comfy.GraphContext(models_root=str(bare_store))
    got = _outputs(t_comfy.ADAPTERS[node_type](ctx, {}))
    want = _outputs(j_comfy.ADAPTERS[node_type](jctx, {}))
    _assert_same(got, want)


def test_model_store_discovery_matches_float_tpu(store):
    from float_tpu.io import download as j_dl
    from float_torch.io import download as t_dl
    root = str(store)
    for mod in (t_dl, j_dl):
        assert mod.look_for_models(root, "float/fmt", "fmt.safetensors") \
            == ["fmt.safetensors"]
    assert t_dl.look_for_models(root, "float/motion_autoencoder",
                                "encoder.safetensors") == \
        j_dl.look_for_models(root, "float/motion_autoencoder",
                             "encoder.safetensors") == \
        ["encoder.safetensors", "decoder.safetensors"]
    assert t_dl.look_for_model_dirs(root, "audio", "wav2vec2-base-960h") == \
        j_dl.look_for_model_dirs(root, "audio", "wav2vec2-base-960h") == \
        ["wav2vec2-base-960h", "wav2vec-english-speech-emotion-recognition"]
    assert t_dl.resolve_model_path(root, "float/fmt", "x") == \
        j_dl.resolve_model_path(root, "float/fmt", "x")
    assert t_dl.EXTRACTION_PREFIXES == j_dl.EXTRACTION_PREFIXES
    assert t_dl.MODEL_PART_URLS == j_dl.MODEL_PART_URLS
