"""The port's serving daemon (float_torch.serve, float_torch.client) on the
CPU at tests/torch_parity.py's tiny configs, 32 channels at every image
level, one torch thread, 1 s of audio.  The weights are float_tpu's tiny
synthetic pipeline's, carried into the port through params_to_state_dict.

- Against the reference: the same raw-stream request to float_tpu's
  ``FloatServer.iter_generate_stream`` and to the port's, the chunk noise
  pinned to one numpy array on both sides (float_tpu's
  ``sampling.chunk_noise`` and the port's ``sample_motion_chunks`` as
  ``runtime.pipeline`` calls it):
  the same lines (starts, shapes) and frames within one uint8 level.  The
  same for ``handle_generate_batch``'s frame counts, clip order and frames
  (both samplers patched to one numpy noise, tests/test_torch_nodes.py's
  ``patch_samplers``).
- Against its own pipeline: the raw stream is ``generate``'s uint8.
- The server's behaviours of tests/test_serve.py, each a case of one
  parametrised test.
"""
import base64
import concurrent.futures as cf
import dataclasses
import http.client
import io
import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from float_tpu import serve as j_serve
from float_tpu.api.types import FloatPipe as JFloatPipe
from float_tpu.models import init as j_init
from float_tpu.runtime import pipeline as jp
from float_tpu.runtime import sampling as j_sampling
from float_torch import config as t_config
from float_torch import serve as t_serve
from float_torch.api.nodes import comfy_image_to_model_input, normalize_waveform
from float_torch.api.types import FloatPipe
from float_torch.client import FloatClient, _decode_chunk_msg, _jpeg_to_rgb
from float_torch.models import init as t_init
from float_torch.ops.yuv420 import i420_to_rgb_u8
from float_torch.runtime import pipeline as t_pipeline
from float_torch.runtime.pipeline import FloatPipeline
from test_torch_nodes import patch_samplers
from torch_parity import TINY, TINY_SER, TINY_W2V

PT_TINY = t_config.FloatConfig(**dataclasses.asdict(TINY))
PT_W2V = t_config.Wav2Vec2Config(**dataclasses.asdict(TINY_W2V))
PT_SER = t_config.Wav2Vec2Config(**dataclasses.asdict(TINY_SER))
FRAME_TOL = 1 / 255 + 1e-4      # one uint8 level, for float frames
N_CHUNKS = 3                    # 1 s at 25 fps in 10-frame sampler chunks


@pytest.fixture(scope="module")
def pipes():
    """(float_tpu's FloatPipe, the port's FloatPipe on the CPU) with the
    same weights: float_tpu's tiny synthetic pipeline, 32 channels at every
    image level."""
    narrow = dict.fromkeys(j_init.CHANNELS_MAP, 32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_init, "CHANNELS_MAP", narrow)
        mp.setattr(t_init, "CHANNELS_MAP", narrow)
        jpl = jp.build_synthetic_pipeline(TINY, TINY_W2V, TINY_SER)
        tpl = FloatPipeline(jax.tree.map(np.asarray, jpl.params), PT_TINY,
                            PT_W2V, PT_SER, device="cpu")
    return (JFloatPipe(jpl, TINY, weights="synthetic"),
            FloatPipe(tpl, PT_TINY, weights="synthetic"))


@pytest.fixture(scope="module")
def fpipe(pipes):
    return pipes[1]


def _serve(pipe, **opts):
    httpd = t_serve.make_server(pipe, host="127.0.0.1", port=0, **opts)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server(fpipe):
    httpd, url = _serve(fpipe)
    yield url
    httpd.shutdown()
    httpd.server_close()


def _npy_b64(arr) -> str:
    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode()


def _post(url, obj, timeout=120):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _http_error(fn) -> urllib.error.HTTPError:
    with pytest.raises(urllib.error.HTTPError) as info:
        fn()
    return info.value


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(11)
    return (rng.random((64, 64, 3)).astype(np.float32),
            (rng.standard_normal(16000) * 0.1).astype(np.float32))


@pytest.fixture(scope="module")
def payload(arrays):
    img, aud = arrays
    return {"image": _npy_b64(img), "audio": _npy_b64(aud), "seed": 15}


def _frames(lines) -> np.ndarray:
    return np.concatenate([_decode_chunk_msg(json.loads(line))
                           for line in lines])


def _meta(lines) -> list:
    return [(m["start"], m["shape"]) for m in map(json.loads, lines)]


# ---------------------------------------------------------------------------
# against float_tpu's server
# ---------------------------------------------------------------------------

STREAM_NOISE = np.random.default_rng(5).standard_normal(
    (N_CHUNKS, 1, TINY.num_frames_for_clip, TINY.dim_w)).astype(np.float32)


def _pinned_chunk_noise(key, c, b, cfg, dtype=jnp.float32):
    return jnp.asarray(STREAM_NOISE[c]).astype(dtype)


@pytest.fixture(scope="module")
def reference_stream(pipes, payload):
    """float_tpu's server streams the request once for the module (its
    jitted programs compile once), its chunk noise pinned."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_sampling, "chunk_noise", _pinned_chunk_noise)
        srv = j_serve.FloatServer(pipes[0])
        return list(srv.iter_generate_stream(
            dict(payload, stream=True, first_chunk=4)))


def test_stream_matches_reference_server(pipes, payload, reference_stream):
    tpipe = pipes[1]
    orig = t_pipeline.sample_motion_chunks
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_pipeline, "sample_motion_chunks",
                   lambda **kw: orig(**dict(kw, noise=STREAM_NOISE)))
        got = list(t_serve.FloatServer(tpipe).iter_generate_stream(
            dict(payload, stream=True, first_chunk=4)))
    assert _meta(got) == _meta(reference_stream)
    assert [m for m, _ in _meta(got)] == [0, 4, 8, 12, 16, 20, 24]
    a, b = _frames(got), _frames(reference_stream)
    assert a.shape == b.shape == (25, 64, 64, 3) and a.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def _batch_request(arrays):
    img, aud = arrays
    half = (np.random.default_rng(4).standard_normal(8000) * 0.1
            ).astype(np.float32)
    return {"clips": [{"image": _npy_b64(img), "audio": _npy_b64(aud)},
                      {"image": _npy_b64(img[::-1].copy()),
                       "audio": _npy_b64(half), "seed": 40},
                      {"image": _npy_b64(img), "audio": _npy_b64(aud * 0.5)}],
            "seed": 20}


def _spy_batch(mp, pipeline) -> list:
    """Record what ``pipeline.generate_batch`` returns to the server."""
    got = []
    orig = pipeline.generate_batch

    def spy(*args, **kw):
        out = orig(*args, **kw)
        got.append([np.asarray(o) for o in out])
        return out

    mp.setattr(pipeline, "generate_batch", spy)
    return got


@pytest.fixture(scope="module")
def reference_batch(pipes, arrays):
    with pytest.MonkeyPatch.context() as mp:
        patch_samplers(mp)
        frames = _spy_batch(mp, pipes[0].pipeline)
        out = j_serve.FloatServer(pipes[0]).handle_generate_batch(
            _batch_request(arrays))
    return out, frames[0]


def test_batch_matches_reference_server(pipes, arrays, reference_batch):
    """Frame counts, clip order (ragged: 1 s, 0.5 s, 1 s) and each clip's
    frames as the server encodes them."""
    want, want_frames = reference_batch
    with pytest.MonkeyPatch.context() as mp:
        patch_samplers(mp)
        frames = _spy_batch(mp, pipes[1].pipeline)
        got = t_serve.FloatServer(pipes[1]).handle_generate_batch(
            _batch_request(arrays))
    counts = [c["frames"] for c in got["clips"]]
    assert counts == [c["frames"] for c in want["clips"]] == [25, 13, 25]
    assert [sorted(c) for c in got["clips"]] == \
        [sorted(c) for c in want["clips"]]
    assert [len(c["video"]) > 1000 for c in got["clips"]] == [True] * 3
    for a, b in zip(frames[0], want_frames):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= FRAME_TOL


# ---------------------------------------------------------------------------
# against its own pipeline
# ---------------------------------------------------------------------------

def _model_inputs(arrays):
    img, aud = arrays
    model_in, _ = comfy_image_to_model_input(img, 64)
    return model_in, normalize_waveform(aud)[None]


def _jpeg_roundtrip(u8, quality) -> np.ndarray:
    """(k, S, S, 3) uint8 through the server's JPEG encoder and the
    client's decoder."""
    return np.stack([_jpeg_to_rgb(b)
                     for b in t_serve._jpeg_encode_frames(u8, quality)])


def _jpeg_stream_reference(fpipe, arrays, quality) -> np.ndarray:
    """What a JPEG stream must deliver: the in-process yuv420-wire stream
    of the same request, encoded and decoded by the same codec."""
    yuv = np.concatenate([f for _, f in fpipe.pipeline.generate_stream(
        *_model_inputs(arrays), seed=15, first_chunk=8, wire="yuv420")])
    return _jpeg_roundtrip(i420_to_rgb_u8(yuv), quality)


def test_stream_equals_generate(fpipe, arrays, payload):
    """The raw stream's frames are ``generate``'s on the same inputs and
    seed, rounded to uint8 (the generator draws the same noise)."""
    lines = list(t_serve.FloatServer(fpipe).iter_generate_stream(
        dict(payload, stream=True)))
    ref = fpipe.pipeline.generate(*_model_inputs(arrays), seed=15).numpy()
    got = _frames(lines)
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - np.round(ref * 255.0)).max() <= 1


# ---------------------------------------------------------------------------
# the server's behaviours (tests/test_serve.py on the port)
# ---------------------------------------------------------------------------

GRAPH = {"nodes": [
    {"id": 1, "type": "LoadImage", "mode": 0,
     "inputs": [{"name": "image", "widget": {"name": "image"}}],
     "outputs": [{"name": "IMAGE"}, {"name": "MASK"}],
     "widgets_values": ["img.npy"]},
    {"id": 2, "type": "PreviewImage", "mode": 0,
     "inputs": [{"name": "images", "link": 1}], "outputs": []}],
    "links": [[1, 1, 0, 2, 0, "IMAGE"]]}


def _mp4_frames(video: bytes) -> int:
    import cv2
    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
        f.write(video)
    try:
        cap = cv2.VideoCapture(f.name)
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        return n
    finally:
        os.unlink(f.name)


def case_health(fpipe, server, payload, arrays):
    with urllib.request.urlopen(server + "/health", timeout=30) as r:
        body = json.loads(r.read())
    assert body == {"status": "ok", "device": "cpu", "device_name": "cpu",
                    "weights": "synthetic", "busy": False, "mesh": None}


def case_generate_mp4(fpipe, server, payload, arrays):
    with _post(server + "/v1/generate", payload) as r:
        assert r.headers["Content-Type"] == "video/mp4"
        assert int(r.headers["X-Frames"]) == 25      # 1 s @ 25 fps
        video = r.read()
    assert _mp4_frames(video) == 25


def case_stream_ndjson(fpipe, server, payload, arrays):
    starts, total = [], 0
    with _post(server + "/v1/generate", dict(payload, stream=True)) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        for line in r:
            msg = json.loads(line)
            arr = _decode_chunk_msg(msg)
            assert arr.shape[1:] == (64, 64, 3) and msg["dtype"] == "uint8"
            starts.append(msg["start"])
            total += arr.shape[0]
    assert total == 25 and starts == sorted(starts) and starts[0] == 0


def case_stream_jpeg(fpipe, server, payload, arrays):
    """encoding="jpeg" delivers the 4:2:0-wire frames JPEG-encoded at the
    asked quality (equal to that codec's round trip in process) in far
    fewer bytes than raw; starts and shapes identical."""
    with _post(server + "/v1/generate", dict(payload, stream=True)) as r:
        raw = list(r)
    with _post(server + "/v1/generate", dict(payload, stream=True,
                                             encoding="jpeg",
                                             quality=92)) as r:
        jpg = list(r)
    assert _meta(raw) == _meta(jpg)
    assert all(json.loads(j)["encoding"] == "jpeg" for j in jpg)
    np.testing.assert_array_equal(_frames(jpg),
                                  _jpeg_stream_reference(fpipe, arrays, 92))
    assert sum(map(len, jpg)) < 0.5 * sum(map(len, raw))


def case_bad_request_400(fpipe, server, payload, arrays):
    for body in ({"image": "not-base64!!", "audio": payload["audio"]},
                 {"audio": payload["audio"]},
                 dict(payload, stream=True, encoding="webp"),
                 dict(payload, encoding="jpeg", quality=0,
                      clips=[{"image": payload["image"],
                              "audio": payload["audio"]}])):
        path = "/v1/generate_batch" if "clips" in body else "/v1/generate"
        e = _http_error(lambda: _post(server + path, body))
        assert e.code == 400 and "error" in json.loads(e.read())


def case_unknown_path_404(fpipe, server, payload, arrays):
    assert _http_error(lambda: _post(server + "/v1/nope", {})).code == 404
    e = _http_error(lambda: urllib.request.urlopen(server + "/nope",
                                                   timeout=30))
    assert e.code == 404


def case_oversized_body_413(fpipe, server, payload, arrays):
    httpd, url = _serve(fpipe)
    httpd.RequestHandlerClass.MAX_BODY = 100
    try:
        e = _http_error(lambda: _post(url + "/v1/generate", payload))
        assert e.code == 413
    finally:
        httpd.shutdown()
        httpd.server_close()


def case_busy_503_retry_after(fpipe, server, payload, arrays):
    httpd, url = _serve(fpipe, max_pending=0)
    try:
        e = _http_error(lambda: _post(url + "/v1/generate", payload))
        assert e.code == 503 and int(e.headers["Retry-After"]) >= 1
        assert "busy" in json.loads(e.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def case_busy_saturation(fpipe, server, payload, arrays):
    srv = t_serve.FloatServer(fpipe, max_pending=1)
    with srv._admit():
        with pytest.raises(t_serve._Busy):
            srv.handle_generate(payload)
    assert srv.metrics()["rejected_busy"] == 1
    _video, n = srv.handle_generate(payload)
    assert n == 25


def case_stalled_reader_aborts(fpipe, server, payload, arrays):
    """A consumer that stops reading with a full buffer gets its
    generation aborted after the stall timeout and the lock is freed.
    Budget 0.06 MB < one 4-frame line: one line queued at most."""
    srv = t_serve.FloatServer(fpipe, max_pending=2, stream_buffer_mb=0.06,
                              stream_stall_timeout=0.5)
    it = iter(srv.stream_generate(dict(payload, stream=True)))
    assert json.loads(next(it))["start"] == 0
    deadline = time.time() + 60
    while srv.metrics()["stream_aborts"] == 0 and time.time() < deadline:
        time.sleep(0.05)
    assert srv.metrics()["stream_aborts"] == 1
    assert not srv.lock.locked(), "abort must release the generation lock"
    got = 0
    with pytest.raises(t_serve._ReaderStalled):
        for _line in it:
            got += 1
    assert got <= 2
    _video, n = srv.handle_generate(payload)
    assert n == 25


def case_slow_reader_with_progress_not_aborted(fpipe, server, payload,
                                               arrays):
    """The stall deadline measures consumer progress: a reader that keeps
    draining is never aborted; one that stops is."""
    line = b"x" * 100
    buf = t_serve._StreamBuffer(budget_bytes=150, stall_timeout=0.4)
    errs = []

    def producer(b, close):
        try:
            for _ in range(6):
                b.put(line)
            if close:
                b.close()
        except BaseException as exc:    # noqa: BLE001
            errs.append(exc)
            b.close(exc)

    t = threading.Thread(target=producer, args=(buf, True))
    t.start()
    it = iter(buf)
    for _ in range(6):
        next(it)
        time.sleep(0.3)
    t.join(timeout=10)
    assert not t.is_alive() and not errs
    buf2 = t_serve._StreamBuffer(budget_bytes=150, stall_timeout=0.4)
    t2 = threading.Thread(target=producer, args=(buf2, False))
    t2.start()
    t2.join(timeout=10)
    assert not t2.is_alive()
    assert errs and isinstance(errs[0], t_serve._ReaderStalled)


def case_slow_reader_does_not_block_others(fpipe, server, payload, arrays):
    """Client A reads one line and pauses; client B's generate completes
    meanwhile; A then drains its whole stream."""
    host, port = server.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    conn.request("POST", "/v1/generate",
                 body=json.dumps(dict(payload, stream=True)),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    lines = [resp.readline()]
    assert json.loads(lines[0])["start"] == 0
    with _post(server + "/v1/generate", payload) as r:
        assert int(r.headers["X-Frames"]) == 25
        r.read()
    lines += [line for line in resp if line.strip()]
    conn.close()
    assert _frames(lines).shape[0] == 25


def case_concurrent_requests_serialize(fpipe, server, payload, arrays):
    with cf.ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(lambda: _post(server + "/v1/generate",
                                        payload).read())
                for _ in range(2)]
        with urllib.request.urlopen(server + "/health", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        videos = [f.result() for f in futs]
    assert videos[0] == videos[1] and len(videos[0]) > 1000


def case_concurrent_batches_distinct(fpipe, server, payload, arrays):
    """Overlapping batch requests keep their own clip files: each equals
    its serial reference and the output directory is left empty."""
    def req(seed):
        return {"clips": [{"image": payload["image"],
                           "audio": payload["audio"], "seed": seed},
                          {"image": payload["image"],
                           "audio": payload["audio"], "seed": seed + 1}]}

    srv = t_serve.FloatServer(fpipe, max_pending=4)
    ref_a = srv.handle_generate_batch(req(15))
    ref_b = srv.handle_generate_batch(req(40))
    with cf.ThreadPoolExecutor(2) as ex:
        fa = ex.submit(srv.handle_generate_batch, req(15))
        fb = ex.submit(srv.handle_generate_batch, req(40))
        got_a, got_b = fa.result(), fb.result()
    assert got_a == ref_a and got_b == ref_b
    assert got_a["clips"][0]["video"] != got_b["clips"][0]["video"]
    assert os.listdir(srv.output_dir) == []


def case_metrics(fpipe, server, payload, arrays):
    """A fresh server's counters equal what was sent: 3 requests, 25 + 25
    + (25 + 13) frames."""
    httpd, url = _serve(fpipe)
    try:
        c = FloatClient(url)
        c.generate(*arrays)
        assert sum(f.shape[0] for _, f in c.stream(*arrays)) == 25
        c.generate_batch([{"image": arrays[0], "audio": arrays[1]},
                          {"image": arrays[0], "audio": arrays[1][:8000]}])
        deadline = time.time() + 10
        while (c.metrics()["latency_seconds"] or {}).get("count", 0) < 3 \
                and time.time() < deadline:
            time.sleep(0.02)
        m = c.metrics()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert (m["requests"], m["errors"], m["frames"]) == (3, 0, 88)
    assert m["rejected_busy"] == m["stream_aborts"] == m["queue_depth"] == 0
    assert m["busy_seconds"] > 0
    assert m["frames_per_busy_second"] == round(88 / m["busy_seconds"], 2)
    lat = m["latency_seconds"]
    assert lat["count"] == 3
    assert 0 <= lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]
    assert m["lock_wait_seconds"]["count"] == 3


def case_graph_endpoint(fpipe, server, payload, arrays):
    body = {"workflow": GRAPH, "inputs": {"img.npy": payload["image"]}}
    with _post(server + "/v1/graph", body) as r:
        out = json.loads(r.read())
    (b64,) = out["artifacts"].values()
    assert np.load(io.BytesIO(base64.b64decode(b64))).shape == (1, 64, 64, 3)


def case_client_roundtrip(fpipe, server, payload, arrays):
    img, aud = arrays
    c = FloatClient(server)
    assert c.health()["status"] == "ok" and "requests" in c.metrics()
    assert _mp4_frames(c.generate(img, aud, seed=15)) == 25
    raw = np.concatenate([f for _, f in c.stream(img, aud, seed=15)])
    assert raw.dtype == np.uint8 and raw.shape == (25, 64, 64, 3)
    jpg = np.concatenate([f for _, f in c.stream(img, aud, seed=15,
                                                 encoding="jpeg",
                                                 quality=80)])
    np.testing.assert_array_equal(jpg,
                                  _jpeg_stream_reference(fpipe, arrays, 80))
    out = c.generate_batch([{"image": img, "audio": aud, "seed": 15}],
                           encoding="jpeg", quality=92)
    assert out[0]["frames"] == 25 and out[0]["images"].shape == raw.shape
    # the batch JPEG-encodes generate_batch's frames rounded to uint8; the
    # server stacks its clips' images into one contiguous batch (the CPU's
    # convolutions sum in another order on another memory layout)
    model_in, wave = _model_inputs(arrays)
    (ref,) = fpipe.pipeline.generate_batch(np.stack([model_in[0]]), wave,
                                           seeds=[15])
    ref = np.clip(ref * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(out[0]["images"], _jpeg_roundtrip(ref, 92))
    (mp4,) = c.generate_batch([{"image": img, "audio": aud[:8000]}])
    assert mp4["frames"] == 13 and _mp4_frames(mp4["video"]) == 13
    (blob,) = c.run_graph(GRAPH, inputs={"img.npy": img}).values()
    assert np.load(io.BytesIO(blob)).shape == (1, 64, 64, 3)


def case_serve_loads_on_cuda_unless_asked(fpipe, server, payload, arrays):
    """serve() builds its mesh over the CUDA devices before loading
    anything (refused where there is none), and loads onto the card unless
    the CPU is asked for; on the CPU, load_pipe(mesh_spec=) rebuilds the
    loaded pipeline over D x M CPU ranks, and refuses a spec without both
    axes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_serve.serve("no-such-file.safetensors", mesh_spec="data=2")
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("float_torch.api.nodes.load_float_models",
                   lambda *a, **kw: seen.append(kw["target_device"]))
        t_serve.load_pipe("x.safetensors")
        t_serve.load_pipe("x.safetensors", device="cpu")
    assert seen == ["cuda", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("float_torch.api.nodes.load_float_models",
                   lambda *a, **kw: FloatPipe(fpipe.pipeline, fpipe.cfg,
                                              weights="synthetic"))
        with pytest.raises(ValueError, match="both axes"):
            t_serve.load_pipe("x.safetensors", device="cpu",
                              mesh_spec="data=2")
        got = t_serve.load_pipe("x.safetensors", device="cpu",
                                mesh_spec="data=2,model=2")
    assert t_serve.mesh_shape(got.pipeline) == {"data": 2, "model": 2}
    assert got.pipeline.mesh.flat == [torch.device("cpu")] * 4
    assert fpipe.pipeline.mesh is None
    assert t_serve.FloatServer(got).health()["mesh"] == {"data": 2,
                                                         "model": 2}


def case_decode_batch_reaches_the_config(fpipe, server, payload, arrays):
    """load_pipe(decode_batch=) replaces the config's decode_batch (the
    default config's or a given one's) and leaves it alone otherwise;
    serve() passes it on."""
    seen = []

    class Stop(Exception):
        pass

    def load_only(*args, **kw):
        seen.append(kw["decode_batch"])
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("float_torch.api.nodes.load_float_models",
                   lambda *a, **kw: seen.append(kw.get("cfg")))
        t_serve.load_pipe("x.safetensors")
        t_serve.load_pipe("x.safetensors", decode_batch=24)
        t_serve.load_pipe("x.safetensors", decode_batch=24, cfg=PT_TINY)
        mp.setattr(t_serve, "load_pipe", load_only)
        with pytest.raises(Stop):
            t_serve.serve("x.safetensors", decode_batch=24)
    assert seen == [None, t_config.FloatConfig(decode_batch=24),
                    PT_TINY.replace(decode_batch=24), 24]


def case_warmup(fpipe, server, payload, arrays):
    """warmup runs generate and both stream wires and returns its wall
    seconds; the next request's frames are unchanged."""
    before = list(t_serve.FloatServer(fpipe).iter_generate_stream(
        dict(payload, stream=True)))
    secs = fpipe.pipeline.warmup(seconds=0.5, first_chunk=4)
    assert 0 < secs < 60
    after = list(t_serve.FloatServer(fpipe).iter_generate_stream(
        dict(payload, stream=True)))
    assert before == after


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_server_behaviour(case, fpipe, server, payload, arrays):
    CASES[case](fpipe, server, payload, arrays)
