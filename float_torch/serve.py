"""HTTP serving daemon for one CUDA card (twin of ``float_tpu.serve``:
the same endpoints, JSON shapes, status codes, environment variables and
concurrency contract).

The reference deploys as a ComfyUI server; this package's equivalent is a
standard-library (http.server) daemon over the same pipeline:

    python -m float_torch.cli serve --checkpoint models/float/FLOAT.safetensors \
        --host 0.0.0.0 --port 8472 [--decode-batch 24] [--warm]

Endpoints (JSON in, JSON or binary out):

- ``GET  /health`` -> {"status", "device", "device_name", "weights",
  "busy"}: the pipeline's torch device and the card's name
- ``GET  /metrics`` -> cumulative {"requests", "errors", "frames",
  "busy_seconds", "frames_per_busy_second"}
- ``POST /v1/generate`` body
  {"image": <b64 npy|png|jpg>, "audio": <b64 npy|wav>, "emotion",
   "a_cfg_scale", "e_cfg_scale", "fps", "seed", "face_align",
   "stream": false, "first_chunk": 8, "format": "mp4"|"ndjson",
   "encoding": "raw"|"jpeg", "quality": 85}
  -> video/mp4 bytes (audio muxed when ffmpeg is present), or with
  ``stream: true`` an ``application/x-ndjson`` response where each line is
  {"start": f, "shape": [k,S,S,3], "dtype": "uint8", "data": <b64>} —
  chunks leave the server as soon as the device decodes them (the
  pipeline's generate_stream interleaves sampling and decode;
  ``first_chunk`` ramps the first chunk small for low first-frame
  latency).  With ``"encoding": "jpeg"`` each line is instead
  {"start": f, "shape": [k,S,S,3], "encoding": "jpeg",
  "frames": [<b64 jpeg>, ...]} — ~40 KB/frame at 512² instead of
  ~1 MB raw-b64, so streamed delivery sustains real-time playback on
  ordinary links (raw needs ~26 MB/s for 25 fps); the device->host hop
  also drops to a 4:2:0 wire (half the uint8 bytes, ops/yuv420.py —
  zero extra loss: JPEG subsamples the same chroma).  JPEG encoding
  imports OpenCV at the first JPEG request.
- ``POST /v1/generate_batch`` body {"clips": [{"image", "audio",
  "seed"?}, ...], ...shared params} -> {"clips": [{"video": <b64 mp4>,
  "frames"}, ...]} — clips grouped by audio length; each group runs the
  generate_batch path (one batched image encode, audio encoded per length
  group, one decode dispatch stream for all clips).  ``"encoding": "jpeg"`` (+ "quality")
  returns per-frame JPEGs instead of mp4: {"clips": [{"frames": n,
  "encoding": "jpeg", "jpeg_frames": [<b64>, ...]}, ...]} — for clients
  that want exact frame access without a video decoder.
- ``POST /v1/graph`` body {"workflow": <ComfyUI graph JSON>,
  "overrides": {...}, "inputs": {"name.ext": <b64>}} -> {"artifacts":
  {name: <b64>}} — executes a reference ComfyUI workflow server-side
  (api/comfy.py registry).

One generation runs at a time (one card, serialised by a mutex);
concurrent requests queue on the lock, health checks never block.

Concurrency contract (replaces the reference's serial one-at-a-time node
loop, reference src/nodes/nodes.py:189-211):

- The generation lock covers DEVICE work only.  Streaming responses are
  produced by a worker thread into a byte-bounded buffer; client socket
  writes happen outside the lock, so a slow or stalled reader can only
  stall its own stream, never the card or other clients.
- A reader that accepts no data for ``stream_stall_timeout`` seconds while
  the buffer is full gets its generation aborted (the worker stops
  dispatching and releases the card).
- Admission control: at most ``max_pending`` requests may hold or wait for
  the generation lock; beyond that the server answers ``503`` with a
  ``Retry-After`` header instead of queueing unboundedly.
- Every socket has a write timeout (``FLOAT_SERVE_SOCKET_TIMEOUT``); a
  client that stops reading a non-streamed body cannot pin a handler
  thread forever.
- ``/metrics`` reports request latency percentiles (total and
  lock-wait), rejected/aborted counts, and live queue depth.
"""
from __future__ import annotations

import base64
import contextlib
import io
import json
import logging
import os
import tempfile
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import FloatConfig

logger = logging.getLogger("float_torch.serve")


class _Busy(Exception):
    """Raised by admission control when the pending queue is saturated."""

    def __init__(self, depth: int, retry_after: float):
        super().__init__(f"server busy: {depth} requests pending")
        self.depth = depth
        self.retry_after = retry_after


class _ReaderStalled(Exception):
    """The streaming client accepted no data for the stall timeout while
    the buffer was full — its generation is aborted."""


class _StreamBuffer:
    """Byte-bounded handoff between the generation worker (producer) and
    the HTTP handler writing to the client socket (consumer).

    The producer blocks only when ``budget_bytes`` of encoded lines are
    already queued (a healthy reader never lets it fill: a 512² stream
    chunk is ~25 MB base64 against a default 256 MB budget); if the
    consumer then makes no progress for ``stall_timeout`` seconds the
    producer raises ``_ReaderStalled`` and the generation stops — the
    card is never held idle by a dead client."""

    def __init__(self, budget_bytes: int, stall_timeout: float):
        self.budget = budget_bytes
        self.stall_timeout = stall_timeout
        self._q: deque = deque()
        self._bytes = 0
        self._closed = False          # producer done (or aborted)
        self._error: Optional[BaseException] = None
        self._cancelled = False       # consumer gone
        self._cv = threading.Condition()

    def put(self, line: bytes) -> None:
        with self._cv:
            # the stall deadline measures CONSUMER progress, not total wait:
            # a slow-but-draining reader extends it every time bytes leave
            # the buffer (the documented contract is "accepts no data for
            # stall_timeout while the buffer is full")
            deadline = time.monotonic() + self.stall_timeout
            last_bytes = self._bytes
            while (self._bytes + len(line) > self.budget and self._bytes > 0
                   and not self._cancelled):
                if self._bytes < last_bytes:
                    deadline = time.monotonic() + self.stall_timeout
                last_bytes = self._bytes
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise _ReaderStalled()
                self._cv.wait(timeout=remaining)
            if self._cancelled:
                raise _ReaderStalled()
            self._q.append(line)
            self._bytes += len(line)
            self._cv.notify_all()

    def close(self, error: Optional[BaseException] = None) -> None:
        with self._cv:
            self._closed = True
            self._error = error
            self._cv.notify_all()

    def cancel(self) -> None:
        """Consumer is gone: unblock and stop the producer."""
        with self._cv:
            self._cancelled = True
            self._q.clear()
            self._bytes = 0
            self._cv.notify_all()

    def __iter__(self):
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait(timeout=1.0)
                if self._q:
                    line = self._q.popleft()
                    self._bytes -= len(line)
                    self._cv.notify_all()
                else:                     # closed and drained
                    if self._error is not None:
                        raise self._error
                    return
            yield line


class _LatencyWindow:
    """Fixed-size ring of request latencies -> p50/p95/p99 summaries."""

    def __init__(self, maxlen: int = 512):
        self._d: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def add(self, seconds: float) -> None:
        with self._lock:
            self._d.append(seconds)

    def reset(self) -> None:
        """Drop recorded samples (load benches call this after their warm
        phase so compile-time latencies don't pollute the percentiles)."""
        with self._lock:
            self._d.clear()

    def summary(self) -> Optional[Dict[str, float]]:
        with self._lock:
            vals = sorted(self._d)
        if not vals:
            return None

        def pct(p):
            i = min(len(vals) - 1, int(round(p / 100.0 * (len(vals) - 1))))
            return round(vals[i], 4)

        return {"count": len(vals), "p50": pct(50), "p95": pct(95),
                "p99": pct(99), "max": round(vals[-1], 4)}


# JPEG frame encoding (the compressed stream/batch delivery path).
# cv2.imencode releases the GIL, so a small shared pool encodes a chunk's
# frames in parallel and keeps the host encode ahead of the wire.
_JPEG_POOL = None
_JPEG_POOL_LOCK = threading.Lock()


def _jpeg_pool():
    global _JPEG_POOL
    with _JPEG_POOL_LOCK:
        if _JPEG_POOL is None:
            from concurrent.futures import ThreadPoolExecutor
            _JPEG_POOL = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 4),
                thread_name_prefix="float-jpeg")
        return _JPEG_POOL


def _jpeg_encode_frames(u8_frames: np.ndarray, quality: int) -> list:
    """(k, H, W, 3) uint8 RGB -> list of base64 JPEG strings."""
    import cv2
    flags = [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)]

    def enc(f):
        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(f, cv2.COLOR_RGB2BGR),
                               flags)
        if not ok:
            raise RuntimeError("jpeg encode failed")
        return base64.b64encode(buf.tobytes()).decode()

    return list(_jpeg_pool().map(enc, u8_frames))


def _check_encoding(req) -> tuple:
    """Validate (encoding, quality) from a request -> ValueError (HTTP
    400) on junk, BEFORE any 200/stream headers go out."""
    encoding = req.get("encoding", "raw")
    if encoding not in ("raw", "jpeg"):
        raise ValueError(f"unknown encoding {encoding!r} "
                         "(expected 'raw' or 'jpeg')")
    quality = int(req.get("quality", 85))
    if not 1 <= quality <= 100:
        raise ValueError(f"jpeg quality {quality} out of range [1, 100]")
    return encoding, quality


def _b64_to_array(data: str, kind: str) -> np.ndarray:
    """base64 payload -> numpy array.  .npy magic is auto-detected; wav
    via the port's PCM reader, resampled to 16 kHz mono; other images via
    ``image.transform.load_image_file`` (OpenCV)."""
    raw = base64.b64decode(data)
    if raw[:6] == b"\x93NUMPY":
        return np.load(io.BytesIO(raw), allow_pickle=False)
    suffix = ".wav" if kind == "audio" else ".png"
    with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as f:
        f.write(raw)
        path = f.name
    try:
        if kind == "audio":
            from .audio.resample import read_wav_file, resample, to_mono
            arr, sr = read_wav_file(path)
            return resample(to_mono(arr), sr, 16000)
        from .image.transform import load_image_file
        return load_image_file(path)
    finally:
        os.unlink(path)


class FloatServer:
    """Wraps a FloatPipe behind the HTTP handler; testable without
    sockets via ``handle_generate`` / ``handle_graph``.  Device work runs
    on the pipeline's device (``pipe.pipeline.device``)."""

    def __init__(self, pipe, output_dir: Optional[str] = None,
                 max_pending: Optional[int] = None,
                 stream_buffer_mb: Optional[float] = None,
                 stream_stall_timeout: Optional[float] = None):
        self.pipe = pipe
        self.output_dir = output_dir or tempfile.mkdtemp(prefix="float_srv_")
        self.lock = threading.Lock()     # one generation at a time per card
        # admission control: requests holding OR waiting for the lock
        self.max_pending = max_pending if max_pending is not None else int(
            os.environ.get("FLOAT_SERVE_MAX_PENDING", "4"))
        mb = (stream_buffer_mb if stream_buffer_mb is not None else float(
            os.environ.get("FLOAT_SERVE_STREAM_BUFFER_MB", "256")))
        self.stream_buffer_bytes = int(mb * (1 << 20))
        self.stream_stall_timeout = (
            stream_stall_timeout if stream_stall_timeout is not None
            else float(os.environ.get("FLOAT_SERVE_STREAM_STALL_SEC", "60")))
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "errors": 0, "frames": 0,
                      "busy_seconds": 0.0, "rejected_busy": 0,
                      "stream_aborts": 0}
        self.latency = _LatencyWindow()       # total request seconds
        self.lock_wait = _LatencyWindow()     # seconds queued on the lock

    def _count(self, frames: int = 0, busy: float = 0.0, error: bool = False):
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["errors"] += 1 if error else 0
            self.stats["frames"] += frames
            self.stats["busy_seconds"] += busy

    def _bump(self, key: str):
        with self._stats_lock:
            self.stats[key] += 1

    def _slot_acquire(self):
        """Admission control: raises _Busy (-> HTTP 503 + Retry-After)
        instead of queueing beyond ``max_pending`` on the lock."""
        with self._pending_lock:
            if self._pending >= self.max_pending:
                self._bump("rejected_busy")
                # a rough hint: current queue × a nominal clip time
                raise _Busy(self._pending, retry_after=5.0 * self._pending)
            self._pending += 1

    def _slot_release(self):
        with self._pending_lock:
            self._pending -= 1

    @contextlib.contextmanager
    def _admit(self):
        """Admission + generation lock.  Raises _Busy instead of queueing
        beyond ``max_pending``; records the time spent waiting for the
        card (the queueing component of request latency)."""
        self._slot_acquire()
        t0 = time.perf_counter()
        try:
            with self.lock:
                self.lock_wait.add(time.perf_counter() - t0)
                yield
        finally:
            self._slot_release()

    # -- request handlers (transport-independent) --------------------------

    @property
    def device(self) -> torch.device:
        return self.pipe.pipeline.device

    def health(self) -> Dict[str, Any]:
        dev = self.device
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else dev.type)
        return {"status": "ok",
                "device": str(dev),
                "device_name": name,
                "weights": self.pipe.weights,
                "busy": self.lock.locked()}

    def metrics(self) -> Dict[str, Any]:
        """Serving counters: cumulative requests / errors / generated
        frames / device-busy seconds, derived frames-per-busy-second
        (the serving-side view of a clip's frames/s), live queue depth,
        and request-latency percentiles (total and lock-wait)."""
        with self._stats_lock:
            out = dict(self.stats)
        busy = out["busy_seconds"]
        out["frames_per_busy_second"] = \
            round(out["frames"] / busy, 2) if busy > 0 else None
        with self._pending_lock:
            out["queue_depth"] = self._pending
        out["latency_seconds"] = self.latency.summary()
        out["lock_wait_seconds"] = self.lock_wait.summary()
        return out

    def handle_generate(self, req: Dict[str, Any]):
        """Non-streaming generate -> (mp4 bytes, n_frames).  The lock
        covers device work only; mp4 encoding and the socket write happen
        after release."""
        img = _b64_to_array(req["image"], "image")
        wave = _b64_to_array(req["audio"], "audio").astype(np.float32)
        from .api.nodes import float_process
        from .io.video import write_video
        with self._admit():
            t0 = time.perf_counter()
            frames, _audio, fps = float_process(
                img[None] if img.ndim == 3 else img,
                wave[None] if wave.ndim == 1 else wave, self.pipe,
                a_cfg_scale=float(req.get("a_cfg_scale", 2.0)),
                e_cfg_scale=float(req.get("e_cfg_scale", 1.0)),
                fps=float(req.get("fps", 25.0)),
                emotion=req.get("emotion", "none"),
                face_align=bool(req.get("face_align", False)),
                seed=int(req.get("seed", 15)))
            self._count(frames=frames.shape[0],
                        busy=time.perf_counter() - t0)
        # unique per-request name: mp4 encode runs OUTSIDE the lock, so two
        # concurrent requests must not clobber each other's file
        path = os.path.join(self.output_dir,
                            f"gen-{threading.get_ident()}-{time.monotonic_ns()}.mp4")
        try:
            write_video(path, frames, fps, audio=wave.reshape(-1),
                        sample_rate=16000)
            with open(path, "rb") as f:
                return f.read(), frames.shape[0]
        finally:
            for p in (path, path[:-4] + ".wav"):   # sidecar when no ffmpeg
                if os.path.exists(p):
                    os.unlink(p)

    def _prep_stream_inputs(self, req: Dict[str, Any]):
        """Host-side parse/preprocess for a streaming request — runs in
        the HANDLER thread so malformed input still maps to HTTP 400
        (after the worker starts, 200 + chunked headers are already out).
        Returns the image and the normalised wave as tensors on the
        pipeline's device, and the request's config."""
        from .api.nodes import comfy_image_to_model_input, normalize_waveform
        img = _b64_to_array(req["image"], "image")
        wave = _b64_to_array(req["audio"], "audio").astype(np.float32)
        cfg = self.pipe.cfg.replace(fps=float(req.get("fps", 25.0)))
        model_in, _ = comfy_image_to_model_input(
            img, cfg.input_size, cfg.rgba_conversion, cfg.bkg_color_hex,
            face_align=bool(req.get("face_align", False)),
            face_margin=cfg.face_margin)
        wave_n = normalize_waveform(wave.reshape(-1), self.pipe.fe)[None]
        return (self._tensor(model_in), self._tensor(wave_n), cfg)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def stream_generate(self, req: Dict[str, Any]) -> _StreamBuffer:
        """Start a streaming generation; returns the byte buffer to drain
        to the client.  Admission failures (_Busy) and input errors raise
        HERE (handler thread, before any response bytes); device work runs
        in a worker thread that holds the generation lock only while
        producing into the buffer — a healthy reader never blocks it, a
        stalled one aborts its own generation after ``stream_stall_timeout``
        and frees the card."""
        model_in, wave_n, cfg = self._prep_stream_inputs(req)
        encoding, quality = _check_encoding(req)
        # jpeg delivery rides a 4:2:0 device->host wire (half the uint8
        # bytes; JPEG subsamples the same chroma so nothing extra is
        # lost); raw rides uint8 RGB straight through (no f32 round-trip)
        wire = "yuv420" if encoding == "jpeg" else "u8"
        self._slot_acquire()
        buf = _StreamBuffer(self.stream_buffer_bytes,
                            self.stream_stall_timeout)

        def worker():
            n_frames, busy, err = 0, 0.0, False
            t0 = time.perf_counter()
            try:
                with self.lock:
                    self.lock_wait.add(time.perf_counter() - t0)
                    t_dev = time.perf_counter()
                    try:
                        for start, frames in self.pipe.pipeline.generate_stream(
                                model_in, wave_n,
                                emotion=req.get("emotion", "none"),
                                seed=int(req.get("seed", 15)),
                                a_cfg_scale=float(req.get("a_cfg_scale", 2.0)),
                                e_cfg_scale=float(req.get("e_cfg_scale", 1.0)),
                                fps=cfg.fps,
                                first_chunk=int(req.get("first_chunk", 8)),
                                wire=wire):
                            if encoding == "jpeg":
                                from .ops.yuv420 import i420_to_rgb_u8
                                u8 = i420_to_rgb_u8(frames)
                                msg = {"start": int(start),
                                       "shape": list(u8.shape),
                                       "encoding": "jpeg",
                                       "frames": _jpeg_encode_frames(
                                           u8, quality)}
                            else:
                                u8 = np.asarray(frames)   # uint8 RGB wire
                                msg = {"start": int(start),
                                       "shape": list(u8.shape),
                                       "dtype": "uint8",
                                       "data": base64.b64encode(
                                           u8.tobytes()).decode()}
                            buf.put((json.dumps(msg) + "\n").encode())
                            n_frames += u8.shape[0]
                    finally:
                        busy = time.perf_counter() - t_dev
                buf.close()
            except _ReaderStalled as exc:
                self._bump("stream_aborts")
                logger.warning("stream aborted: reader stalled > %.1fs "
                               "with a full buffer", self.stream_stall_timeout)
                buf.close(exc)
            except BaseException as exc:   # noqa: BLE001 — must reach client
                err = True
                logger.exception("stream generation failed")
                buf.close(exc)
            finally:
                self._slot_release()
                self._count(frames=n_frames, busy=busy, error=err)

        threading.Thread(target=worker, daemon=True,
                         name="float-stream-gen").start()
        return buf

    def iter_generate_stream(self, req: Dict[str, Any]):
        """Streaming generate -> yields NDJSON lines (bytes).  Thin drain
        over stream_generate (kept as the transport-free test surface)."""
        yield from self.stream_generate(req)

    def handle_generate_batch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Batched clips: {"clips": [{"image", "audio", "seed"?}, ...]}
        plus shared params.  ONE ragged generate_batch call covers all
        clips regardless of audio length — mixed-length batches share a
        single decode dispatch stream instead of running per-length
        groups serially (runtime/pipeline.py generate_batch).  The lock
        covers device work only; mp4 encoding happens after release.
        Returns per-clip mp4s in request order."""
        from .api.nodes import comfy_image_to_model_input, normalize_waveform
        from .io.video import write_video
        clips = req["clips"]
        if not clips:
            raise ValueError("clips must be a non-empty list")
        encoding, quality = _check_encoding(req)
        cfg = self.pipe.cfg.replace(fps=float(req.get("fps", 25.0)))
        imgs, waves, seeds = [], [], []
        for i, c in enumerate(clips):
            img = _b64_to_array(c["image"], "image")
            wave = _b64_to_array(c["audio"], "audio").astype(np.float32)
            model_in, _ = comfy_image_to_model_input(
                img, cfg.input_size, cfg.rgba_conversion, cfg.bkg_color_hex,
                face_align=bool(req.get("face_align", False)),
                face_margin=cfg.face_margin)
            imgs.append(model_in[0])
            waves.append(wave.reshape(-1))
            seeds.append(int(c.get("seed", int(req.get("seed", cfg.seed)) + i)))

        with self._admit():
            t0 = time.perf_counter()
            outs = self.pipe.pipeline.generate_batch(
                self._tensor(np.stack(imgs)),
                [self._tensor(normalize_waveform(w, self.pipe.fe))
                 for w in waves],
                emotion=req.get("emotion", "none"), seeds=seeds,
                a_cfg_scale=float(req.get("a_cfg_scale", 2.0)),
                e_cfg_scale=float(req.get("e_cfg_scale", 1.0)))
            self._count(frames=sum(int(f.shape[0]) for f in outs),
                        busy=time.perf_counter() - t0)

        results = []
        for idx, (wave, frames) in enumerate(zip(waves, outs)):
            if encoding == "jpeg":
                u8 = np.clip(np.asarray(frames) * 255.0 + 0.5,
                             0, 255).astype(np.uint8)
                results.append({
                    "encoding": "jpeg",
                    "jpeg_frames": _jpeg_encode_frames(u8, quality),
                    "frames": int(frames.shape[0])})
                continue
            # unique per-request name: mp4 encode runs OUTSIDE the lock, so
            # two overlapping batch requests must not clobber each other's
            # clip files (same hazard handle_generate was fixed for); the
            # mp4 + no-ffmpeg .wav sidecar are deleted once read back
            path = os.path.join(
                self.output_dir,
                f"clip{idx}-{threading.get_ident()}-{time.monotonic_ns()}.mp4")
            try:
                write_video(path, frames, cfg.fps, audio=wave,
                            sample_rate=16000)
                with open(path, "rb") as f:
                    results.append({
                        "video": base64.b64encode(f.read()).decode(),
                        "frames": int(frames.shape[0])})
            finally:
                for p in (path, path[:-4] + ".wav"):
                    if os.path.exists(p):
                        os.unlink(p)
        return {"clips": results}

    def handle_graph(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Execute a ComfyUI workflow graph; returns artifacts as base64."""
        from .api.comfy import GraphContext, run_comfy_workflow
        with tempfile.TemporaryDirectory(prefix="float_graph_") as tmp:
            inputs_dir = os.path.join(tmp, "in")
            out_dir = os.path.join(tmp, "out")
            os.makedirs(inputs_dir)
            for name, b64 in (req.get("inputs") or {}).items():
                safe = os.path.basename(name)
                with open(os.path.join(inputs_dir, safe), "wb") as f:
                    f.write(base64.b64decode(b64))
            ctx = GraphContext(
                device=str(self.device),
                models_root=req.get("models_root", "models"),
                inputs_dir=inputs_dir, output_dir=out_dir,
                overrides=req.get("overrides") or {},
                float_pipe=self.pipe,
                allow_synthetic=bool(req.get("allow_synthetic", False)))
            with self._admit():
                _results, ctx = run_comfy_workflow(req["workflow"], ctx)
            artifacts = {}
            for path in ctx.artifacts:
                with open(path, "rb") as f:
                    artifacts[os.path.relpath(path, out_dir)] = \
                        base64.b64encode(f.read()).decode()
            return {"artifacts": artifacts}


class _BodyTooLarge(Exception):
    pass


class _Handler(BaseHTTPRequestHandler):
    server_version = "float_torch"
    protocol_version = "HTTP/1.1"    # chunked streaming needs 1.1
    srv: FloatServer = None          # set by make_server
    # per-socket send/recv timeout: a client that stops reading a
    # response body cannot pin a handler thread forever (each send()
    # that makes no progress for this long raises)
    timeout = float(os.environ.get("FLOAT_SERVE_SOCKET_TIMEOUT", "120"))

    def log_message(self, fmt, *args):
        logger.info("%s %s", self.address_string(), fmt % args)

    def _json(self, code: int, obj: Dict[str, Any], headers=()):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health":
            return self._json(200, self.srv.health())
        if self.path == "/metrics":
            return self._json(200, self.srv.metrics())
        self._json(404, {"error": f"unknown path {self.path}"})

    # request bodies carry base64 media; bound them so a stray client
    # cannot OOM the server (override via FLOAT_SERVE_MAX_BODY_MB)
    MAX_BODY = int(os.environ.get("FLOAT_SERVE_MAX_BODY_MB", "512")) << 20

    def _read_body(self) -> Dict[str, Any]:
        n = int(self.headers.get("Content-Length", 0))
        if n > self.MAX_BODY:
            raise _BodyTooLarge(n)
        return json.loads(self.rfile.read(n) or b"{}")

    def _stream_response(self, req):
        """Drain a streaming generation to the client as chunked NDJSON.
        The buffer decouples the generation worker from this socket: a
        dead/stalled reader here cancels only its own generation."""
        buf = self.srv.stream_generate(req)   # _Busy/4xx raise BEFORE headers
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for line in buf:
                self.wfile.write(
                    f"{len(line):x}\r\n".encode() + line + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionError, TimeoutError, OSError):
            buf.cancel()                      # stop the producer
            self.close_connection = True
        except _ReaderStalled:
            # producer gave up on us: terminate the response mid-stream
            self.close_connection = True
        except Exception:
            # generation failed mid-stream (200 already sent): the
            # truncated chunked body signals the client
            logger.exception("stream failed mid-response")
            self.close_connection = True

    def do_POST(self):
        t0 = time.perf_counter()
        try:
            req = self._read_body()
            if self.path == "/v1/generate":
                if req.get("stream"):
                    return self._stream_response(req)
                video, n_frames = self.srv.handle_generate(req)
                self.send_response(200)
                self.send_header("Content-Type", "video/mp4")
                self.send_header("Content-Length", str(len(video)))
                self.send_header("X-Frames", str(n_frames))
                self.end_headers()
                self.wfile.write(video)
                return
            if self.path == "/v1/generate_batch":
                return self._json(200, self.srv.handle_generate_batch(req))
            if self.path == "/v1/graph":
                return self._json(200, self.srv.handle_graph(req))
            self._json(404, {"error": f"unknown path {self.path}"})
        except _Busy as exc:
            self._json(503, {"error": str(exc),
                             "retry_after": exc.retry_after},
                       headers=[("Retry-After",
                                 str(int(exc.retry_after) or 1))])
        except _BodyTooLarge as exc:
            self.close_connection = True    # unread body would desync 1.1
            self._json(413, {"error": f"body of {exc.args[0]} bytes "
                                      f"exceeds limit {self.MAX_BODY}"})
        except (KeyError, ValueError, json.JSONDecodeError) as exc:
            self._json(400, {"error": str(exc)})
        except BrokenPipeError:
            raise
        except Exception as exc:
            logger.exception("request failed")
            self.srv._count(error=True)
            self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
        finally:
            if self.path.startswith("/v1/"):
                self.srv.latency.add(time.perf_counter() - t0)


def make_server(pipe, host: str = "127.0.0.1", port: int = 8472,
                output_dir: Optional[str] = None,
                **server_opts) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server around a loaded FloatPipe;
    port 0 picks a free port (tests).  ``server_opts`` pass through to
    FloatServer (max_pending, stream_buffer_mb, stream_stall_timeout)."""
    srv = FloatServer(pipe, output_dir=output_dir, **server_opts)
    handler = type("BoundHandler", (_Handler,), {"srv": srv})
    return ThreadingHTTPServer((host, port), handler)


def load_pipe(checkpoint: str, allow_synthetic: bool = False,
              models_root: str = "models",
              advanced_float_options: Optional[dict] = None,
              device: str = "cuda", decode_batch: Optional[int] = None,
              **load_kw):
    """Load the FloatPipe ``serve`` serves: ``load_float_models`` onto
    ``device`` (the card unless "cpu" is asked for).  ``decode_batch``
    (frames per synthesis decode chunk) replaces the config's; ``load_kw``
    passes through (``cfg``, ``w2v_cfg``, ``ser_cfg``)."""
    from .api.nodes import load_float_models
    if decode_batch is not None:
        load_kw["cfg"] = (load_kw.get("cfg") or FloatConfig()).replace(
            decode_batch=decode_batch)
    return load_float_models(checkpoint, target_device=device,
                             models_root=models_root,
                             advanced_float_options=advanced_float_options,
                             allow_synthetic=allow_synthetic, **load_kw)


def serve(checkpoint: str, host: str = "127.0.0.1", port: int = 8472,
          allow_synthetic: bool = False, models_root: str = "models",
          advanced_float_options: Optional[dict] = None,
          mesh_spec: Optional[str] = None, warm: bool = False,
          device: str = "cuda", decode_batch: Optional[int] = None):
    """Load the pipeline and serve forever.  The reference equivalent is
    running ComfyUI as a server.

    ``warm=True`` runs ``FloatPipeline.warmup`` BEFORE binding the port:
    the kernel libraries are built and cuDNN has picked its algorithms, so
    the first request pays neither.  ``device``: "cuda" unless "cpu" is
    asked for.  ``decode_batch``: frames per decode chunk (the config's 8
    unless given).  ``mesh_spec`` (serving over several cards) is not ported:
    it raises NotImplementedError."""
    if mesh_spec:
        raise NotImplementedError(
            "mesh serving (mesh_spec) is not ported to float_torch yet "
            "(ROADMAP Queue 1 item 9(g), multi-GPU decode and clips)")
    pipe = load_pipe(checkpoint, allow_synthetic=allow_synthetic,
                     models_root=models_root,
                     advanced_float_options=advanced_float_options,
                     device=device, decode_batch=decode_batch)
    if warm:
        logger.info("warming the serving paths before binding the port...")
        dt = pipe.pipeline.warmup()
        logger.info("warmup done in %.1fs", dt)
        print(f"warmup done in {dt:.1f}s")
    httpd = make_server(pipe, host, port)
    logger.info("serving on http://%s:%d (weights=%s, device=%s, "
                "decode_batch=%d)", host, httpd.server_address[1],
                pipe.weights, pipe.pipeline.device, pipe.cfg.decode_batch)
    print(f"float_torch serving on http://{host}:{httpd.server_address[1]}")
    httpd.serve_forever()
