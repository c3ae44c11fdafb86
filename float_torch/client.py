"""Python client for the port's serving daemon (``float_torch.serve``;
the twin of ``float_tpu.client``, which speaks the same protocol).

A mirror of the server's endpoints on the standard library and numpy;
JPEG frames are decoded with OpenCV, imported only when a JPEG arrives:

    from float_torch.client import FloatClient
    c = FloatClient("http://host:8472")
    c.health()
    video_bytes = c.generate(image, audio, emotion="happy")   # mp4
    for start, frames in c.stream(image, audio):              # uint8 chunks
        sink(start, frames)
    artifacts = c.run_graph(workflow_dict, inputs={"img.png": png_bytes})
"""
from __future__ import annotations

import base64
import io
import json
import urllib.request
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np


def _b64(payload) -> str:
    """numpy array -> base64 .npy; raw bytes/str pass through as-is."""
    if isinstance(payload, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, payload)
        payload = buf.getvalue()
    if isinstance(payload, bytes):
        return base64.b64encode(payload).decode()
    return payload          # already base64


def _jpeg_to_rgb(b64_jpeg: str) -> np.ndarray:
    """One base64 JPEG -> (H, W, 3) uint8 RGB."""
    import cv2
    buf = np.frombuffer(base64.b64decode(b64_jpeg), np.uint8)
    bgr = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError("bad jpeg frame in stream")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _decode_chunk_msg(msg: Dict[str, Any]) -> np.ndarray:
    """NDJSON chunk message -> (k, S, S, 3) uint8, either encoding."""
    if msg.get("encoding") == "jpeg":
        return np.stack([_jpeg_to_rgb(f) for f in msg["frames"]])
    return np.frombuffer(base64.b64decode(msg["data"]),
                         dtype=msg["dtype"]).reshape(msg["shape"])


class FloatClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8472",
                 timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str) -> Dict[str, Any]:
        with urllib.request.urlopen(self.base_url + path,
                                    timeout=self.timeout) as r:
            return json.loads(r.read())

    def _post(self, path: str, body: Dict[str, Any]):
        req = urllib.request.Request(
            self.base_url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=self.timeout)

    def health(self) -> Dict[str, Any]:
        return self._get("/health")

    def metrics(self) -> Dict[str, Any]:
        return self._get("/metrics")

    def generate(self, image, audio, **params) -> bytes:
        """One-shot generation -> mp4 bytes (audio muxed server-side when
        ffmpeg is available).  ``image``/``audio`` accept numpy arrays
        (image (H,W,3) float [0,1]; audio (N,) 16 kHz float), raw
        png/jpg/wav bytes, or pre-encoded base64 strings.  ``params``:
        emotion, a_cfg_scale, e_cfg_scale, fps, seed, face_align."""
        body = dict(params, image=_b64(image), audio=_b64(audio))
        with self._post("/v1/generate", body) as r:
            return r.read()

    def stream(self, image, audio, **params
               ) -> Iterator[Tuple[int, np.ndarray]]:
        """Streaming generation: yields (start_frame, uint8 (k, S, S, 3))
        chunks as the server decodes them.  Pass ``encoding="jpeg"``
        (optionally ``quality=85``) for compressed delivery — ~25x fewer
        wire bytes at 512², so playback-rate streaming works on ordinary
        links; frames decode back to the same uint8 layout here."""
        body = dict(params, image=_b64(image), audio=_b64(audio),
                    stream=True)
        with self._post("/v1/generate", body) as r:
            for line in r:
                msg = json.loads(line)
                yield msg["start"], _decode_chunk_msg(msg)

    def generate_batch(self, clips, **params):
        """Batched clips -> [{"video": mp4 bytes, "frames": n}, ...].
        ``clips``: list of {"image", "audio", optional "seed"} with the
        same payload types generate() accepts.  With ``encoding="jpeg"``
        each result is {"frames": n, "images": (n, S, S, 3) uint8}
        (decoded per-frame JPEGs) instead of an mp4."""
        body = dict(params, clips=[
            dict(c, image=_b64(c["image"]), audio=_b64(c["audio"]))
            for c in clips])
        with self._post("/v1/generate_batch", body) as r:
            out = json.loads(r.read())
        res = []
        for c in out["clips"]:
            if c.get("encoding") == "jpeg":
                res.append({"frames": c["frames"], "images": np.stack(
                    [_jpeg_to_rgb(f) for f in c["jpeg_frames"]])})
            else:
                res.append({"video": base64.b64decode(c["video"]),
                            "frames": c["frames"]})
        return res

    def run_graph(self, workflow, inputs: Optional[Dict[str, Any]] = None,
                  overrides: Optional[Dict[str, Any]] = None,
                  **extra) -> Dict[str, bytes]:
        """Execute a ComfyUI workflow JSON server-side.  ``inputs`` maps
        LoadImage/LoadAudio filenames to file payloads (bytes / arrays /
        base64).  Returns {artifact_name: bytes}."""
        body = dict(extra, workflow=workflow,
                    inputs={k: _b64(v) for k, v in (inputs or {}).items()},
                    overrides=overrides or {})
        with self._post("/v1/graph", body) as r:
            out = json.loads(r.read())
        return {k: base64.b64decode(v)
                for k, v in out["artifacts"].items()}
