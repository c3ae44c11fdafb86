"""Frame-batched decode (twin of ``float_tpu.runtime.decode``): the chunk
program, the on-device decode, and the host-delivery loops.

    decode_chunk           (fb, dim_w) latents -> frames: f32 [0, 1],
                           uint8 RGB, or planar 4:2:0 uint8
    decode_latents         T frames on the device, f32 [0, 1]
    decode_latents_to_host T frames into host memory, one chunk in flight
    decode_latents_stream  frames yielded chunk by chunk as latent pieces
                           arrive (the streaming mode)
    decode_clips_to_host   several clips in one dispatch stream

The TPU decode's D/path ratchets, optimistic and fixup programs, steady
probe and pessimist switch exist only for the TPU kernels' static tap
window; the CUDA warp kernels gather their taps for any displacement and
are exact, so none of them has a counterpart here.

On a CUDA device the host loops overlap the copy of chunk c with the
compute of chunk c+1: the copy runs on a side stream into pinned memory,
ordered after chunk c by the stream's wait, and the host blocks only on
the chunk it hands out.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..models.synthesis import RGB_IN_KERNEL, synthesis
from ..ops import DISPATCH, Warps, rgb01_to_i420

CL = torch.channels_last


def chunk_sizes(t_frames: int, fb: int) -> list:
    """Per-chunk frame counts: full ``fb`` chunks, the last one shrunk to
    the smallest multiple of 4 covering the remainder (250 frames at
    fb=24 decode as 10x24 + 1x12)."""
    n_chunks = math.ceil(t_frames / fb)
    sizes = [fb] * n_chunks
    if n_chunks:
        rem = t_frames - (n_chunks - 1) * fb
        sizes[-1] = min(fb, max(4, math.ceil(rem / 4) * 4))
    return sizes


def first_chunk_size(first_chunk: int, fb: int) -> int:
    """The stream's first dispatch: ``first_chunk`` frames rounded up to a
    multiple of 4, at most ``fb``; 0 (no ramp) stays 0."""
    if not first_chunk:
        return 0
    return min(fb, max(4, math.ceil(first_chunk / 4) * 4))


def stream_chunk_count(t_frames: int, fb: int, first_chunk: int = 0) -> int:
    """Decode dispatches of a ``t_frames`` stream: the ramp's first chunk,
    then full ``fb`` chunks, the last one padded."""
    first = first_chunk_size(first_chunk, fb)
    if not first:
        return math.ceil(t_frames / fb)
    return 1 + math.ceil(max(0, t_frames - first) / fb)


def decode_chunk(synthesis_params, wa_chunk, feats, size: int, out_u8=False,
                 warps: Warps = DISPATCH, rgb_in_kernel: bool = RGB_IN_KERNEL,
                 blur_kernel=(1, 3, 3, 1)):
    """(fb, dim_w) latents -> frames.

    ``out_u8``: False = (fb, S, S, 3) f32 in [0, 1]; True = uint8 RGB,
    round(img·255) half to even (4x fewer wire bytes than f32);
    "yuv420" = planar 4:2:0 uint8 (fb, S·3/2, S), half the uint8 RGB
    bytes (``ops/yuv420.py``)."""
    img, _ = synthesis(synthesis_params, wa_chunk, feats, size, warps=warps,
                       rgb_in_kernel=rgb_in_kernel, blur_kernel=blur_kernel)
    img = (img.float().clamp(-1.0, 1.0) + 1.0) * 0.5
    img = img.permute(0, 2, 3, 1)
    if out_u8 == "yuv420":
        return rgb01_to_i420(img)
    if out_u8:
        return torch.round(img * 255.0).to(torch.uint8)
    return img


def _prepare(s_r, feats, r_d, t_pad: int, compute_dtype):
    """wa = s_r + r_d in f32, cast to ``compute_dtype`` and edge-padded to
    ``t_pad`` rows with its last latent; the skip maps cast once."""
    wa = (s_r.float() + r_d.float()).to(compute_dtype)
    if t_pad > wa.shape[0]:
        wa = torch.cat([wa, wa[-1:].expand(t_pad - wa.shape[0], -1)])
    feats_c = [f.to(compute_dtype).contiguous(memory_format=CL)
               for f in feats]
    return wa, feats_c


def decode_latents(synthesis_params, s_r, feats, r_d, *, size: int,
                   decode_batch: int = 8, compute_dtype=torch.float32,
                   rgb_in_kernel: bool = RGB_IN_KERNEL,
                   frame_callback=None, blur_kernel=(1, 3, 3, 1)):
    """Decode T frames: s_r (1, dim_w), feats (7 maps, each (1, C, H, W)),
    r_d (T, dim_w) -> (T, size, size, 3) f32 in [0, 1] on the device.

    The last chunk pads by repeating the last latent and its extra frames
    are dropped.  ``frame_callback(i, n)`` fires after chunk i is
    dispatched."""
    t_frames = r_d.shape[0]
    sizes = chunk_sizes(t_frames, decode_batch)
    wa, feats_c = _prepare(s_r, feats, r_d, sum(sizes), compute_dtype)
    frames = torch.empty((t_frames, size, size, 3), dtype=torch.float32,
                         device=wa.device)
    lo = 0
    for ci, sz in enumerate(sizes):
        chunk = decode_chunk(synthesis_params, wa[lo:lo + sz], feats_c, size,
                             rgb_in_kernel=rgb_in_kernel,
                             blur_kernel=blur_kernel)
        n = min(sz, t_frames - lo)
        frames[lo:lo + n] = chunk[:n]
        lo += sz
        if frame_callback is not None:
            frame_callback(ci, len(sizes))
    return frames


class _HostCopy:
    """A chunk on its way to host memory.  On a CUDA device the copy is
    queued on ``stream`` (after the work that made the chunk) into pinned
    memory, so it overlaps whatever the compute stream runs next."""

    def __init__(self, dev: torch.Tensor, stream):
        self.event = None
        if dev.device.type != "cuda":
            self.host = dev
            return
        self.host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        stream.wait_stream(torch.cuda.current_stream(dev.device))
        with torch.cuda.stream(stream):
            self.host.copy_(dev, non_blocking=True)
        dev.record_stream(stream)
        self.event = torch.cuda.Event()
        self.event.record(stream)

    def numpy(self) -> np.ndarray:
        """Block until the bytes arrived; the host array."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _copy_stream(device):
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def _store(dst: np.ndarray, host: np.ndarray, uint8_transfer: bool) -> None:
    """dst[:] = host, or host / 255 in f32 for the uint8 wire: one pass
    through torch's threaded kernels instead of two numpy passes."""
    if uint8_transfer:
        torch.div(torch.from_numpy(host), 255.0, out=torch.from_numpy(dst))
    else:
        dst[:] = host


def decode_latents_to_host(synthesis_params, s_r, feats, r_d, *, size: int,
                           decode_batch: int = 8, compute_dtype=torch.float32,
                           uint8_transfer: bool = True, frame_callback=None,
                           blur_kernel=(1, 3, 3, 1)) -> np.ndarray:
    """Decode T frames into host memory chunk by chunk -> (T, S, S, 3)
    float32 numpy in [0, 1]: ``decode_clips_to_host`` of one clip.

    A long clip never sits on the device as one f32 array (60 s at 512²
    is 4.7 GB).  With ``uint8_transfer`` each chunk is rounded to uint8 on
    the device (4x fewer wire bytes) and divided by 255 on the host.  One
    chunk stays in flight: chunk c+1 is dispatched before chunk c is read.
    ``frame_callback(i, n)`` fires when chunk i's bytes have arrived."""
    return decode_clips_to_host(
        synthesis_params, [(s_r, feats, r_d)], size=size,
        decode_batch=decode_batch, compute_dtype=compute_dtype,
        uint8_transfer=uint8_transfer, frame_callback=frame_callback,
        blur_kernel=blur_kernel)[0]


@torch.inference_mode()
def decode_latents_stream(synthesis_params, s_r, feats, latent_iter, *,
                          size: int, decode_batch: int = 8,
                          compute_dtype=torch.float32,
                          uint8_transfer: bool = True, frame_callback=None,
                          first_chunk: int = 0, emit: str = "f32",
                          blur_kernel=(1, 3, 3, 1)):
    """Incremental decode: consume (k, dim_w) r_d pieces from
    ``latent_iter`` and yield (start_frame, frames) as soon as each decode
    chunk's bytes reach the host.

    ``emit``: "f32" yields float32 [0, 1] RGB (uint8 on the wire when
    ``uint8_transfer``); "u8" yields the uint8 RGB as transferred; "yuv420"
    yields planar 4:2:0 uint8 (k, S·3/2, S), half the u8 wire bytes.
    ``uint8_transfer`` matters only for "f32"; it is kept beside ``emit``
    for parity with float_tpu's signature.

    The sampler that feeds ``latent_iter`` keeps integrating chunk c+1
    while chunk c decodes: launches are asynchronous and the host blocks
    only on the chunk it is about to yield (one chunk stays in flight).
    ``first_chunk`` > 0 makes the first dispatch that many frames (rounded
    up to a multiple of 4, at most ``decode_batch``) so the first frames
    arrive sooner; later chunks are full.  The last partial chunk is padded
    with its last latent.  ``frame_callback(i, -1)`` fires as chunk i is
    yielded (the total is unknown mid-stream)."""
    if emit not in ("f32", "u8", "yuv420"):
        raise ValueError(f"unknown emit format {emit!r}")
    out_u8 = "yuv420" if emit == "yuv420" else (uint8_transfer
                                                or emit == "u8")
    fb = decode_batch
    first_chunk = first_chunk_size(first_chunk, fb)
    s32 = s_r.float()
    feats_c = [f.to(compute_dtype).contiguous(memory_format=CL)
               for f in feats]
    stream = _copy_stream(s32.device)
    n_done = 0

    def dispatch(rows, start, n_valid):
        wa_c = (s32 + rows.float()).to(compute_dtype)
        dev = decode_chunk(synthesis_params, wa_c, feats_c, size,
                           out_u8=out_u8, blur_kernel=blur_kernel)
        return start, n_valid, _HostCopy(dev, stream)

    def take(item):
        nonlocal n_done
        start, n_valid, copy = item
        host = copy.numpy()[:n_valid]
        if emit == "f32" and uint8_transfer:
            f32 = np.empty(host.shape, np.float32)
            _store(f32, host, True)
            host = f32
        n_done += 1
        if frame_callback is not None:
            frame_callback(n_done - 1, -1)
        return start, host

    buf: list = []                     # pending latent rows
    buffered = 0
    pending = None
    emitted_rows = 0
    want = first_chunk or fb           # ramp size for dispatch 0 only
    for piece in latent_iter:
        buf.append(piece)
        buffered += piece.shape[0]
        while buffered >= want:
            cat = buf[0] if len(buf) == 1 else torch.cat(buf)
            rows, rest = cat[:want], cat[want:]
            buf = [rest] if rest.shape[0] else []
            buffered = rest.shape[0]
            item = dispatch(rows, emitted_rows, want)
            emitted_rows += want
            want = fb
            if pending is not None:
                yield take(pending)
            pending = item
    if buffered:
        cat = buf[0] if len(buf) == 1 else torch.cat(buf)
        pad = cat[-1:].expand(want - buffered, -1)
        item = dispatch(torch.cat([cat, pad]), emitted_rows, buffered)
        if pending is not None:
            yield take(pending)
        pending = item
    if pending is not None:
        yield take(pending)


@torch.inference_mode()
def decode_clips_to_host(synthesis_params, clips, *, size: int,
                         decode_batch: int = 8, compute_dtype=torch.float32,
                         uint8_transfer: bool = True, frame_callback=None,
                         blur_kernel=(1, 3, 3, 1)) -> list:
    """Decode several clips in one dispatch stream: ``clips`` = list of
    (s_r (1, dim_w), feats, r_d (T_i, dim_w)) -> list of (T_i, S, S, 3)
    float32 numpy arrays in [0, 1].

    Chunks of all clips share one in-flight copy overlap, so the device
    does not idle between clips.  Each clip's cast inputs are made when
    its first chunk is dispatched and dropped after its last, so N clips
    never hold N cast copies of their skip maps at once.
    ``frame_callback(i, n)`` fires as the i-th of all n chunks arrives."""
    fb = decode_batch
    metas = []                          # (t_frames, sizes) per clip
    outs = []
    for _s_r, _feats, r_d in clips:
        t_frames = r_d.shape[0]
        metas.append((t_frames, chunk_sizes(t_frames, fb)))
        outs.append(np.empty((t_frames, size, size, 3), np.float32))
    total = sum(len(sizes) for _t, sizes in metas)
    stream = None
    n_done = 0

    def drain(k, ci, copy):
        nonlocal n_done
        t_frames = metas[k][0]
        lo = ci * fb
        hi = min(lo + fb, t_frames)
        _store(outs[k][lo:hi], copy.numpy()[:hi - lo], uint8_transfer)
        n_done += 1
        if frame_callback is not None:
            frame_callback(n_done - 1, total)

    pending = None
    for k, (s_r, feats, r_d) in enumerate(clips):
        _t, sizes = metas[k]
        wa, feats_c = _prepare(s_r, feats, r_d, sum(sizes), compute_dtype)
        if stream is None:
            stream = _copy_stream(wa.device)
        for ci, sz in enumerate(sizes):
            dev = decode_chunk(synthesis_params, wa[ci * fb:ci * fb + sz],
                               feats_c, size, out_u8=uint8_transfer,
                               blur_kernel=blur_kernel)
            copy = _HostCopy(dev, stream)
            if pending is not None:
                drain(*pending)
            pending = (k, ci, copy)
        del wa, feats_c
    if pending is not None:
        drain(*pending)
    return outs
