"""Frame-batched decode (twin of ``float_tpu.runtime.decode``): the chunk
program, the on-device decode, and the host-delivery loops.

    decode_chunk           (fb, dim_w) latents -> frames: f32 [0, 1],
                           uint8 RGB, or planar 4:2:0 uint8
    decode_latents         T frames on the device, f32 [0, 1]
    decode_latents_to_host T frames into host memory, one chunk in flight
    decode_latents_stream  frames yielded chunk by chunk as latent pieces
                           arrive (the streaming mode)
    decode_clips_to_host   several clips in one dispatch stream
    FrameParallel          a chunk's frames split over a mesh's devices
                           (``chunk_fn=`` of each entry point)
    DecodeGraphs           the chunk program as CUDA graphs, on the card

The TPU decode's D/path ratchets, optimistic and fixup programs, steady
probe and pessimist switch exist only for the TPU kernels' static tap
window; the CUDA warp kernels gather their taps for any displacement and
are exact, so none of them has a counterpart here.

Every entry point consumes one chunk loop, ``_run_chunks``: its caller
gives the plan of chunk sizes (``chunk_sizes`` for a clip; for a stream
``first_chunk_size``, then full chunks), and the loop casts the skip
maps once, forms and pads each chunk's latents and calls the chunk
program.  On a card the chunk program is replayed from a CUDA graph
captured at its shape's first use (``DecodeGraphs``, held by the
synthesis weights' ``ParamTree``), one graph launch in place of some
hundreds of launches a chunk; it runs eagerly where no graph applies
(``decode_graphs``).  The host paths take its chunks through
``_in_flight``, which keeps one chunk in flight: on a CUDA device the
copy of chunk c runs on a side stream into pinned memory
(``_HostCopy``), ordered after chunk c by the stream's wait, while chunk
c+1 computes, and the host blocks only on the chunk it hands out.

Spans (``utils.profiling``): ``decode.chunk`` around each chunk's
dispatch (``graphed``: 1 replayed, 0 eager), ``wire.pin`` around a
copy's pinned allocation and its queueing, ``wire.wait`` around the
host's wait for its bytes.
"""
from __future__ import annotations

import copy
import itertools
import math
import weakref
from typing import Optional

import numpy as np
import torch

from ..kernels import CapturedLaunches
from ..models.init import ParamTree
from ..models.synthesis import RGB_IN_KERNEL, synthesis
from ..ops import DISPATCH, Warps, rgb01_to_i420
from ..utils.profiling import span
from .cuda_graphs import GraphCache, cache_on, capture_stream, storage

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


def decode_graph_key(wa, feats, *, size: int, out_u8=False,
                     rgb_in_kernel: bool = RGB_IN_KERNEL,
                     blur_kernel=(1, 3, 3, 1)) -> tuple:
    """What a chunk's captured program depends on besides the weights:
    the latents' shape (B), dtype and device, the skip maps' shapes, the
    output size and wire (``out_u8``), ``rgb_in_kernel`` and the blur.
    Not the values of the latents or of the skip maps (the portrait)."""
    return (tuple(wa.shape), wa.dtype, wa.device,
            tuple(tuple(f.shape) for f in feats), size, out_u8,
            rgb_in_kernel, tuple(blur_kernel))


class _Clip:
    """One decode loop's part in the graphs: the storage of its weights
    and its skip maps, which it loads into the static maps (``_Maps``)
    while it owns them."""

    def __init__(self, params, feats):
        self.weights = storage(params)
        self.feats = feats


class _Maps:
    """The skip maps the graphs read, in the compute dtype and
    channels_last, as ``_run_chunks`` casts them for an eager chunk:
    shared by every graph of one dtype and set of shapes, so a clip's maps
    are written once, not once a graph or a chunk."""

    def __init__(self, feats, dtype, device):
        self.tensors = [torch.empty(f.shape, dtype=dtype, device=device,
                                    memory_format=CL) for f in feats]
        self.owner = None           # a weak reference to the _Clip loaded

    def load(self, clip: _Clip) -> None:
        """Write ``clip``'s maps unless they are the ones held."""
        if self.owner is None or self.owner() is not clip:
            for static, f in zip(self.tensors, clip.feats):
                static.copy_(f)
            self.owner = weakref.ref(clip)


class _DecodeGraph:
    """``decode_chunk`` captured as one CUDA graph over a static copy of
    the latents and the shared static skip maps, in the memory pool
    ``pool`` (None: a pool of its own).  The chunk first runs eagerly on
    the device's capture stream, as capturing requires (the kernels'
    once-per-device set-up, cuDNN's picks and cuBLAS's workspace happen
    there): those frames are the first chunk's (``first``), so every
    launch that reaches the card makes frames a caller gets.  The
    launches the capture counted are counted again at each replay
    (``kernels.CapturedLaunches``)."""

    def __init__(self, params, wa, maps: _Maps, kw: dict, pool):
        self.device = wa.device
        self.wa = wa.clone()
        self.maps = maps

        def chunk():
            return decode_chunk(params, self.wa, maps.tensors, **kw)
        side, lock = capture_stream(self.device)
        with torch.cuda.device(self.device), lock:
            here = torch.cuda.current_stream()
            side.wait_stream(here)
            with torch.cuda.stream(side):
                self.first = chunk()
            self.graph = torch.cuda.CUDAGraph()
            with CapturedLaunches() as self.launches:
                with torch.cuda.graph(self.graph, pool=pool, stream=side,
                                      capture_error_mode="thread_local"):
                    self.out = chunk()
            here.wait_stream(side)
            self.first.record_stream(here)
            self.done = torch.cuda.Event()
            self.done.record(here)
        self.pool = self.graph.pool()

    def __call__(self, wa) -> tuple:
        """(frames of ``wa`` in a tensor of their own, whether replayed):
        the capture's own chunk's eager frames, then replays, each copied
        out of the static output, which the next replay overwrites while
        a host copy on a side stream may still read the frames handed
        out before."""
        if self.first is not None:
            out, self.first = self.first, None
            return out, False
        with torch.cuda.device(self.device):
            self.wa.copy_(wa)
            self.launches.replay(self.graph)
            out = self.out.clone()
            self.done.record()
        return out, True

    def order_after(self) -> None:
        """Make the current stream wait for this graph's last frames to be
        copied out: its static buffers and the pool are free again."""
        torch.cuda.current_stream(self.device).wait_event(self.done)


class DecodeGraphs(GraphCache):
    """The decode chunks of one synthesis as CUDA graphs, by
    ``decode_graph_key``: the ``size`` keys used last (a clip meets two,
    its full chunks and its last; a stream its ramp and its full chunks).
    Held by the synthesis' ``ParamTree`` (``decode_graphs``), so the
    graphs, their static maps and their memory pool go with the weights;
    weights moved to new storage drop them.

    The graphs share one pool and their static maps.  Each replay's
    frames are copied out before the next replay is issued, and each
    chunk's writes of the static buffers and its replay wait for the
    chunk before it to be copied out (``order_after``), whatever stream
    either ran on: so no graph reads what another left in the pool, and
    a clip's maps replace the last clip's only after its last replay."""

    def __init__(self, size: int = 8):
        super().__init__(size)
        self.pool = None
        self.maps = weakref.WeakValueDictionary()   # (dtype, shapes) -> _Maps
        self.last = None                            # the last graph run

    def fresh(self, weights: tuple) -> None:
        if weights != self.weights:
            self.pool = self.last = None
            self.maps.clear()
        super().fresh(weights)

    def run(self, params, clip: _Clip, wa, size: int, **kw) -> tuple:
        """(``decode_chunk(params, wa, clip's maps, size, **kw)``'s frames,
        whether they were replayed): the chunk's graph is captured at its
        key's first use."""
        kw = dict(size=size, **kw)
        key = decode_graph_key(wa, clip.feats, **kw)
        with self.lock, torch.inference_mode(False), torch.no_grad():
            self.fresh(clip.weights)
            if self.last is not None:
                self.last.order_after()
            shapes = (wa.dtype, tuple(tuple(f.shape) for f in clip.feats))
            maps = self.maps.get(shapes)
            if maps is None:
                maps = self.maps[shapes] = _Maps(clip.feats, wa.dtype,
                                                 wa.device)
            maps.load(clip)
            graph = self.get(key, lambda: _DecodeGraph(params, wa, maps, kw,
                                                       self.pool))
            self.pool = graph.pool
            self.last = graph
            return graph(wa)


def decode_graphs(synthesis_params, device: torch.device
                  ) -> Optional[DecodeGraphs]:
    """The synthesis' ``DecodeGraphs`` where CUDA graphs can replay its
    decode chunks on ``device``, else None (the chunks then run op by
    op): a CUDA device, weights in a ``ParamTree`` held whole on that
    device, and no capture already under way."""
    if (device.type != "cuda" or not isinstance(synthesis_params, ParamTree)
            or any(p.device != device
                   for p in synthesis_params.parameters())
            or torch.cuda.is_current_stream_capturing()):
        return None
    return cache_on(synthesis_params, "decode_graphs", DecodeGraphs)


class FrameParallel:
    """``decode_chunk`` with each chunk's frames split over ``devices`` (a
    mesh's devices, row-major): the counterpart of float_tpu's
    ``make_sharded_chunk_fn``.  Every frame is independent, so device i
    decodes its share with its own copy of the synthesis weights and skip
    maps (K1, and K2 with ``rgb_in_kernel``, launched per share on that
    device), and the frames are gathered in frame order on the device of
    the latents.  Shares differ by at most one frame; a device with no
    frame launches nothing.  One host thread launches the shares in
    turn, so the kernels' once-per-device set-up is never raced.

    The copies are made at first use and kept: the weights for as long as
    this object lives, the skip maps until another clip's maps arrive."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self._params = {}                  # device -> synthesis copy
        self._feats = (None, {})           # (source maps, device -> copies)

    def _params_on(self, params, device):
        if next(params.parameters()).device == device:
            return params
        if device not in self._params:
            self._params[device] = copy.deepcopy(params).to(device)
        return self._params[device]

    def _feats_on(self, feats, device):
        if feats[0].device == device:
            return feats
        src, copies = self._feats
        if src is not feats:
            self._feats = (feats, {})
            copies = self._feats[1]
        if device not in copies:
            copies[device] = [f.to(device) for f in feats]
        return copies[device]

    def __call__(self, synthesis_params, wa_chunk, feats, size, **kw):
        home = wa_chunk.device
        outs = []
        for device, rows in zip(self.devices,
                                wa_chunk.tensor_split(len(self.devices))):
            if rows.shape[0]:
                outs.append(decode_chunk(
                    self._params_on(synthesis_params, device),
                    rows.to(device), self._feats_on(feats, device), size,
                    **kw).to(home))
        return torch.cat(outs)


def _planned_rows(pieces, sizes):
    """(rows, n_valid) of each planned chunk: the next size of ``sizes``
    as soon as that many latent rows of ``pieces`` are buffered; a last
    partial chunk padded to its planned size with its last latent."""
    sizes = iter(sizes)
    want = next(sizes, None)
    buf, buffered = [], 0
    for piece in pieces:
        buf.append(piece)
        buffered += piece.shape[0]
        while want is not None and buffered >= want:
            cat = buf[0] if len(buf) == 1 else torch.cat(buf)
            rows, rest = cat[:want], cat[want:]
            buf = [rest] if rest.shape[0] else []
            buffered = rest.shape[0]
            yield rows, want
            want = next(sizes, None)
    if buffered:
        cat = buf[0] if len(buf) == 1 else torch.cat(buf)
        yield torch.cat([cat, cat[-1:].expand(want - buffered, -1)]), buffered


def _run_chunks(synthesis_params, s_r, feats, pieces, sizes, *, size: int,
                compute_dtype, out_u8=False,
                rgb_in_kernel: bool = RGB_IN_KERNEL,
                blur_kernel=(1, 3, 3, 1), chunk_fn=None):
    """The one chunk loop of every decode: consume (k, dim_w) r_d
    ``pieces`` and dispatch a chunk for each planned size of ``sizes`` ->
    yield (start frame, valid frames, the chunk's frames on the device).

    Each chunk's wa = s_r + r_d in f32, cast to ``compute_dtype``, is
    made and decoded within a ``decode.chunk`` span, closed before the
    chunk is yielded: replayed from the synthesis' graphs where
    ``decode_graphs`` gives them and no ``chunk_fn`` is passed (the skip
    maps then written once into the graphs' static maps), else by
    ``chunk_fn`` (else the module's ``decode_chunk``, looked up at each
    call) on the skip maps cast once (compute dtype, channels_last) at
    the first chunk.  The span's ``graphed`` is 1 where the chunk was
    replayed, else 0."""
    s32 = s_r.float()
    graphs = None if chunk_fn is not None else decode_graphs(
        synthesis_params, s32.device)
    if graphs is None:
        feats_c = [f.to(compute_dtype).contiguous(memory_format=CL)
                   for f in feats]
    else:
        clip = _Clip(synthesis_params, feats)
    kw = dict(out_u8=out_u8, rgb_in_kernel=rgb_in_kernel,
              blur_kernel=blur_kernel)
    start = 0
    for index, (rows, n_valid) in enumerate(_planned_rows(pieces, sizes)):
        with span("decode.chunk", index=index, frames=rows.shape[0],
                  graphed=0) as open_span:
            wa = (s32 + rows.float()).to(compute_dtype)
            if graphs is None:
                dev = (chunk_fn or decode_chunk)(synthesis_params, wa,
                                                 feats_c, size, **kw)
            else:
                dev, replayed = graphs.run(synthesis_params, clip, wa, size,
                                           **kw)
                if open_span is not None:
                    open_span.attrs["graphed"] = int(replayed)
        yield start, n_valid, dev
        start += rows.shape[0]


def decode_latents(synthesis_params, s_r, feats, r_d, *, size: int,
                   decode_batch: int = 8, compute_dtype=torch.float32,
                   rgb_in_kernel: bool = RGB_IN_KERNEL,
                   frame_callback=None, blur_kernel=(1, 3, 3, 1),
                   chunk_fn=None):
    """Decode T frames: s_r (1, dim_w), feats (7 maps, each (1, C, H, W)),
    r_d (T, dim_w) -> (T, size, size, 3) f32 in [0, 1] on the device.

    The last chunk pads by repeating the last latent and its extra frames
    are dropped.  ``frame_callback(i, n)`` fires after chunk i is
    dispatched.  ``chunk_fn`` replaces ``decode_chunk`` (e.g. a
    :class:`FrameParallel`), as in the other entry points."""
    t_frames = r_d.shape[0]
    sizes = chunk_sizes(t_frames, decode_batch)
    frames = torch.empty((t_frames, size, size, 3), dtype=torch.float32,
                         device=r_d.device)
    chunks = _run_chunks(synthesis_params, s_r, feats, [r_d], sizes,
                         size=size, compute_dtype=compute_dtype,
                         rgb_in_kernel=rgb_in_kernel,
                         blur_kernel=blur_kernel, chunk_fn=chunk_fn)
    for ci, (lo, n, chunk) in enumerate(chunks):
        frames[lo:lo + n] = chunk[:n]
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
        with span("wire.pin", bytes=dev.nbytes):
            self.host = torch.empty(dev.shape, dtype=dev.dtype,
                                    pin_memory=True)
            stream.wait_stream(torch.cuda.current_stream(dev.device))
            with torch.cuda.stream(stream):
                self.host.copy_(dev, non_blocking=True)
            dev.record_stream(stream)
            self.event = torch.cuda.Event()
            self.event.record(stream)

    def numpy(self) -> np.ndarray:
        """Block until the bytes arrived; the host array."""
        if self.event is not None:
            with span("wire.wait"):
                self.event.synchronize()
        return self.host.numpy()


def _in_flight(chunks):
    """(tag, host array) of each (tag, device frames) of ``chunks``, one
    chunk behind: chunk c+1 is dispatched and its copy queued
    (``_HostCopy``) before the host waits for chunk c's bytes."""
    stream = pending = None
    for tag, dev in chunks:
        if stream is None and dev.device.type == "cuda":
            stream = torch.cuda.Stream(dev.device)
        copy = _HostCopy(dev, stream)
        if pending is not None:
            yield pending[0], pending[1].numpy()
        pending = tag, copy
    if pending is not None:
        yield pending[0], pending[1].numpy()


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
                           blur_kernel=(1, 3, 3, 1),
                           chunk_fn=None) -> np.ndarray:
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
        blur_kernel=blur_kernel, chunk_fn=chunk_fn)[0]


@torch.inference_mode()
def decode_latents_stream(synthesis_params, s_r, feats, latent_iter, *,
                          size: int, decode_batch: int = 8,
                          compute_dtype=torch.float32,
                          uint8_transfer: bool = True, frame_callback=None,
                          first_chunk: int = 0, emit: str = "f32",
                          blur_kernel=(1, 3, 3, 1), chunk_fn=None):
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
    sizes = itertools.chain([first_chunk_size(first_chunk, fb) or fb],
                            itertools.repeat(fb))
    chunks = _run_chunks(synthesis_params, s_r, feats, latent_iter, sizes,
                         size=size, compute_dtype=compute_dtype,
                         out_u8=out_u8, blur_kernel=blur_kernel,
                         chunk_fn=chunk_fn)
    n_done = 0
    for (start, n), host in _in_flight(((start, n), dev)
                                       for start, n, dev in chunks):
        host = host[:n]
        if emit == "f32" and uint8_transfer:
            f32 = np.empty(host.shape, np.float32)
            _store(f32, host, True)
            host = f32
        n_done += 1
        if frame_callback is not None:
            frame_callback(n_done - 1, -1)
        yield start, host
        del host            # not held while the next chunks dispatch


@torch.inference_mode()
def decode_clips_to_host(synthesis_params, clips, *, size: int,
                         decode_batch: int = 8, compute_dtype=torch.float32,
                         uint8_transfer: bool = True, frame_callback=None,
                         blur_kernel=(1, 3, 3, 1), chunk_fn=None) -> list:
    """Decode several clips in one dispatch stream: ``clips`` = list of
    (s_r (1, dim_w), feats, r_d (T_i, dim_w)) -> list of (T_i, S, S, 3)
    float32 numpy arrays in [0, 1].

    Chunks of all clips share one in-flight copy overlap, so the device
    does not idle between clips.  Each clip's cast inputs are made when
    its first chunk is dispatched and dropped after its last, so N clips
    never hold N cast copies of their skip maps at once.
    ``frame_callback(i, n)`` fires as the i-th of all n chunks arrives."""
    plans = [chunk_sizes(r_d.shape[0], decode_batch) for _s, _f, r_d in clips]
    outs = [np.empty((r_d.shape[0], size, size, 3), np.float32)
            for _s, _f, r_d in clips]
    total = sum(map(len, plans))

    def chunks():
        for k, ((s_r, feats, r_d), sizes) in enumerate(zip(clips, plans)):
            for lo, n, dev in _run_chunks(
                    synthesis_params, s_r, feats, [r_d], sizes, size=size,
                    compute_dtype=compute_dtype, out_u8=uint8_transfer,
                    blur_kernel=blur_kernel, chunk_fn=chunk_fn):
                yield (k, lo, n), dev
    n_done = 0
    for (k, lo, n), host in _in_flight(chunks()):
        _store(outs[k][lo:lo + n], host[:n], uint8_transfer)
        del host            # chunk c's pinned buffer, free for c+2's copy
        n_done += 1
        if frame_callback is not None:
            frame_callback(n_done - 1, total)
    return outs
