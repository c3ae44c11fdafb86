"""Chunked autoregressive flow-matching sampling (twin of
``float_tpu.runtime.sampling``), as a Python loop over chunks:

    carry = (prev_x, prev_wa, prev_we)      # num_prev_frames of state
    per chunk:  x0 ~ N(0, I) (B, clip, dim_w)
                r_d_chunk = ODE(CFG vector field, x0, linspace(0, 1, nfe))
                carry <- last frames of (r_d_chunk, wa_chunk, we_chunk)

wa/we are edge-padded to whole chunks and the result is trimmed to T.

On a CUDA device a chunk's whole integration, every step of the ODE, is
replayed from a CUDA graph (``ChunkGraphs``, held by the FMT's
``ParamTree``): one graph launch in place of some hundreds of kernel
launches a step.  The graph is the eager chunk captured, so both give
the same numbers; the chunks run eagerly where no graph applies
(``chunk_graphs``).  ``CHUNK_COUNTS`` counts both kinds.
"""
from __future__ import annotations

import math
import threading
from collections import Counter, OrderedDict
from typing import Optional

import torch

from ..config import FloatConfig
from ..models.fmt import fmt_forward_cfg, infer_cfg_mode
from ..models.init import ParamTree
from ..ops import odeint_fixed
from ..utils.profiling import span

# sampler chunks by how they ran: "captures" (a chunk's graph made),
# "replays" (a chunk replayed from its graph), "eager" (op by op)
CHUNK_COUNTS: Counter = Counter()
_NEW_GRAPHS = threading.Lock()      # makes ChunkGraphs and capture streams
_CAPTURE_STREAMS: dict = {}         # device -> (its captures' stream, lock)


def pad_to_chunks(x, frames_per_clip: int, n_chunks: Optional[int] = None):
    """Right-pad (B, T, D) along T to whole chunks by edge replication
    (F.pad mode='replicate'); ``n_chunks`` pads to a larger count."""
    b, t, d = x.shape
    target = (n_chunks if n_chunks is not None
              else math.ceil(t / frames_per_clip)) * frames_per_clip
    if target == t:
        return x
    return torch.cat([x, x[:, -1:].expand(b, target - t, d)], dim=1)


def bucket_n_chunks(n: int) -> int:
    """Round a chunk count up to its bucket: 1..5 exact, then multiples of
    5.  Padded chunks trail the real ones, so bucketing is exact."""
    if n <= 5:
        return n
    return math.ceil(n / 5) * 5


def sampler_init_carry(b: int, cfg: FloatConfig, dtype=torch.float32,
                       device=None):
    """Zero autoregressive carry (prev_x, prev_wa, prev_we) for chunk 0."""
    prev = cfg.num_prev_frames
    return (torch.zeros(b, prev, cfg.dim_w, dtype=dtype, device=device),
            torch.zeros(b, prev, cfg.dim_w, dtype=dtype, device=device),
            torch.zeros(b, prev, cfg.dim_e, dtype=dtype, device=device))


def sample_motion_chunk(fmt_params, r_s, wa_t, we_t, carry, x0, *,
                        cfg: FloatConfig, a_cfg_scale, e_cfg_scale,
                        r_cfg_scale, nfe: int, ode_method: str,
                        cfg_mode: Optional[str]):
    """One autoregressive chunk of the CFG-ODE sampler.
    Returns (sample_t (B, clip, dim_w), new_carry)."""
    prev = cfg.num_prev_frames
    dynamic = we_t.shape[1] > 1
    prev_x, prev_wa, prev_we = carry

    def field(tt, zt):
        out = fmt_forward_cfg(
            fmt_params, tt.reshape(1), zt, wa_t, r_s, we_t, prev_x, prev_wa,
            prev_we if dynamic else None,
            a_cfg_scale=a_cfg_scale, e_cfg_scale=e_cfg_scale,
            r_cfg_scale=r_cfg_scale, include_r_cfg=cfg.include_r_cfg,
            cfg_mode=cfg_mode, depth=cfg.fmt_depth, num_heads=cfg.num_heads,
            attention_window=cfg.attention_window)
        return out[:, prev:]

    time_grid = torch.linspace(0.0, 1.0, nfe, device=x0.device)
    sample_t = odeint_fixed(field, x0, time_grid, method=ode_method)
    return sample_t, _next_carry(sample_t, wa_t, we_t, carry, prev)


def _next_carry(sample_t, wa_t, we_t, carry, prev: int):
    """The carry into the next chunk: the last ``prev`` frames of the
    chunk's sample and conditions (a static we carries on unchanged)."""
    new_prev_we = we_t[:, -prev:] if we_t.shape[1] > 1 else carry[2]
    return sample_t[:, -prev:], wa_t[:, -prev:], new_prev_we


def graph_key(r_s, wa_t, we_t, carry, x0, *, cfg: FloatConfig, nfe: int,
              ode_method: str, cfg_mode: str) -> tuple:
    """What a chunk's captured work depends on besides the weights: each
    input's shape and dtype (B, the chunk's length, num_prev_frames,
    whether we is dynamic), the device, nfe and the ODE method, the CFG
    mode (which passes the FMT makes), and the FMT's shape in ``cfg``.
    Neither the CFG scales (inputs of the graph), nor the chunk's index,
    nor the clip's length."""
    return (tuple((tuple(t.shape), t.dtype)
                  for t in (r_s, wa_t, we_t, x0, *carry)),
            x0.device, nfe, ode_method, cfg_mode, cfg.include_r_cfg,
            cfg.num_prev_frames, cfg.fmt_depth, cfg.num_heads,
            cfg.attention_window)


class _ChunkGraph:
    """``sample_motion_chunk`` captured as one CUDA graph over static
    copies of its inputs (r_s, wa_t, we_t, x0, *carry) and of its three
    CFG scales, run once on the device's capture stream before the
    capture, as capturing requires.  The scales are held in float64, as
    the Python numbers they copy are (``fmt._times`` rounds them as a
    kernel rounds a number), so replays give the eager chunk's numbers
    for any scales."""

    def __init__(self, fmt_params, inputs, scales, kw: dict):
        self.device = inputs[0].device
        self.inputs = [t.clone() for t in inputs]
        self.values = scales
        self.scales = torch.tensor(scales, dtype=torch.float64,
                                   device=self.device)
        r_s, wa_t, we_t, x0, *carry = self.inputs
        a_s, e_s, r_sc = self.scales

        def chunk():
            return sample_motion_chunk(
                fmt_params, r_s, wa_t, we_t, tuple(carry), x0,
                a_cfg_scale=a_s, e_cfg_scale=e_s, r_cfg_scale=r_sc, **kw)[0]
        side, lock = _capture_stream(self.device)
        with torch.cuda.device(self.device), lock:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                chunk()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.out = chunk()

    def __call__(self, inputs, scales) -> torch.Tensor:
        """The chunk's sample on ``inputs`` and ``scales``, in a tensor of
        its own (the next replay overwrites the static output)."""
        with torch.cuda.device(self.device):
            for static, t in zip(self.inputs, inputs):
                static.copy_(t)
            if scales != self.values:
                for static, v in zip(self.scales, scales):
                    static.fill_(v)
                self.values = scales
            self.graph.replay()
            return self.out.clone()


def _capture_stream(device):
    """The side stream every chunk graph of ``device`` is warmed up and
    captured on, one a device so that cuBLAS keeps one workspace for
    them (it keeps one a stream) however many graphs are made, and the
    lock that keeps two captures off it at once."""
    with _NEW_GRAPHS:
        if device not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[device] = (torch.cuda.Stream(device),
                                        threading.Lock())
        return _CAPTURE_STREAMS[device]


class ChunkGraphs:
    """The sampler chunks of one FMT as CUDA graphs, by ``graph_key``: the
    ``size`` keys used last (nfe and B may come with each request; the
    CFG scales are copied in and key nothing).  Held by the FMT's
    ``ParamTree`` (``chunk_graphs``), so the graphs and their memory
    pools go with the weights; weights moved to new storage drop them.
    ``lock`` covers one chunk's copy-in, replay and copy-out: the static
    buffers are shared by every caller."""

    def __init__(self, size: int = 4):
        self.size = size
        self.lock = threading.Lock()
        self.graphs: OrderedDict = OrderedDict()
        self.weights: tuple = ()        # the storage the graphs read

    def get(self, key, make):
        """The graph of ``key``, made by ``make()`` where there is none;
        the least recently used beyond ``size`` are dropped."""
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = make()
            CHUNK_COUNTS["captures"] += 1
            while len(self.graphs) > self.size:
                self.graphs.popitem(last=False)
        else:
            self.graphs.move_to_end(key)
        return graph

    def run(self, fmt_params, r_s, wa_t, we_t, carry, x0, *,
            cfg: FloatConfig, a_cfg_scale, e_cfg_scale, r_cfg_scale,
            nfe: int, ode_method: str, cfg_mode: Optional[str]):
        """``sample_motion_chunk(fmt_params, ...)``'s (sample_t, carry),
        the sample replayed from the chunk's graph (captured at its key's
        first use)."""
        scales = (float(a_cfg_scale), float(e_cfg_scale),
                  float(r_cfg_scale))
        kw = dict(cfg=cfg, nfe=nfe, ode_method=ode_method,
                  cfg_mode=cfg_mode or infer_cfg_mode(
                      scales[0], scales[2], scales[1], cfg.include_r_cfg))
        inputs = (r_s, wa_t, we_t, x0, *carry)
        key = graph_key(r_s, wa_t, we_t, carry, x0, **kw)
        weights = tuple(p.data_ptr() for p in fmt_params.parameters())
        with self.lock, torch.inference_mode(False), torch.no_grad():
            if weights != self.weights:
                self.graphs.clear()
                self.weights = weights
            graph = self.get(key, lambda: _ChunkGraph(fmt_params, inputs,
                                                      scales, kw))
            sample_t = graph(inputs, scales)
            CHUNK_COUNTS["replays"] += 1
        return sample_t, _next_carry(sample_t, wa_t, we_t, carry,
                                     cfg.num_prev_frames)


def chunk_graphs(fmt_params, device: torch.device) -> Optional[ChunkGraphs]:
    """The FMT's ``ChunkGraphs`` where CUDA graphs can replay its sampler
    chunks, else None (the chunks then run op by op): weights in a
    ``ParamTree`` held whole (a layer with ``tp_shards`` spans several
    devices), a CUDA device, and no capture already under way."""
    if (device.type != "cuda" or not isinstance(fmt_params, ParamTree)
            or any(m.tp_shards for m in fmt_params.modules())
            or torch.cuda.is_current_stream_capturing()):
        return None
    with _NEW_GRAPHS:
        if fmt_params.chunk_graphs is None:
            fmt_params.chunk_graphs = ChunkGraphs()
    return fmt_params.chunk_graphs


def sample_motion_chunks(fmt_params, r_s, wa, we, *, cfg: FloatConfig,
                         a_cfg_scale=None, e_cfg_scale=None,
                         r_cfg_scale=None, nfe: Optional[int] = None,
                         ode_method: Optional[str] = None,
                         cfg_mode: Optional[str] = None,
                         generator: Optional[torch.Generator] = None,
                         noise=None):
    """Yield the motion latents of each sampler chunk in order, each
    (B, clip, dim_w) in a tensor of its own; the last one runs past T =
    wa.shape[1] on edge-padded conditions.  Each chunk's noise and
    integration are a ``sample.chunk`` span (``utils.profiling``), closed
    before the chunk is yielded; its ``graphed`` is 1 where the chunk was
    replayed from a CUDA graph (``chunk_graphs``), else 0.

    Chunk noise comes from ``generator`` (drawn in f32 on wa's device, one
    chunk after another just before that chunk is integrated, then cast to
    wa's dtype) or from ``noise`` (n_chunks, B, clip, dim_w), which lets a
    test feed the JAX sampler and this one the same numbers."""
    a_s = cfg.a_cfg_scale if a_cfg_scale is None else a_cfg_scale
    e_s = cfg.e_cfg_scale if e_cfg_scale is None else e_cfg_scale
    r_sc = cfg.r_cfg_scale if r_cfg_scale is None else r_cfg_scale
    nfe = cfg.nfe if nfe is None else nfe
    method = cfg.ode_method if ode_method is None else ode_method

    b, t_frames, dim_w = wa.shape
    clip = cfg.num_frames_for_clip
    n_chunks = math.ceil(t_frames / clip)
    dynamic = we.shape[1] > 1
    wa_p = pad_to_chunks(wa, clip)
    we_p = pad_to_chunks(we, clip) if dynamic else we
    if noise is None:
        if generator is None:
            raise ValueError("pass either generator= or noise=")
    else:
        noise = torch.as_tensor(noise).to(device=wa.device, dtype=wa.dtype)
        if tuple(noise.shape) != (n_chunks, b, clip, dim_w):
            raise ValueError(f"noise shape {tuple(noise.shape)} != "
                             f"{(n_chunks, b, clip, dim_w)}")

    graphs = chunk_graphs(fmt_params, wa.device)
    kw = dict(cfg=cfg, a_cfg_scale=a_s, e_cfg_scale=e_s, r_cfg_scale=r_sc,
              nfe=nfe, ode_method=method, cfg_mode=cfg_mode)
    carry = sampler_init_carry(b, cfg, wa.dtype, wa.device)
    for c in range(n_chunks):
        with span("sample.chunk", index=c, frames=clip,
                  graphed=int(graphs is not None)):
            if noise is None:
                x0 = torch.randn((b, clip, dim_w), generator=generator,
                                 dtype=torch.float32,
                                 device=wa.device).to(wa.dtype)
            else:
                x0 = noise[c]
            sl = slice(c * clip, (c + 1) * clip)
            args = (fmt_params, r_s, wa_p[:, sl],
                    we_p[:, sl] if dynamic else we, carry, x0)
            if graphs is None:
                CHUNK_COUNTS["eager"] += 1
                sample_t, carry = sample_motion_chunk(*args, **kw)
            else:
                sample_t, carry = graphs.run(*args, **kw)
        yield sample_t


def sample_motion_latents(fmt_params, r_s, wa, we, **kw):
    """Motion latents r_d (B, T, dim_w) for T = wa.shape[1] frames: the
    chunks of ``sample_motion_chunks`` (same keywords) joined and trimmed
    to T."""
    chunks = list(sample_motion_chunks(fmt_params, r_s, wa, we, **kw))
    return torch.cat(chunks, dim=1)[:, :wa.shape[1]]
