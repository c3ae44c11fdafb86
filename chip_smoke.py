#!/usr/bin/env python3
"""Drive the PyTorch port (``float_torch``) once on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py [--parent DIR]

It needs one CUDA card and ``nvcc`` (the kernels are built from
``float_torch/kernels/csrc`` at first use, one nvcc per source, all at
once) and imports nothing of JAX nor of ``float_tpu``.  ``--parent DIR``
also times the kernels of another checkout (an unpacked ``git archive``
of the parent commit) in turns with these, through that checkout's own
wrappers.  Phases:

1. device: a CUDA card must be present;
2. build the hand-written kernels;
3. K1 (``warp_shared``) against its plain PyTorch version on the card, bit
   for bit, at every level of a 512² decode and every frame batch the
   driven paths give it (bf16: 24, 12, 8, 4, 1 and the mesh's shares 6,
   3, 2; float32, the Very
   Advanced tier's decode and its reference: 24, 12, 8, 4), on every
   grid kind of ``make_grid``: flows inside and far beyond its staged
   window, grids that leave the image, sparse far pixels in every tile,
   NaN and infinite entries (NaN at the same elements: a NaN coordinate
   makes its pixel NaN, as in float_tpu); timed at each level and batch
   beside its bound, and at 24 frames beside F.grid_sample;
3b. K7 (``styled_tail``) at each of the 27 calls of a 24-frame bf16 decode
   chunk of config 1 (the StyledConv tails and skip upsamplings, each
   with the modulations the decode has it write) against its plain
   version in f32, each timed beside its bytes bound and the plain bf16
   ops it replaces; every path below holds K7 to 27 launches for each
   chunk's 7 warps;
3c. K8 (``flow_merge``) at each of the 7 levels of that chunk (the last
   level's without a merged map) the same way; every path below holds K8
   to one launch for each chunk's K1 or K3 warp (none for K2's level);
3d. K9 (``fmt_block``) in each of its modes at config 1's sampler shapes
   (3 CFG rows of 60 frames, 1024 wide, 8 heads of 128, MLP 4096) against
   its plain version in f32, each timed beside its bytes bound and the
   plain ops it replaces; every path below holds K9 to 1 + 4 x 8 launches
   a sampler forward (its attention and GELU once a model rank), some on
   a path that samples and none on one that does not, and config 1's
   sampler in its other CFG modes, with a dynamic we and in bf16 to 297 a
   chunk;
4. the port on the card against the port on the CPU at a tiny config in
   float32 (TF32 off), stage by stage;
5. BASELINE config 1 end to end: 617.5 M synthetic parameters, a 512²
   portrait and 10 s of 16 kHz audio -> 250 frames, emotion predicted by
   the SER, 3-way CFG, 10 Euler steps, bf16 decode in 24-frame chunks;
   three timed clips (median), the launch counts of each checked;
5b. the decode's chunk graphs: config 1's decode of the clip replayed
   from its CUDA graphs against the same decode run op by op, frames
   bit for bit and launch counts by kernel and shape equal, every chunk
   replayed; both timed in turns, the clip and one 24-frame chunk alone;
6. the first decode chunk through the kernels and through the plain
   warps, and the largest tap displacement of its flows at each level;
7. K3 (``warp_per_frame``) at every level of a 512² decode and, through
   ``grid_sample_bilinear``, at channel counts that fill no 16-byte
   vector (an RGB image in bf16, C = 5 in float32), bit for bit, K2
   (``warp_rgb``) at the 128²..512² levels and K4's shapes through K1,
   all on every grid kind, each against its plain version,
   then each kernel's row of the kernel table: ms, plain ms, library ms
   and bound at config-1 shapes;
7b. the experiments: K5 (``warp_window``, the TPU's windowed
   selection-matmul warp as a gather on the CUDA cores) against its
   plain version at 128²x128, 256²x64 and 512²x32, 16 frames, on every
   grid kind, bit for bit with NaN at the same elements (the public
   ``warp_bilinear_windowed``'s overflow pixels against
   ``grid_sample_bilinear``), K6 (``fma_dtype``) in its three variants at
   64 and 1024 steps (f32 accumulators bit for bit, bf16 within one ulp);
   each experiment's path (one public call per level or variant) with
   its launch counts; K5 timed beside K3, F.grid_sample, its plain
   version, its bound and the parent commit's K5 (``--parent``); K6
   beside its plain chain and its bound; both entry points (``python -m
   float_torch.experiments.warp_selection_matmul``, ``...fma_dtype_bench``)
   as subprocesses;
8. config 1's other paths, each with its launch counts: a decode with the
   ToRGB in the last warp (K2), a one-frame-chunk decode (K3), decode to
   host, ``generate_stream`` on the u8 and 4:2:0 wires, and
   ``generate_batch`` of two portraits with 10 s and 6 s of audio; each
   decode gate has controls that must exceed it (the path's frames one
   place out of order; a chunk decoded with its warp grids rounded to
   bf16);
9. the checkpoint at full width: config 1's parameters written as a
   unified FLOAT.safetensors by the port's own writer into a temporary
   directory outside the repository, loaded by ``load_float_models`` onto
   the card, every tensor equal; then cut into the part files of
   ``extract_parts --all``, its audio folders made HF folders;
9b. readiness (``float_torch.tools.readiness_check``): the unified file,
   the part files and the HF folders loaded and held equal, then parity
   on the card in float32 against ``tests/fixtures/float_tpu_config1_f32
   .npz`` (float_tpu's stages at config 1's widths, recorded on the CPU),
   one line per stage, K1's launches in its decode counted (the
   ``parity`` path); two controls must fail the stage each names (the
   sampler fed the recorded noise in reversed chunk order: ``r_d``; the
   frames decoded with bf16 warp grids: ``frames``); the recorded latents
   decoded in bf16, which the reference's frame budget admits, are read
   and shown to differ from the float32 decode;
10. the Regular tier: ``example_workflows/graph_regular.json`` through the
   graph executor (LoadFloatModelsOpt reads that file; a 512² portrait
   and 10 s of audio as .npy inputs; VHS_VideoCombine writes its mp4 when
   the machine has cv2 or ffmpeg, else it is muted), its 250 frames
   against the loaded pipeline's ``generate(seed=15)``, K1's launches;
11. the Advanced tier: the split nodes on the loaded pipe, its frames
   against the graph's;
12. the Very Advanced tier: phase 9's part files and HF folders, the six
   loaders (widths inferred from the
   checkpoints, checked against the published ones) and the eight apply
   nodes with their adapters' arguments (ApplyFloatSynthesis: float32,
   8-frame chunks); its latents against the Advanced tier's, its frames
   against a float32 decode of those latents by the graph's pipeline and
   against the graph's bf16 frames;
13. the serving daemon: the unified file loaded by ``serve.load_pipe``
   (as ``serve`` loads it), ``FloatPipeline.warmup`` timed, ``make_server``
   on 127.0.0.1 driven by the port's ``FloatClient``: ``/health`` names the
   card; ``/v1/generate`` (an mp4 of 250 frames); the raw NDJSON stream
   (its frames equal to the in-process stream of the same request, and
   with ``generate(seed=15)``'s within the bf16 gate of a float32 decode
   of the same latents; time to the first line at the client, total,
   delivered frames/s, beside the in-process TTFC); the JPEG stream
   (against the in-process yuv420 stream's frames through the same JPEG
   codec); each request from a client process of its own;
   ``/v1/generate_batch`` of
   two portraits, 10 s + 6 s; ``/v1/graph`` with graph_regular.json;
   ``/metrics`` against what was sent; each with its launch counts; then
   admission (``max_pending`` 1: 503 with Retry-After) and a stalled
   reader (aborted, the lock freed, the next request served);
14. the CLI as subprocesses on the card: ``inspect`` of the unified file,
   ``generate`` and ``generate --stream`` (mp4s of 250 frames, wall time,
   first-frame latency);
15. the mesh mode (run after phase 8): config 1's ``generate``,
   ``generate_stream(first_chunk=4)`` and ragged ``generate_batch``
   through ``FloatPipeline(mesh=)``, (a) over four ranks of card 0 at 2x2
   and 1x4 (``make_mesh(devices=[cuda:0] * 4)``), always, and (b) over
   every card when there are two or more: r_d against one device's within
   ``MESH_RD_TOL``, frames within ``DECODE_TOL`` with the out-of-order
   control, K1 (K3 for one-frame shares) counted per shard;
16-18. as subprocesses on phase 9's unified file (``FLOAT_CKPT``), each
   with its wall time: ``python -m float_torch.bench --reps 10`` and
   ``--stream`` (finite values, 0 < mfu <= 1, ``vs_baseline`` null);
   ``float_torch.tools.configs_bench`` (the five BASELINE configs, every
   row finite); ``float_torch.tools.serve_load_bench`` with the base lane
   (2 x 2 requests of 4 s clips: no error), ``--overload`` (503s seen, the
   stalled reader aborted, the probe served) and ``--soak-sec 20`` (no
   error).  The temporary directory is then gone, and no checkpoint file
   is left in the repository.

A failed check is printed and the run goes on, so one run reports every
phase; the script then exits 1 before printing its result lines.
Output: one line per measurement, then a JSON line with every kernel's
numbers (K1's per level and batch under ``levels``), the card's name and
power limit as nvidia-smi reports them, and last the line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Tiny configs of the CPU parity tests (tests/test_pipeline.py's TINY).
TINY_AUDIO = dict(
    conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4)
# The seven synthesis levels of a 512² decode: (size, channels).
LEVELS = ((8, 512), (16, 512), (32, 512), (64, 256), (128, 128), (256, 64),
          (512, 32))
# K1's frame batches on the driven paths: 24-frame chunks, the 12- and
# 8-frame last chunks of 10 s and 6 s clips, the stream's 4-frame first
# chunk; and one frame.
K1_BATCHES = (24, 12, 8, 4, 1)
# K1's frame batches of the mesh paths (phase 15): a chunk's frames split
# over 4 ranks, 24 -> 6, 12 -> 3, 8 -> 2 (a share of 1 goes to K3); held to
# the plain version, not timed.
K1_MESH_BATCHES = (6, 3, 2)
# Sampling grids every shared-map kernel is held to its plain version on
# (make_grid): the staged kernels' windows, their device-memory fallback
# and coordinates that must never become an index.
GRID_KINDS = ("smooth", "far", "out", "mixed", "nonfinite")
# The experiments' kernels (phase 7b): K5 at the TPU experiment's levels
# and frame chunk on every grid kind of make_grid (all but "smooth" give
# overflow pixels), K6 at the probe's chain lengths.
K5_LEVELS = ((128, 128), (256, 64), (512, 32))
K5_BATCH = 16
K5_KINDS = GRID_KINDS
K6_STEPS = (64, 1024)
# K7's calls in one decode chunk of config 1, (mode, output size, C):
# conv1's plain tail, each level's up and plain StyledConv tails, and from
# the second level on its ToRGB and ToFlow skip upsamplings: 27 calls.
K7_CALLS = (("plain", 4, 512),) + tuple(
    (m, s, c) for s, c in LEVELS for m in ("up", "plain")) + tuple(
    (m, s, 3) for s, _ in LEVELS[1:] for m in ("rgb", "flow"))
# f32 operations an output element of each mode computes: the up tail's
# row sums (4 products, 3 sums) and the sum across rows (as many), the
# demodulation, bias and leaky ReLU (3) and its gain; the skip's four
# taps (a weight, a product and a sum each) and the biases around them.
K7_OPS = {"up": 18, "plain": 4, "rgb": 16, "flow": 13}
# The modulation each K7 call of the decode writes with its output:
# conv1's tail and each up tail their output modulated ("scale"), each
# level's plain tail its output and ToFlow's modulated input ("scale2"),
# but the last level's ToFlow's input alone, as nothing reads its map.
K7_EPILOGUE = {("plain", 4): "scale", ("plain", LEVELS[-1][0]): "scale",
               "up": "scale", "plain": "scale2"}
# K8's calls in one decode chunk of config 1, (mode, size, C): each
# level's merge with the next up conv's modulation, the last level's
# warped feature alone; and the f32 operations of an output element (the
# merge's product, difference, product, sum and modulation; the last
# level's product) beside the mask's sigmoid a pixel (K8_PIXEL_OPS).
K8_CALLS = tuple(("merge", s, c) for s, c in LEVELS[:-1]) + (
    ("last",) + LEVELS[-1],)
K8_OPS = {"merge": 5, "last": 1}
K8_PIXEL_OPS = 4
# K9's modes at config 1's sampler shapes: B CFG rows (3-way) of N frames,
# D wide, H heads of D / H, an MLP of F; a forward's calls of each mode
# (one ln_mod, then per block two gated residuals, the attention and the
# GELU) and its forwards a chunk (nfe - 1 Euler steps)
K9_SHAPE = dict(b=3, n=60, d=1024, heads=8, f=4096)
K9_CALLS = {"ln_mod": 1, "gate_res_ln_mod": 16, "attn": 8, "bias_gelu": 8}
K9_FORWARDS = 9
CUDA = "float_torch/kernels/csrc/"
ROWS = {   # kernel-table rows: the name the wrapper counts launches under
    "K1": {"name": "warp_shared", "route": "cuda",
           "source": CUDA + "warp_shared.cu",
           "replaces": "float_tpu/ops/pallas/shift_warp_v2.py:60"},
    "K2": {"name": "warp_rgb", "route": "cuda",
           "source": CUDA + "warp_rgb.cu",
           "replaces": "float_tpu/ops/pallas/shift_warp_v2.py:313"},
    "K3": {"name": "warp_per_frame", "route": "cuda",
           "source": CUDA + "warp_shared.cu",
           "replaces": "float_tpu/ops/pallas/shift_warp_kernel.py:34"},
    # K4's function is K1's for C <= 32 and B % 4 == 0: its launches are
    # warp_shared's at those shapes
    "K4": {"name": "warp_shared", "route": "cuda",
           "source": CUDA + "warp_shared.cu",
           "replaces": "float_tpu/ops/pallas/shift_warp_packed.py:35"},
    "K5": {"name": "warp_window", "route": "cuda",
           "source": CUDA + "warp_window.cu",
           "replaces": "experiments/pallas_warp_selection_matmul.py:36"},
    "K6": {"name": "fma_dtype", "route": "cuda",
           "source": CUDA + "fma_dtype.cu",
           "replaces": "experiments/vpu_dtype_bench.py:19"},
    # no TPU kernel: float_tpu leaves the blur and its neighbours to XLA
    "K7": {"name": "styled_tail", "route": "cuda",
           "source": CUDA + "styled_tail.cu", "replaces": None},
    # no TPU kernel: float_tpu leaves the merge to XLA
    "K8": {"name": "flow_merge", "route": "cuda",
           "source": CUDA + "flow_merge.cu", "replaces": None},
    # no TPU kernel: float_tpu leaves the FMT block's passes to XLA
    "K9": {"name": "fmt_block", "route": "cuda",
           "source": CUDA + "fmt_block.cu", "replaces": None},
}
NEW_KERNELS = ("warp_per_frame", "warp_rgb")
# Tolerances.  K1, K3 and K5 round every product and sum in their plain
# versions' order and are held to them bit for bit.  K2 sums its C->3
# contraction in another order than the plain matmul: 2^-7 (bf16, one
# rounding of f32 sums) or 1e-5 (f32) of max|feat| * max_o sum_c |wk[o, c]|.
BF16_TOL = 2.0 ** -7
RGB_F32_TOL = 1e-5
# Card vs CPU at the tiny f32 config: cuBLAS / cuDNN sum in other orders
# (about 1e-7 relative each), carried through 9 Euler steps and 3 CFG
# branches; 1e-3 absolute leaves two orders of magnitude of margin.
TINY_TOL = 1e-3
# bf16 decode, kernel vs plain warp, on [0, 1] frames; also a decode of
# other chunk sizes (cuDNN may pick other algorithms) or with the ToRGB in
# the warp against the default decode.
DECODE_TOL = 2e-2
# float32 decodes of the same latents in other chunk sizes: cuDNN may pick
# other algorithms (TF32 off), about 1e-6 of [0, 1]; a value that close to
# a rounding edge takes the other uint8 level (U8_STEP, added at the check).
F32_DECODE_TOL = 1e-4
# The Very Advanced tier decodes in float32, the graph in bf16: the bf16
# rounding of weights and activations carried through seven levels.
BF16_DECODE_TOL = 5e-2
# Motion latents of two tiers from one seed and the same noise: the same
# f32 sampler on inputs made by other node compositions.
LATENT_TOL = 1e-4
U8_STEP = 1.0 / 255.0
# The served raw stream against generate's uint8 of the same request, max
# |diff| in uint8 levels: two bf16 decodes of one clip in other chunkings
# (8 frames, then 24 from frame 8; 24 from frame 0), whose convolutions
# cuDNN sums in other orders.  Readings on an NVIDIA H100 80GB HBM3
# (700 W), stream as uint8 / 255 against generate's float frames:
# 1.515e-2 on phase 8's inputs, 2.665e-2 (6.8 levels) on the graph's
# portrait; 10 levels leave 1.5x over the larger.  Phase 13 holds two
# faults to it in every run, each of which must exceed it: the frames one
# place out of order, and the first chunk decoded with its warp grids
# rounded to bf16.
STREAM_TOL_LEVELS = 10
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 FLOP/s
# outside the tensor cores (the warps' multiply-adds run there).
HBM_BPS = 3.35e12
F32_FLOPS = 67e12

REPO = Path(__file__).resolve().parent
# float_tpu's stages at config 1's widths in float32, recorded on the CPU
# (tests/test_torch_fullwidth.py --record), which the readiness phase
# holds the port to
FIXTURE = REPO / "tests" / "fixtures" / "float_tpu_config1_f32.npz"

FAILURES: list = []
# kernel launches of every driven path, by path: {name: {kernel: n, "K4": n}}
PATHS: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        FAILURES.append(msg)
        log(f"[FAIL] {msg}")


def sync_time() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def event_ms(fn, *args, iters: int) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` launches, after a
    warm-up call."""
    fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, *args, iters: int) -> float:
    """Device time of one ``fn(*args)``: ``iters`` calls captured in one
    CUDA graph, replayed and event-timed, so the host's per-call overhead
    (the wrapper's checks, ctypes, the allocator) leaves no gaps between
    launches.  Launch counts taken here are not the main path's."""
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float):
    """(least ms, what bounds it): bytes over HBM rate vs f32 operations
    over the f32 rate."""
    tb, to = n_bytes / HBM_BPS * 1e3, n_ops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def warp_bound(feat, grid, c_out: int, ops_per_px: int,
               ops_per_map_px: int = 0):
    """Bound of one warp call: feat and grid read once, (B, H, W, c_out)
    written once, ``ops_per_px`` f32 operations per output pixel and
    ``ops_per_map_px`` per pixel of feat."""
    b, h, w = grid.shape[:3]
    esize = feat.element_size()
    n_bytes = (feat.numel() * esize + grid.numel() * 4
               + b * h * w * c_out * esize)
    n_map_px = feat.numel() // feat.shape[-1]
    return bound(n_bytes, b * h * w * ops_per_px + n_map_px * ops_per_map_px)


class Row:
    """One kernel-table row summed over the calls of a chunk or frame."""

    def __init__(self):
        self.ms = self.plain_ms = self.library_ms = 0.0
        self.parent_ms = None
        self.bound = {"bytes": 0.0, "operations": 0.0}

    def add(self, ms, plain_ms, library_ms, bnd, parent_ms=None):
        self.ms += ms
        self.plain_ms += plain_ms
        self.library_ms += library_ms
        self.bound[bnd[1]] += bnd[0]
        if parent_ms is not None:
            self.parent_ms = (self.parent_ms or 0.0) + parent_ms

    def json(self) -> dict:
        by = max(self.bound, key=self.bound.get)
        out = {"ms": self.ms, "plain_ms": self.plain_ms,
               "bound_ms": sum(self.bound.values()), "bound_by": by,
               "library_ms": self.library_ms}
        if self.parent_ms is not None:
            out["parent_ms"] = self.parent_ms
        return out


def timed(new, old=None, iters: int = 50):
    """(graph_ms of ``new``, of ``old`` or None): both zero-argument
    callables, ``old`` the parent commit's kernel, timed in turns
    (old, new, new, old) on the same inputs."""
    if old is None:
        return graph_ms(new, iters=iters), None
    t = [graph_ms(fn, iters=iters) for fn in (old, new, new, old)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2


def vs_parent(ms, parent_ms) -> str:
    if parent_ms is None:
        return ""
    return f", parent {parent_ms:.4f} ms ({parent_ms / ms:.2f}x)"


class ParentKernels:
    """K1, K2, K3 and K5 of another checkout (``root``, e.g. the parent
    commit unpacked by ``git archive``), called through that checkout's
    own wrappers: its ``float_torch`` is imported under another name, so
    its kernels (every library of its ``build.SOURCES``) are built from
    its own sources into its own ``build/`` and launched with its own C
    signatures, whatever they are."""

    NAME = "parent_float_torch"

    def __init__(self, root: str):
        import importlib
        import importlib.util
        from pathlib import Path
        pkg = Path(root).resolve() / "float_torch"
        spec = importlib.util.spec_from_file_location(
            self.NAME, pkg / "__init__.py",
            submodule_search_locations=[str(pkg)])
        sys.modules[self.NAME] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[self.NAME])
        kernels = f"{self.NAME}.kernels"
        self.shared, self.rgb, self.window, build = (
            importlib.import_module(f"{kernels}.{m}")
            for m in ("warp_shared", "warp_rgb", "warp_window", "build"))
        for mod in (self.shared, self.rgb, self.window, build):
            if not Path(mod.__file__).is_relative_to(pkg):
                raise RuntimeError(f"{mod.__name__} loaded from {mod.__file__}")
        build.build_all()

    def k1(self, feat, grid):
        return lambda: self.shared.warp_shared_cuda(feat, grid)

    def k3(self, feat, grid):
        return lambda: self.shared.warp_per_frame_cuda(feat, grid)

    def k2(self, feat, grid, wk):
        return lambda: self.rgb.warp_rgb_cuda(feat, grid, wk)

    def k5(self, feat, grid):
        return lambda: self.window.warp_window_cuda(feat, grid)


def grid_sample_call(feat, grid):
    """The one PyTorch call that computes a warp: F.grid_sample on the
    NCHW view of ``feat`` (expanded to B frames when shared).  It takes
    one dtype, so the grid is cast to feat's (outside the timing)."""
    b = grid.shape[0]
    x = feat.permute(0, 3, 1, 2).expand(b, -1, -1, -1)
    g = grid.to(feat.dtype)
    return lambda: F.grid_sample(x, g, mode="bilinear",
                                 padding_mode="zeros", align_corners=False)


def make_grid(kind: str, b: int, size: int, gen: torch.Generator):
    """Sampling grid (b, size, size, 2): pixel-centre identity plus a smooth
    random flow of a few px ("smooth"), of +-20 px ("far"), or a zoom-out
    whose taps leave the image ("out"); or the smooth grid with one pixel
    of every 8 x 8 cell sent anywhere in [-1.5, 1.5]^2, far outside any
    staged window ("mixed"), or with 3 % of its entries NaN, +inf or -inf
    ("nonfinite")."""
    if kind in ("mixed", "nonfinite"):
        grid = make_grid("smooth", b, size, gen)
        if kind == "mixed":
            n = size // 8
            cells = torch.arange(n, device="cuda") * 8
            ys = cells[None, :, None] + torch.randint(
                0, 8, (b, n, n), generator=gen, device="cuda")
            xs = cells[None, None, :] + torch.randint(
                0, 8, (b, n, n), generator=gen, device="cuda")
            bs = torch.arange(b, device="cuda")[:, None, None].expand_as(ys)
            grid[bs, ys, xs] = torch.rand((b, n, n, 2), generator=gen,
                                          device="cuda") * 3.0 - 1.5
        else:
            r = torch.rand(grid.shape, generator=gen, device="cuda")
            for i, bad in enumerate((math.nan, math.inf, -math.inf)):
                grid[(r >= 0.01 * i) & (r < 0.01 * (i + 1))] = bad
        return grid
    amp_px, zoom = {"smooth": (3.0, 1.0), "far": (20.0, 1.0),
                    "out": (5.0, 1.3)}[kind]
    coarse = max(2, size // 32)
    low = torch.randn((b, 2, coarse, coarse), generator=gen, device="cuda")
    low = low / low.abs().amax() * amp_px
    flow = torch.nn.functional.interpolate(low, size=(size, size),
                                           mode="bilinear",
                                           align_corners=False)
    ax = torch.linspace(-1 + 1 / size, 1 - 1 / size, size, device="cuda")
    gy, gx = torch.meshgrid(ax, ax, indexing="ij")
    ident = torch.stack([gx, gy], dim=-1) * zoom
    return (ident + flow.permute(0, 2, 3, 1) * (2.0 / size)).contiguous()


def max_displacement(grid) -> float:
    """Largest distance, in px on either axis, from an output pixel to the
    source coordinate its grid entry samples (finite entries only): what a
    staged window has to cover."""
    b, h, w = grid.shape[:3]
    fx = ((grid[..., 0].float() + 1.0) * w - 1.0) * 0.5
    fy = ((grid[..., 1].float() + 1.0) * h - 1.0) * 0.5
    dx = fx - torch.arange(w, device=grid.device)[None, None, :]
    dy = fy - torch.arange(h, device=grid.device)[None, :, None]
    d = torch.maximum(dx.abs(), dy.abs())
    return d[torch.isfinite(d)].max().item()


def rand_feat(gen, b, size, c, dtype):
    return torch.randn((b, size, size, c), generator=gen,
                       device="cuda").to(dtype)


def compare(name, out, ref, tol) -> float:
    """max|out - ref| off the NaN elements of ref, held to ``tol``; out
    must be NaN at exactly those elements (a NaN grid coordinate makes
    its pixel NaN, as in float_tpu).  Returns the error (inf where the
    shapes or the NaN elements differ)."""
    nan = ref.isnan()
    if out.shape != ref.shape or not torch.equal(out.isnan(), nan):
        err = math.inf
    elif ref.numel() == 0:
        err = 0.0
    else:
        diff = (out.float() - ref.float()).abs()
        # the same infinity on both sides is no error
        err = torch.where(nan | (out == ref), 0.0, diff).max().item()
    check(err <= tol, f"{name}: max|diff| {err} > {tol}, or NaN elsewhere")
    return err


def phase_kernels(gen: torch.Generator, parent=None) -> dict:
    """K1 against its plain version at every level, batch and grid kind
    (bit for bit), then its row: a 24-frame chunk's 7 levels, and each
    level at every batch of K1_BATCHES but 1 beside its bound (and the
    parent commit's build, ``parent``, timed in turns with it)."""
    from float_torch.ops.warp import warp_shared, warp_shared_ref

    max_err = 0.0
    for size, c in LEVELS:
        for dtype, batches in ((torch.bfloat16,
                                K1_BATCHES + K1_MESH_BATCHES),
                               (torch.float32, (24, 12, 8, 4))):
            feat = rand_feat(gen, 1, size, c, dtype)
            for b in batches:
                for kind in GRID_KINDS:
                    grid = make_grid(kind, b, size, gen)
                    err = compare(
                        f"warp_shared {size}²xC{c} B={b} {dtype} {kind}",
                        warp_shared(feat, grid), warp_shared_ref(feat, grid),
                        0.0)
                    max_err = max(max_err, err)
            log(f"[kernel] warp_shared {size}^2 C={c} {dtype}: equal to the "
                f"plain version on {', '.join(GRID_KINDS)} grids")
    row, levels = Row(), []
    for size, c in LEVELS:
        feat = rand_feat(gen, 1, size, c, torch.bfloat16)
        for b in K1_BATCHES[:-1]:
            grid = make_grid("smooth", b, size, gen)
            bnd = warp_bound(feat, grid, c, 8 * c)
            level = {"size": size, "c": c, "b": b, "bound_ms": bnd[0],
                     "bound_by": bnd[1]}
            # a few-microsecond call needs more launches to time steadily
            iters = 200 if b * size * size * c * 2 < 64 << 20 else 50
            ms, pms = timed(lambda: warp_shared(feat, grid),
                            parent and parent.k1(feat, grid), iters)
            level["ms"] = ms
            if pms is not None:
                level["parent_ms"] = pms
            levels.append(level)
            log(f"[kernel] warp_shared {size}^2 C={c} B={b} bf16: kernel "
                f"{ms:.4f} ms{vs_parent(ms, pms)}, bound {bnd[0]:.4f} ms "
                f"({bnd[1]}), {bnd[0] / ms:.1%} of bound")
            if b != 24:
                continue
            host = event_ms(warp_shared, feat, grid, iters=50)
            p = event_ms(warp_shared_ref, feat, grid, iters=5)
            lib = graph_ms(grid_sample_call(feat, grid), iters=50)
            row.add(ms, p, lib, bnd, pms)
            level.update(plain_ms=p, library_ms=lib)
            log(f"[kernel] warp_shared {size}^2 C={c} B=24 bf16: "
                f"{host:.4f} ms a call from Python, plain {p:.4f} ms, "
                f"F.grid_sample {lib:.4f} ms")
    bnd = sum(row.bound.values())
    log(f"[kernel] one 24-frame chunk's 7 warps: kernel {row.ms:.4f} ms"
        f"{vs_parent(row.ms, row.parent_ms)}, plain {row.plain_ms:.4f} ms, "
        f"F.grid_sample {row.library_ms:.4f} ms, bound {bnd:.4f} ms, "
        f"{bnd / row.ms:.1%} of bound")
    return dict(row.json(), max_abs_err=max_err, levels=levels)


def k7_epilogue(mode: str, size: int) -> str:
    """The modulation the decode has K7's call (mode, size) write:
    ``K7_EPILOGUE``'s, "" for a skip."""
    return K7_EPILOGUE.get((mode, size), K7_EPILOGUE.get(mode, ""))


def rand_scale(gen: torch.Generator, b: int, c: int, dtype) -> torch.Tensor:
    """A (b, c) modulation of the decode's magnitude (s / sqrt(fan-in))."""
    return ((torch.rand((b, c), generator=gen, device="cuda") + 0.5)
            * 0.1).to(dtype)


def k7_case(gen: torch.Generator, mode: str, size: int, c: int, b: int,
            dtype, epilogue: str = ""):
    """One K7 call of ``K7_CALLS`` at random values: (the dispatcher's
    call, the plain version's in ``dtype``, the plain version's in f32,
    x).  The up tail reads x (b, c, size + 1, size + 1), the others x
    (b, c, size, size); a skip (b, c, size / 2, size / 2); every map
    channels_last on the card.  A tail's ``epilogue``: "scale" modulates
    its output, "scale2" (the plain tail) returns it and its modulation
    (``styled_tail``'s scale and scale2)."""
    from float_torch.ops.tails import (skip_tail, skip_tail_ref,
                                       styled_tail, styled_tail_ref)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def cl(t):
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    n = size + (mode == "up")
    x = cl(rand(b, c, n, n))
    bias = rand(c, scale=0.5).to(dtype)
    if mode in ("up", "plain"):
        demod = torch.rand((b, c), generator=gen, device="cuda") + 0.5
        pad = (1, 1) if mode == "up" else None
        kw = {epilogue: rand_scale(gen, b, c, dtype)} if epilogue else {}
        kw32 = {k: v.float() for k, v in kw.items()}
        return (lambda: styled_tail(x, demod, bias, pad, **kw),
                lambda: styled_tail_ref(x, demod, bias, pad, **kw),
                lambda: styled_tail_ref(x.float(), demod, bias.float(), pad,
                                        **kw32),
                x)
    skip = cl(rand(b, c, size // 2, size // 2))
    act = rand(c, scale=0.5).to(dtype) if mode == "rgb" else None
    act32 = None if act is None else act.float()
    return (lambda: skip_tail(x, skip, bias, act),
            lambda: skip_tail_ref(x, skip, bias, act),
            lambda: skip_tail_ref(x.float(), skip.float(), bias.float(),
                                  act32),
            x)


def k7_error(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> float:
    """K7's output against its plain version in f32, as a share of the
    tolerance (at most 1 passes): f32 within 1e-5 x max|x| (sums in
    another order); bf16 within one bf16 rounding of a value that close,
    2^-8 of it.  inf where the shapes or the NaN elements differ; the
    same infinity on both sides is no error."""
    nan = want.isnan()
    if got.shape != want.shape or not torch.equal(got.isnan(), nan):
        return math.inf
    got, want = got[~nan].float(), want[~nan]
    if want.numel() == 0:
        return 0.0
    tol = 1e-5 * x[x.isfinite()].abs().max().float()
    if x.dtype == torch.bfloat16:
        tol = 2.0 ** -8 * (want.abs() + tol) + tol
    diff = torch.where(got == want, 0.0, (got - want).abs())
    return (diff / tol).max().item()


def outputs_error(got, want, x: torch.Tensor) -> float:
    """``k7_error`` of a call's one output map, or the largest over its
    tuple of them (None on both sides is no error)."""
    if not isinstance(want, tuple):
        return k7_error(got, want, x)
    if not isinstance(got, tuple) or len(got) != len(want):
        return math.inf
    return max(0.0 if w is None and g is None else
               math.inf if w is None or g is None else k7_error(g, w, x)
               for g, w in zip(got, want))


def k7_bound(mode: str, size: int, c: int, b: int, esize: int,
             epilogue: str = ""):
    """Bound of one K7 call: x and the skip read once, the output (and a
    scale2 call's second output) written once (the (B, C) demodulation,
    scales and biases are counted too)."""
    n_out = b * size * size * c
    n_in = b * (size + (mode == "up")) ** 2 * c
    n_skip = b * (size // 2) ** 2 * c if mode in ("rgb", "flow") else 0
    n_out2 = n_out if epilogue == "scale2" else 0
    n_bytes = ((n_in + n_out + n_out2 + n_skip) * esize + b * c * 4
               + 2 * c * esize + (b * c * esize if epilogue else 0))
    return bound(n_bytes, (n_out + n_out2) * K7_OPS[mode])


def phase_styled_tail(gen: torch.Generator) -> dict:
    """K7 at every call of a 24-frame bf16 decode chunk of config 1, with
    the modulations the decode has it write (``k7_epilogue``), against
    its plain version in f32 (``k7_error``), then its row: the chunk's 27
    calls, each timed beside its bound and the plain ops in bf16 (the
    sequence K7 replaces)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    row, calls, max_err = Row(), [], 0.0
    try:
        for mode, size, c in K7_CALLS:
            ep = k7_epilogue(mode, size)
            k7, plain, plain32, x = k7_case(gen, mode, size, c, 24,
                                            torch.bfloat16, ep)
            err = outputs_error(k7(), plain32(), x)
            max_err = max(max_err, err)
            check(err <= 1, f"styled_tail {mode}{ep and ' ' + ep} {size}^2 "
                  f"C={c}: {err:.3g} of its tolerance from the plain version "
                  f"in f32")
            bnd = k7_bound(mode, size, c, 24, x.element_size(), ep)
            iters = 200 if x.numel() * 2 < 64 << 20 else 50
            ms = graph_ms(k7, iters=iters)
            p = event_ms(plain, iters=5)
            row.add(ms, p, 0.0, bnd)
            calls.append({"mode": mode, "epilogue": ep, "size": size, "c": c,
                          "ms": ms, "plain_ms": p, "bound_ms": bnd[0],
                          "bound_by": bnd[1]})
            log(f"[kernel] styled_tail {mode}{ep and ' ' + ep} {size}^2 C={c} "
                f"B=24 bf16: "
                f"kernel {ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
                f"{bnd[0] / ms:.1%} of bound; plain {p:.4f} ms; error "
                f"{err:.3g} of its tolerance")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    bnd = sum(row.bound.values())
    log(f"[kernel] one 24-frame chunk's {len(K7_CALLS)} styled tails: kernel "
        f"{row.ms:.4f} ms, plain {row.plain_ms:.4f} ms, bound {bnd:.4f} ms, "
        f"{bnd / row.ms:.1%} of bound")
    return dict(row.json(), max_err=max_err, calls=calls)


def k8_case(gen: torch.Generator, mode: str, size: int, c: int, b: int,
            dtype, warp: str = "shared", mask: str = "smooth"):
    """One K8 call of ``K8_CALLS`` at random values: (the dispatcher's
    call, the plain version's in ``dtype``, the plain version's in f32,
    x), each returning (feat_warp, merged or None).  warped is K1's output
    of one (1, size, size, c) map (``warp`` "shared") or K3's of b maps
    ("per_frame") on a smooth grid; ToFlow's raw output (b, 3, size,
    size) channels_last, as K7's skip writes it, its mask channel N(0, 4)
    ("smooth") or +-40 ("saturated": a mask of 0 or 1); the merge
    modulated by a (b, c) scale, none for the last level."""
    from float_torch.ops.tails import flow_merge, flow_merge_ref
    from float_torch.ops.warp import warp_per_frame, warp_shared

    def cl(t):
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    feat = rand_feat(gen, 1 if warp == "shared" else b, size, c, dtype)
    grid = make_grid("smooth", b, size, gen)
    warped = (warp_shared if warp == "shared" else warp_per_frame)(
        feat, grid).permute(0, 3, 1, 2)
    x = cl(torch.randn((b, c, size, size), generator=gen, device="cuda"))
    z = torch.randn((b, 3, size, size), generator=gen, device="cuda")
    out = cl(z * 2.0 if mask == "smooth" else torch.sign(z) * 40.0)
    scale = None if mode == "last" else rand_scale(gen, b, c, dtype)
    s32 = None if scale is None else scale.float()
    xk = None if scale is None else x       # the last level reads no x
    return (lambda: flow_merge(warped, out, xk, scale),
            lambda: flow_merge_ref(warped, out, xk, scale),
            lambda: flow_merge_ref(warped.float(), out.float(), x.float(),
                                   s32),
            x)


def k8_bound(mode: str, size: int, c: int, b: int, esize: int):
    """Bound of one K8 call: the maps it needs read once and its outputs
    written once (the merge: warped and x read, feat_warp and merged
    written; the last level: warped read, feat_warp written), with the
    mask channel and the (B, C) scale."""
    px = b * size * size
    maps = 4 if mode == "merge" else 2
    n_bytes = (maps * px * c + px + (b * c if mode == "merge" else 0)) * esize
    return bound(n_bytes, px * (c * K8_OPS[mode] + K8_PIXEL_OPS))


def phase_flow_merge(gen: torch.Generator) -> dict:
    """K8 at every level of a 24-frame bf16 decode chunk of config 1
    against its plain version in f32 (``outputs_error``), then its row:
    the chunk's 7 calls, each timed beside its bound and the plain ops in
    bf16 (the sequence K8 replaces)."""
    row, calls, max_err = Row(), [], 0.0
    for mode, size, c in K8_CALLS:
        k8, plain, plain32, x = k8_case(gen, mode, size, c, 24,
                                        torch.bfloat16)
        err = outputs_error(k8(), plain32(), x)
        max_err = max(max_err, err)
        check(err <= 1, f"flow_merge {mode} {size}^2 C={c}: {err:.3g} of its "
              f"tolerance from the plain version in f32")
        bnd = k8_bound(mode, size, c, 24, x.element_size())
        iters = 200 if x.numel() * 2 < 64 << 20 else 50
        ms = graph_ms(k8, iters=iters)
        p = event_ms(plain, iters=5)
        row.add(ms, p, 0.0, bnd)
        calls.append({"mode": mode, "size": size, "c": c, "ms": ms,
                      "plain_ms": p, "bound_ms": bnd[0], "bound_by": bnd[1]})
        log(f"[kernel] flow_merge {mode} {size}^2 C={c} B=24 bf16: kernel "
            f"{ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"{bnd[0] / ms:.1%} of bound; plain {p:.4f} ms; error {err:.3g} "
            f"of its tolerance")
    bnd = sum(row.bound.values())
    log(f"[kernel] one 24-frame chunk's {len(K8_CALLS)} flow merges: kernel "
        f"{row.ms:.4f} ms, plain {row.plain_ms:.4f} ms, bound {bnd:.4f} ms, "
        f"{bnd / row.ms:.1%} of bound")
    return dict(row.json(), max_err=max_err, calls=calls)


def k9_case(gen: torch.Generator, mode: str, b: int):
    """One K9 call of ``mode`` at config 1's sampler shapes with ``b`` CFG
    rows, on random values: (the kernel's call, the plain version's)."""
    from float_torch.kernels import fmt_block as k9
    from float_torch.models.fmt import alignment_bias
    from float_torch.ops import fmt_block as ops
    n, d, heads, f = (K9_SHAPE[k] for k in ("n", "d", "heads", "f"))

    def r(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")
    if mode == "attn":
        args = (r(b, n, 3 * d), r(3 * d, scale=0.1),
                alignment_bias(n, n, 2, torch.device("cuda")), heads)
        return lambda: k9.attn_cuda(*args), lambda: ops.attn_ref(*args)
    if mode == "bias_gelu":
        args = (r(b, n, f), r(f, scale=0.1))
        return (lambda: k9.bias_gelu_cuda(*args),
                lambda: ops.bias_gelu_ref(*args))
    mod, mb = r(b, n, 6 * d, scale=0.3).chunk(6, -1), r(
        6 * d, scale=0.1).chunk(6)
    if mode == "ln_mod":
        args = (r(b, n, d), mod[0], mb[0], mod[1], mb[1])
        return lambda: k9.ln_mod_cuda(*args), lambda: ops.ln_mod_ref(*args)
    args = (r(b, n, d), r(b, n, d), r(d, scale=0.1), mod[2], mb[2], mod[3],
            mb[3], mod[4], mb[4])
    return (lambda: k9.gate_res_ln_mod_cuda(*args),
            lambda: ops.gate_res_ln_mod_ref(*args))


def k9_bound(mode: str, b: int):
    """Bound of one K9 call: f32 inputs read once and outputs written
    once (an adaLN slice, a bias, a (B, N, D) map each once), and for the
    attention its q.k and p.v multiply-adds."""
    n, d, heads, f = (K9_SHAPE[k] for k in ("n", "d", "heads", "f"))
    rows = b * n
    if mode == "attn":
        floats, ops = 4 * rows * d + 3 * d + n * n, 4 * b * n * n * d
    elif mode == "bias_gelu":
        floats, ops = 2 * rows * f + f, 8 * rows * f
    elif mode == "ln_mod":
        floats, ops = 4 * rows * d + 2 * d, 10 * rows * d
    else:
        floats, ops = 7 * rows * d + 4 * d, 14 * rows * d
    return bound(4 * floats, ops)


# K9 against its plain version in f32, relative to max|plain| of the output
# (tests/test_fmt_fused.py's tolerances and their reasons): the ln modes
# and the attention 1e-5, the GELU 1e-6; x' of gate_res_ln_mod bit for bit
K9_TOL = {"ln_mod": 1e-5, "gate_res_ln_mod": 1e-5, "attn": 1e-5,
          "bias_gelu": 1e-6}


def k9_error(mode: str, got, want) -> float:
    """max|K9 - plain| / max|plain| of the output (the modulated LN for
    gate_res_ln_mod, whose x' has to equal the plain x' bit for bit)."""
    if mode == "gate_res_ln_mod":
        check(torch.equal(got[0], want[0]),
              "fmt_block gate_res_ln_mod: x' differs from the plain x'")
        got, want = got[1], want[1]
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_fmt_block(gen: torch.Generator) -> dict:
    """K9's row: each mode at config 1's 3-way shapes against its plain
    version in f32 (``K9_TOL``), then timed beside its bound and the plain
    ops it replaces, summed over a sampler forward's 33 calls.  No one
    PyTorch call does a mode's work, so the row has no library time."""
    row, calls, max_err = Row(), [], 0.0
    b = K9_SHAPE["b"]
    for mode, count in K9_CALLS.items():
        kernel, plain = k9_case(gen, mode, b)
        err = k9_error(mode, kernel(), plain())
        max_err = max(max_err, err / K9_TOL[mode])
        check(err <= K9_TOL[mode], f"fmt_block {mode}: {err:.3g} of max|plain| "
              f"from the plain version in f32, over {K9_TOL[mode]}")
        ms, p = graph_ms(kernel, iters=200), graph_ms(plain, iters=200)
        bnd = k9_bound(mode, b)
        for _ in range(count):
            row.add(ms, p, 0.0, bnd)
        calls.append({"mode": mode, "calls": count, "ms": ms, "plain_ms": p,
                      "bound_ms": bnd[0], "bound_by": bnd[1], "error": err})
        log(f"[kernel] fmt_block {mode} B={b} N={K9_SHAPE['n']} f32: kernel "
            f"{ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"{bnd[0] / ms:.1%} of bound; plain {p:.4f} ms ({p / ms:.2f}x); "
            f"{count} a forward; error {err:.3g} of max|plain|")
    bnd = sum(row.bound.values())
    log(f"[kernel] one 3-way sampler forward's {sum(K9_CALLS.values())} K9 "
        f"calls: kernel {row.ms:.4f} ms, plain {row.plain_ms:.4f} ms, bound "
        f"{bnd:.4f} ms; a chunk ({K9_FORWARDS} forwards) {row.ms * K9_FORWARDS:.3f}"
        f" ms against {row.plain_ms * K9_FORWARDS:.3f} ms plain")
    # max_err: the largest error as a share of its mode's tolerance
    return dict(row.json(), library_ms=None, max_err=max_err, calls=calls)


def phase_kernel_variants(gen: torch.Generator, parent=None) -> dict:
    """K3 (bit for bit), K2 and K4's shapes against their plain versions
    on every grid kind, then their rows of the kernel table at config-1
    shapes (each in turns with the parent commit's build, ``parent``,
    when given)."""
    from float_torch.ops.warp import (warp_per_frame, warp_per_frame_ref,
                                      warp_rgb, warp_rgb_ref, warp_shared,
                                      warp_shared_ref)
    errs = {"K2": 0.0, "K3": 0.0, "K4": 0.0}

    for size, c in LEVELS:
        for dtype in (torch.bfloat16, torch.float32):
            for b in (1, 4):
                feat = rand_feat(gen, b, size, c, dtype)
                for kind in GRID_KINDS:
                    grid = make_grid(kind, b, size, gen)
                    errs["K3"] = max(errs["K3"], compare(
                        f"warp_per_frame {size}²xC{c} B={b} {dtype} {kind}",
                        warp_per_frame(feat, grid),
                        warp_per_frame_ref(feat, grid), 0.0))
        log(f"[kernel] warp_per_frame {size}^2 C={c}: equal to the plain "
            f"version (bf16 and f32, B 1 and 4, {', '.join(GRID_KINDS)})")
    # channels that fill no 16-byte vector (an RGB image at a size the TPU
    # kernel takes), one channel a thread, through grid_sample_bilinear
    from float_torch.kernels import LAUNCHES
    from float_torch.ops.warp import (grid_sample_bilinear,
                                      grid_sample_bilinear_ref)
    for size, c, dtype in ((256, 3, torch.bfloat16), (64, 5, torch.float32)):
        feat = rand_feat(gen, 2, size, c, dtype).permute(0, 3, 1, 2)
        for kind in GRID_KINDS:
            grid = make_grid(kind, 2, size, gen)
            before = LAUNCHES["warp_per_frame"]
            out = grid_sample_bilinear(feat, grid)
            check(LAUNCHES["warp_per_frame"] == before + 1,
                  f"grid_sample_bilinear C={c} {dtype}: K3 not launched")
            errs["K3"] = max(errs["K3"], compare(
                f"grid_sample_bilinear {size}²xC{c} B=2 {dtype} {kind}", out,
                grid_sample_bilinear_ref(feat, grid), 0.0))
        log(f"[kernel] warp_per_frame {size}^2 C={c} {dtype}: K3 through "
            f"grid_sample_bilinear equal to the plain version")

    for size, c in ((128, 128), (256, 64), (512, 32)):
        wk = torch.randn((3, c), generator=gen, device="cuda") / math.sqrt(c)
        wnorm = wk.abs().sum(1).max().item()
        for dtype, batches in ((torch.bfloat16, (24, 12, 4)),
                               (torch.float32, (4,))):
            feat = rand_feat(gen, 1, size, c, dtype)
            tol = (BF16_TOL if dtype == torch.bfloat16 else RGB_F32_TOL) \
                * feat.float().abs().max().item() * wnorm
            for b in batches:
                for kind in GRID_KINDS:
                    grid = make_grid(kind, b, size, gen)
                    errs["K2"] = max(errs["K2"], compare(
                        f"warp_rgb {size}²xC{c} B={b} {dtype} {kind}",
                        warp_rgb(feat, grid, wk), warp_rgb_ref(feat, grid, wk),
                        tol))
        log(f"[kernel] warp_rgb {size}^2 C={c}: agrees with the plain version")

    feat = rand_feat(gen, 1, 512, 32, torch.bfloat16)
    for kind in GRID_KINDS:
        grid = make_grid(kind, 8, 512, gen)
        errs["K4"] = max(errs["K4"], compare(
            f"warp_shared (K4 shapes) 512²xC32 B=8 {kind}",
            warp_shared(feat, grid), warp_shared_ref(feat, grid), 0.0))
    log("[kernel] warp_shared at K4's shapes (512^2 C=32 B=8): equal")

    rows = {k: Row() for k in ("K2", "K3", "K4")}
    # K3: one frame's 7 warps (a one-frame decode chunk)
    for size, c in LEVELS:
        feat = rand_feat(gen, 1, size, c, torch.bfloat16)
        grid = make_grid("smooth", 1, size, gen)
        k, pk = timed(lambda: warp_per_frame(feat, grid),
                      parent and parent.k3(feat, grid), iters=200)
        host = event_ms(warp_per_frame, feat, grid, iters=200)
        p = event_ms(warp_per_frame_ref, feat, grid, iters=10)
        lib = graph_ms(grid_sample_call(feat, grid), iters=200)
        bnd = warp_bound(feat, grid, c, 8 * c)
        rows["K3"].add(k, p, lib, bnd, pk)
        log(f"[kernel] warp_per_frame {size}^2 C={c} B=1 bf16: kernel "
            f"{k:.4f} ms{vs_parent(k, pk)} ({host:.4f} ms a call from "
            f"Python), plain {p:.4f} "
            f"ms, F.grid_sample {lib:.4f} ms, bound {bnd[0]:.5f} ms "
            f"({bnd[1]})")
    # K2: the last level of a 24-frame chunk
    feat = rand_feat(gen, 1, 512, 32, torch.bfloat16)
    grid = make_grid("smooth", 24, 512, gen)
    wk = torch.randn((3, 32), generator=gen, device="cuda") / math.sqrt(32)
    w4 = wk.to(torch.bfloat16)[:, :, None, None]
    gs = grid_sample_call(feat, grid)
    k, pk = timed(lambda: warp_rgb(feat, grid, wk),
                  parent and parent.k2(feat, grid, wk))
    p = event_ms(warp_rgb_ref, feat, grid, wk, iters=5)
    lib = graph_ms(lambda: F.conv2d(gs(), w4), iters=50)
    k1 = graph_ms(warp_shared, feat, grid, iters=50)
    # the least work of the function: warp and 1x1 conv commute, so the
    # map is contracted to 3 channels once (3 C multiply-adds a map pixel)
    # and 3 channels are warped (4 taps x 3 multiply-adds an output pixel)
    bnd = warp_bound(feat, grid, 3, 2 * 4 * 3, ops_per_map_px=2 * 3 * 32)
    rows["K2"].add(k, p, lib, bnd, pk)
    log(f"[kernel] warp_rgb 512^2 C=32 B=24 bf16: kernel {k:.4f} ms"
        f"{vs_parent(k, pk)}, {bnd[0] / k:.1%} of bound; plain "
        f"{p:.4f} ms, F.grid_sample + F.conv2d {lib:.4f} ms, bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}); warp_shared alone {k1:.4f} ms")
    # K4: its own shapes, 8 frames at 512² C=32
    grid = make_grid("smooth", 8, 512, gen)
    k, pk = timed(lambda: warp_shared(feat, grid),
                  parent and parent.k1(feat, grid))
    p = event_ms(warp_shared_ref, feat, grid, iters=5)
    lib = graph_ms(grid_sample_call(feat, grid), iters=50)
    bnd = warp_bound(feat, grid, 32, 8 * 32)
    rows["K4"].add(k, p, lib, bnd, pk)
    log(f"[kernel] warp_shared (K4 shapes) 512^2 C=32 B=8 bf16: kernel "
        f"{k:.4f} ms{vs_parent(k, pk)}, plain {p:.4f} ms, F.grid_sample "
        f"{lib:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
        f"{bnd[0] / k:.1%} of bound")
    k3 = rows["K3"]
    log(f"[kernel] warp_per_frame, one frame's 7 warps: kernel "
        f"{k3.ms:.4f} ms{vs_parent(k3.ms, k3.parent_ms)}, F.grid_sample "
        f"{k3.library_ms:.4f} ms, bound {sum(k3.bound.values()):.5f} ms")
    return {k: dict(rows[k].json(), max_abs_err=errs[k]) for k in rows}


def phase_experiments(gen: torch.Generator, parent=None) -> dict:
    """Phase 7b.  K5 against its plain version at the TPU experiment's
    levels and chunk on every grid kind (bit for bit, NaN at the same
    elements; the public function's overflow pixels against
    grid_sample_bilinear), K6's three variants against their plain chains
    at both chain lengths (f32 accumulators bit for bit, bf16 within one
    ulp); then each experiment's path with its launch counts, each
    kernel's times beside its bound (K5 in turns with the parent commit's
    build, ``parent``, when given), and both entry points as
    subprocesses."""
    from float_torch.experiments import fma_dtype_bench as fb
    from float_torch.experiments import warp_selection_matmul as ws
    from float_torch.kernels.warp_window import warp_window_cuda
    from float_torch.ops.warp import grid_sample_bilinear, warp_per_frame

    b = K5_BATCH
    errs = {"K5": 0.0, "K6": 0.0}
    maps, smooth = {}, {}
    for size, c in K5_LEVELS:
        feat = rand_feat(gen, b, size, c, torch.bfloat16)
        nchw = feat.permute(0, 3, 1, 2)
        maps[size] = feat
        for kind in K5_KINDS:
            grid = make_grid(kind, b, size, gen)
            if kind == "smooth":
                smooth[size] = grid
            gy, gx = grid[..., 1], grid[..., 0]
            ovf = ws.overflow_mask(size, size, gy, gx, 8, 64)
            n_ovf = int(ovf.sum().item())
            name = f"warp_window {size}²xC{c} B={b} {kind}"
            check(kind == "smooth" or n_ovf > 0, f"{name}: no overflow pixel")
            out = warp_window_cuda(feat, grid)
            plain = ws.warp_bilinear_windowed_ref(nchw, grid) \
                .permute(0, 2, 3, 1)
            errs["K5"] = max(errs["K5"], compare(name, out, plain, 0.0))
            n_nan = int(plain.isnan().any(-1).sum().item())
            check((n_nan > 0) == (kind == "nonfinite"),
                  f"{name}: {n_nan} NaN pixels")
            m = ovf[..., None].expand_as(out)
            pub = ws.warp_bilinear_windowed(nchw, grid).permute(0, 2, 3, 1)
            exact = grid_sample_bilinear(nchw, grid).permute(0, 2, 3, 1)
            compare(f"{name}: warp_bilinear_windowed against K5", pub, out,
                    0.0)
            compare(f"{name}: overflow pixels against grid_sample_bilinear",
                    pub[m], exact[m], 0.0)
            log(f"[experiment] {name}: overflow px {n_ovf} "
                f"({n_ovf / ovf.numel():.2%}), NaN px {n_nan}; equal to the "
                "plain version")
    variants = {}
    for steps in K6_STEPS:
        for label, dtype, acc in fb.VARIANTS:
            x = torch.randn((fb.TILES, *fb.TILE), generator=gen,
                            device="cuda").to(dtype)
            out = fb.make(dtype, acc, steps)(x)
            ref = fb.fma_chain_ref(x, acc, steps)
            name = f"fma_dtype {label.strip()} {steps} steps"
            if acc == torch.float32:
                check(torch.equal(out, ref), f"{name}: not bit for bit")
                n_off = 0
            else:
                ulps = ws.bf16_ulps(out, ref)
                check(ulps.max().item() <= 1, f"{name}: {ulps.max().item()} "
                      "bf16 ulps from the plain chain")
                n_off = int((ulps > 0).sum().item())
            errs["K6"] = max(errs["K6"],
                             (out.float() - ref.float()).abs().max().item())
            variants[(steps, label)] = (dtype, acc)
            log(f"[experiment] {name}: {n_off} of {x.numel()} elements "
                "differ from the plain chain")

    # the experiments' paths: one call of each public function per level
    # and variant, every count at 0 before
    run_path("experiment warp_selection_matmul", lambda: [
        ws.warp_bilinear_windowed(maps[size].permute(0, 3, 1, 2),
                                  smooth[size]) for size, _ in K5_LEVELS],
             {"warp_window": len(K5_LEVELS)}, 0, sampled=False)
    calls = [(fb.make(dtype, acc), torch.ones((fb.TILES, *fb.TILE),
                                               dtype=dtype, device="cuda"))
             for _, dtype, acc in fb.VARIANTS]
    run_path("experiment fma_dtype_bench",
             lambda: [run(x) for run, x in calls],
             {"fma_dtype": len(fb.VARIANTS)}, 0, sampled=False)

    rows = {"K5": Row(), "K6": Row()}
    levels = []
    for size, c in K5_LEVELS:
        feat, grid = maps[size], smooth[size]
        nchw = feat.permute(0, 3, 1, 2)
        # F.grid_sample on the NCHW map warp_bilinear_windowed takes, its
        # grid in the map's dtype (cast outside the timing)
        nchw_c, grid_bf16 = nchw.contiguous(), grid.to(torch.bfloat16)
        k5, pk5 = timed(lambda: warp_window_cuda(feat, grid),
                        parent and parent.k5(feat, grid))
        k3 = graph_ms(lambda: warp_per_frame(feat, grid), iters=50)
        lib = graph_ms(lambda: F.grid_sample(
            nchw_c, grid_bf16, mode="bilinear", padding_mode="zeros",
            align_corners=False), iters=50)
        p = event_ms(ws.warp_bilinear_windowed_ref, nchw, grid, iters=3)
        bnd = warp_bound(feat, grid, c, 8 * c)
        rows["K5"].add(k5, p, lib, bnd, pk5)
        level = {"size": size, "c": c, "b": b, "ms": k5, "k3_ms": k3,
                 "plain_ms": p, "library_ms": lib, "bound_ms": bnd[0],
                 "bound_by": bnd[1]}
        if pk5 is not None:
            level["parent_ms"] = pk5
        levels.append(level)
        log(f"[experiment] warp_window {size}^2 C={c} B={b} bf16 smooth: "
            f"K5 {k5:.4f} ms{vs_parent(k5, pk5)} ({bnd[0] / k5:.1%} of "
            f"bound), K3 {k3:.4f} ms, F.grid_sample {lib:.4f} ms, plain "
            f"{p:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    k5 = rows["K5"]
    log(f"[experiment] warp_window, the three levels: K5 {k5.ms:.4f} ms"
        f"{vs_parent(k5.ms, k5.parent_ms)}, F.grid_sample "
        f"{k5.library_ms:.4f} ms, bound {sum(k5.bound.values()):.4f} ms "
        f"({sum(k5.bound.values()) / k5.ms:.1%})")
    probes = []
    for (steps, label), (dtype, acc) in variants.items():
        run = fb.make(dtype, acc, steps)
        x = torch.randn((fb.TILES, *fb.TILE), generator=gen,
                        device="cuda").to(dtype)
        k6 = graph_ms(lambda: run(x), iters=20)
        p = event_ms(fb.fma_chain_ref, x, acc, steps, iters=2)
        bnd = fb.bound(x.numel(), dtype, acc, steps)
        if steps == fb.N_OPS:
            rows["K6"].add(k6, p, 0.0, bnd)
        probes.append({"variant": label.strip(), "steps": steps, "ms": k6,
                       "plain_ms": p, "bound_ms": bnd[0],
                       "bound_by": bnd[1]})
        log(f"[experiment] fma_dtype {label} {steps} steps: K6 {k6:.4f} ms "
            f"({bnd[0] / k6:.1%} of bound), plain {p:.3f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
    for steps in K6_STEPS:
        a, bb, cc = (p["ms"] for p in probes if p["steps"] == steps)
        log(f"[experiment] fma_dtype {steps} steps: bf16-acc speedup vs "
            f"f32-acc {a / cc:.2f}x, vs bf16-in/f32-acc {bb / cc:.2f}x")

    # the two entry points as a user runs them
    for name, want in (("warp_selection_matmul", len(K5_LEVELS)),
                       ("fma_dtype_bench", len(K6_STEPS))):
        _, out, secs = run_tool(name, [f"float_torch.experiments.{name}"],
                                REPO, None, 120.0)
        lines = [x for x in out.splitlines()
                 if x.startswith(("bf16-acc", *(f"{s}^2" for s, _ in
                                                K5_LEVELS)))]
        check(len(lines) == want, f"{name} printed {len(lines)} of its "
              f"{want} result lines:\n{out}")
        log(f"[experiment] python -m float_torch.experiments.{name}: "
            f"{secs:.1f} s")
        log(out.strip())
    k6 = dict(rows["K6"].json(), library_ms=None, probes=probes)
    return {"K5": dict(rows["K5"].json(), max_abs_err=errs["K5"],
                       levels=levels),
            "K6": dict(k6, max_abs_err=errs["K6"])}


def stage_chain(pipe, img, wave, noise) -> dict:
    from float_torch.runtime.pipeline import audio_num_frames
    s_r, lam, feats, r_s = pipe.encode_image(img)
    wa = pipe.encode_audio(wave, audio_num_frames(wave.shape[-1], pipe.cfg))
    we = pipe.emotion_latent(wave, "none")
    r_d = pipe.sample(r_s, wa, we, noise=noise)
    frames = pipe.decode(s_r, feats, r_d)
    return {"s_r": s_r, "r_s_lambda": lam, "r_s": r_s, "wa": wa, "we": we,
            "r_d": r_d, "frames": frames}


def phase_tiny() -> None:
    from float_torch.config import FloatConfig, Wav2Vec2Config
    from float_torch.runtime.pipeline import (audio_num_frames,
                                              build_synthetic_pipeline)
    w2v = Wav2Vec2Config(**TINY_AUDIO, feat_extract_norm="group",
                         conv_bias=False, do_stable_layer_norm=False)
    ser = Wav2Vec2Config(**TINY_AUDIO, feat_extract_norm="layer",
                         conv_bias=True, do_stable_layer_norm=True,
                         num_labels=7)
    cfg = FloatConfig(input_size=64, dim_w=64, dim_a=64, dim_h=64, dim_m=20,
                      dim_e=7, fmt_depth=2, num_heads=4, wav2vec_sec=0.4,
                      num_prev_frames=3, decode_batch=4,
                      compute_dtype="float32")
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, 3, 64, 64)).astype(np.float32) * 0.3
    wave = rng.standard_normal((1, 16000)).astype(np.float32) * 0.1
    t = audio_num_frames(wave.shape[-1], cfg)
    clip = cfg.num_frames_for_clip
    noise = rng.standard_normal(
        (math.ceil(t / clip), 1, clip, cfg.dim_w)).astype(np.float32)
    outs = {dev: stage_chain(build_synthetic_pipeline(cfg, w2v, ser,
                                                      device=dev),
                             img, wave, noise)
            for dev in ("cpu", "cuda")}
    for name, ref in outs["cpu"].items():
        got = outs["cuda"][name].float().cpu()
        err = (got - ref.float()).abs().max().item()
        log(f"[tiny] {name}: card vs cpu max|diff| {err:.3e}")
        check(got.shape == ref.shape and err <= TINY_TOL,
              f"tiny stage {name}: card vs cpu {err} > {TINY_TOL}")


def k4_launches(shapes: dict) -> int:
    """warp_shared launches at K4's shapes (C <= 32, B % 4 == 0)."""
    return sum(n for (name, b, _h, _w, c), n in shapes.items()
               if name == "warp_shared" and c <= 32 and b % 4 == 0)


def phase_config1() -> dict:
    from float_torch.config import FloatConfig
    from float_torch.kernels import LAUNCH_SHAPES, LAUNCHES
    from float_torch.runtime.pipeline import (audio_num_frames,
                                              build_synthetic_pipeline)

    cfg = FloatConfig(compute_dtype="bfloat16", decode_batch=24)
    # the kernel phases leave the allocator's cache cut to their shapes
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe = build_synthetic_pipeline(cfg)
    n_params = sum(p.numel() for p in pipe.params.parameters())
    log(f"[config1] {n_params / 1e6:.1f} M parameters on {pipe.device}, built "
        f"in {sync_time() - t0:.1f} s")
    # bench.py's inputs
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, 3, 512, 512)).astype(np.float32) * 0.3
    wave = rng.standard_normal((1, 160000)).astype(np.float32) * 0.1
    t_frames = audio_num_frames(wave.shape[-1], cfg)
    img_d = torch.from_numpy(img).cuda()
    wave_d = torch.from_numpy(wave).cuda()

    t0 = sync_time()
    pipe.generate(img_d, wave_d, emotion="none", seed=15)
    log(f"[config1] warm-up generate {sync_time() - t0:.3f} s")

    # per-stage split, each stage synchronised
    t0 = sync_time()
    s_r, _lam, feats, r_s = pipe.encode_image(img_d)
    t1 = sync_time()
    wa = pipe.encode_audio(wave_d, t_frames)
    t2 = sync_time()
    we = pipe.emotion_latent(wave_d, "none")
    t3 = sync_time()
    r_d = pipe.sample(r_s, wa, we, seed=15)
    t4 = sync_time()
    staged = pipe.decode(s_r, feats, r_d)
    t5 = sync_time()
    stages = {"encode_image": t1 - t0, "encode_audio": t2 - t1,
              "emotion": t3 - t2, "sample": t4 - t3, "decode": t5 - t4}
    for k, v in stages.items():
        log(f"[config1] stage {k}: {v * 1e3:.1f} ms")

    torch.cuda.reset_peak_memory_stats()
    latencies, runs, shapes = [], [], []
    for _ in range(3):
        LAUNCHES.clear()
        LAUNCH_SHAPES.clear()
        t0 = sync_time()
        frames = pipe.generate(img_d, wave_d, emotion="none", seed=15)
        latencies.append(sync_time() - t0)
        runs.append(dict(LAUNCHES))
        shapes.append(dict(LAUNCH_SHAPES))
    launches = runs[0]
    launches_k4 = k4_launches(shapes[0])
    PATHS["generate"] = dict(launches, K4=launches_k4)
    check(all(r == launches for r in runs), f"launch counts differ: {runs}")
    latency = sorted(latencies)[1]
    log(f"[config1] clip latency {latency:.4f} s (median of "
        f"{[round(x, 4) for x in latencies]}) for {t_frames} frames: "
        f"{t_frames / latency:.2f} frames/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
        f"launches {launches}")

    check(tuple(frames.shape) == (t_frames, 512, 512, 3),
          f"frames shape {tuple(frames.shape)}")
    check(bool(torch.isfinite(frames).all()), "non-finite frames")
    lo, hi = frames.min().item(), frames.max().item()
    check(0.0 <= lo and hi <= 1.0, f"frames outside [0, 1]: {lo}..{hi}")
    n_chunks = math.ceil(t_frames / cfg.decode_batch)
    want = len(LEVELS) * n_chunks
    check(launches.get("warp_shared", 0) == want,
          f"warp_shared launched {launches} times in the timed run, "
          f"expected {want}")
    # every chunk's 512² C=32 level; all chunk sizes are multiples of 4
    check(launches_k4 == n_chunks,
          f"warp_shared launched {launches_k4} times at K4's shapes, "
          f"expected {n_chunks}")
    check(launches.get("styled_tail", 0) == len(K7_CALLS) * n_chunks,
          f"styled_tail launched {launches} times in the timed run, "
          f"expected {len(K7_CALLS) * n_chunks}")
    check(k8_launches(launches) == len(K8_CALLS) * n_chunks
          and k8_launches_fit(launches),
          f"flow_merge launched {launches} times in the timed run, "
          f"expected {len(K8_CALLS) * n_chunks}, one last level a chunk")
    check(not any(launches.get(k, 0) for k in NEW_KERNELS),
          f"the default generate launched {launches}, expected only "
          f"warp_shared")
    n_sample = math.ceil(t_frames / cfg.num_frames_for_clip)
    per_chunk = K9_FORWARDS * sum(K9_CALLS.values())
    check(k9_launches(launches) == per_chunk * n_sample
          and k9_launches_fit(launches),
          f"K9 launched {k9_launches(launches)} times in the timed run, "
          f"expected {per_chunk} for each of {n_sample} sampler chunks")
    rerun = (frames - staged).abs().max().item()
    log(f"[config1] timed run vs stage-by-stage run: max|diff| {rerun:.3e}")
    check(rerun <= DECODE_TOL, f"generate vs stage chain differ by {rerun}")

    # 6. first decode chunk, kernel warps vs plain warps, both on the card
    from float_torch.ops.warp import DISPATCH, PLAIN
    from float_torch.runtime.decode import decode_chunk
    wa_c = (s_r.float() + r_d[0, :cfg.decode_batch]).to(pipe.compute_dtype)
    feats_c = [f.to(pipe.compute_dtype) for f in feats]
    disp = {}

    def shared_recorded(feat, grid):
        disp[grid.shape[1]] = max_displacement(grid)
        return DISPATCH.shared(feat, grid)

    with torch.inference_mode():
        a = decode_chunk(pipe.syn_cast, wa_c, feats_c, 512,
                         warps=DISPATCH._replace(shared=shared_recorded))
        b = decode_chunk(pipe.syn_cast, wa_c, feats_c, 512, warps=PLAIN)
    log("[decode] first chunk's flows, max displacement of a tap from its "
        "output pixel (px): " + ", ".join(f"{s}^2 {d:.2f}"
                                          for s, d in sorted(disp.items())))
    diff = (a - b).abs()
    log(f"[decode] first chunk, kernel vs plain warp: max|diff| "
        f"{diff.max().item():.3e}, mean|diff| {diff.mean().item():.3e}")
    check(diff.max().item() <= DECODE_TOL,
          f"decode chunk kernel vs plain {diff.max().item()} > {DECODE_TOL}")
    return {"pipe": pipe, "img": img_d, "wave": wave_d, "frames": frames,
            "s_r": s_r, "feats": feats, "r_d": r_d, "launches": launches,
            "launches_k4": launches_k4}


def phase_decode_graphs(c1: dict) -> None:
    """Config 1's decode replayed from its chunk graphs against the same
    decode op by op (``decode.decode_graphs`` giving None): the clip's
    frames bit for bit, the launch counts of both (the graph's counted
    per replay), every chunk replayed; both timed in turns, the clip and
    one 24-frame chunk alone."""
    from float_torch.kernels import LAUNCH_SHAPES, LAUNCHES
    from float_torch.runtime import decode as dm
    from float_torch.utils import profiling
    pipe, s_r, feats, r_d = c1["pipe"], c1["s_r"], c1["feats"], c1["r_d"]
    real = dm.decode_graphs
    nb = pipe.cfg.decode_batch

    def run(graphed: bool, rows=None):
        dm.decode_graphs = real if graphed else (lambda *a: None)
        try:
            return pipe.decode(s_r, feats, r_d if rows is None
                               else r_d[:, :rows])
        finally:
            dm.decode_graphs = real

    out, counts = {}, {}
    for graphed in (False, True):
        LAUNCHES.clear()
        LAUNCH_SHAPES.clear()
        profiling.tracing_on()
        try:
            out[graphed] = run(graphed)
            torch.cuda.synchronize()
            spans = [s for s in profiling.take().spans
                     if s.name == "decode.chunk"]
        finally:
            profiling.tracing_off()
        counts[graphed] = (dict(LAUNCHES), dict(LAUNCH_SHAPES))
        flags = [s.attrs["graphed"] for s in spans]
        check(flags == [int(graphed)] * len(spans),
              f"decode graphed={graphed}: chunks' graphed {flags}")
    check(torch.equal(out[True], out[False]),
          "the replayed decode's frames differ from the eager decode's")
    check(counts[True] == counts[False],
          f"launches replayed {counts[True][0]} != eager {counts[False][0]}")
    ms = {False: [], True: []}
    for graphed in (True, False, False, True, True, False):
        for rows in (None, nb):
            t0 = sync_time()
            run(graphed, rows)
            ms[graphed].append((sync_time() - t0) * 1e3)
    clip = {g: sorted(v[0::2])[1] for g, v in ms.items()}
    chunk = {g: sorted(v[1::2])[1] for g, v in ms.items()}
    log(f"[graphs] decode of the clip replayed vs eager: frames equal, "
        f"launches {counts[True][0]} on both; clip {clip[True]:.1f} vs "
        f"{clip[False]:.1f} ms, one {nb}-frame chunk {chunk[True]:.2f} vs "
        f"{chunk[False]:.2f} ms (medians of 3, in turns)")


def u8_levels(a, b) -> tuple:
    """max and mean |a - b| of two uint8 stacks (numpy or torch), in
    levels, on the card."""
    d = (torch.as_tensor(a).cuda().int() - torch.as_tensor(b).cuda().int()
         ).abs()
    return int(d.max().item()), d.float().mean().item()


def k7_launches_fit(launches: dict) -> bool:
    """Each 512² decode chunk warps 7 times (K1 or K3, K2 for the last
    level with ``rgb_in_kernel``) and launches K7 27 times."""
    warps = sum(launches.get(k, 0)
                for k in ("warp_shared", "warp_per_frame", "warp_rgb"))
    return launches.get("styled_tail", 0) * len(LEVELS) \
        == warps * len(K7_CALLS)


def k8_names() -> tuple:
    """K8's launch names: the merge's and the last level's."""
    from float_torch.kernels import flow_merge
    return flow_merge.NAME, flow_merge.NAME_LAST


def k8_launches(launches: dict) -> int:
    return sum(launches.get(k, 0) for k in k8_names())


def k8_launches_fit(launches: dict) -> bool:
    """Each 512² decode chunk merges once a K1 or K3 warp (none at K2's
    level): 6 merges with the next level's modulation and one last
    level's, which K2's level takes instead."""
    warps = sum(launches.get(k, 0) for k in ("warp_shared", "warp_per_frame"))
    chunks, odd = divmod(warps + launches.get("warp_rgb", 0), len(LEVELS))
    return (not odd and k8_launches(launches) == warps
            and launches.get(k8_names()[0], 0)
            == (len(LEVELS) - 1) * chunks)


def k9_names() -> tuple:
    from float_torch.kernels import fmt_block
    return fmt_block.NAMES


def k9_launches(launches: dict) -> int:
    return sum(launches.get(k, 0) for k in k9_names())


def k9_launches_fit(launches: dict, sampled: bool | None = None) -> bool:
    """Each sampler forward of config 1's FMT (8 blocks) launches K9's
    ln_mod once and, each block, two gated residuals and the attention
    and the GELU once a model rank, in every sampler dtype; ``sampled``:
    the path ran the sampler on the card (K9 launched) or did not (none),
    None where the count alone decides."""
    from float_torch.kernels import fmt_block as k9
    depth = 8
    ln, res, att, gelu = (launches.get(k, 0) for k in (
        k9.LN_MOD, k9.GATE_RES_LN_MOD, k9.ATTN, k9.BIAS_GELU))
    return (res == 2 * depth * ln and att == gelu
            and att % max(depth * ln, 1) == 0 and (att > 0) == (ln > 0)
            and (sampled is None or sampled == (ln > 0)))


def run_path(name: str, fn, want: dict, want_k4: int,
             sampled: bool | None = None):
    """Run ``fn`` with every launch count at 0 before it; check the counts
    read right after against ``want`` (kernels not named must be 0), the
    warp_shared launches at K4's shapes against ``want_k4`` and K9's
    against ``k9_launches_fit(..., sampled)``.
    Returns (result, seconds, counts)."""
    from float_torch.kernels import LAUNCH_SHAPES, LAUNCHES
    LAUNCHES.clear()
    LAUNCH_SHAPES.clear()
    t0 = sync_time()
    out = fn()
    secs = sync_time() - t0
    got = {k: v for k, v in LAUNCHES.items() if v}
    k4 = k4_launches(LAUNCH_SHAPES)
    PATHS[name] = dict(got, K4=k4)
    check(k7_launches_fit(got),
          f"{name}: {got.get('styled_tail', 0)} styled_tail launches, "
          f"expected {len(K7_CALLS)} for each decode chunk's "
          f"{len(LEVELS)} warps")
    check(k8_launches_fit(got),
          f"{name}: flow_merge launches {[got.get(k, 0) for k in k8_names()]}, "
          f"expected one for each decode chunk's K1 or K3 warp, the last "
          f"level's without a merged map")
    k9 = {k: got.get(k, 0) for k in k9_names()}
    check(k9_launches_fit(got, sampled),
          f"{name}: K9 launches {k9}, expected 1 + 4 x 8 a sampler forward "
          f"(attention and GELU once a model rank)"
          + {True: ", and some", False: ", and none", None: ""}[sampled])
    for k in ("styled_tail",) + k8_names() + k9_names():
        got.pop(k, None)
    check(got == {k: v for k, v in want.items() if v},
          f"{name}: launches {got}, expected {want}")
    check(k4 == want_k4,
          f"{name}: {k4} launches at K4's shapes, expected {want_k4}")
    log(f"[path] {name}: {secs * 1e3:.1f} ms, launches {got}, of which at "
        f"K4's shapes (C <= 32, B % 4 == 0) {k4}; K9 {sum(k9.values())} "
        f"({sum(k9.values()) / (K9_FORWARDS * sum(K9_CALLS.values())):g} "
        f"sampler chunks' worth)")
    return out, secs, got


def check_frames(name: str, got, ref, tol: float,
                 ref_name: str = "generate") -> None:
    got = torch.as_tensor(got).float().to(ref.device)
    lo, hi = got.min().item(), got.max().item()
    check(bool(torch.isfinite(got).all()) and 0.0 <= lo and hi <= 1.0,
          f"{name}: frames not finite or outside [0, 1]: {lo}..{hi}")
    err = (got - ref).abs().max().item() if got.shape == ref.shape \
        else float("inf")
    log(f"[path] {name}: {tuple(got.shape)} frames vs {ref_name}'s max|diff| "
        f"{err:.3e} (tol {tol:.3g})")
    check(err <= tol, f"{name}: vs {ref_name} max|diff| {err} > {tol}")


def out_of_order(name: str, got, ref, tol: float) -> None:
    """A control of a decode gate: ``got``'s frames one place out of order
    against ``ref`` must exceed ``tol``, or the gate could not see such a
    fault."""
    got = torch.as_tensor(got).float().to(ref.device)
    err = (got[1:] - ref[:-1]).abs().max().item()
    log(f"[path] {name}: control, frames one place out of order: max|diff| "
        f"{err:.3e} (must exceed {tol:.3g})")
    check(err > tol, f"{name}: frames out of order pass the gate ({err} <= "
          f"{tol})")


def bf16_grid_warps():
    """The decode's warps with every shared-map grid rounded to bf16 (up
    to half a pixel at 512²): a fault the decode gates must see."""
    from float_torch.ops.warp import DISPATCH
    return DISPATCH._replace(shared=lambda f, g: DISPATCH.shared(
        f, g.to(torch.bfloat16).float()))


def decode_first_chunk(pl, s_r, feats, r_d, nb: int, out_u8=False, **kw):
    """``r_d``'s first ``nb`` frames decoded as one chunk of the decode
    loops (``decode._run_chunks``: their cast of the latents and the skip
    maps), ``kw`` passed on to ``decode_chunk`` (``warps=``)."""
    import functools
    from float_torch.runtime.decode import _run_chunks, decode_chunk
    with torch.inference_mode():
        (_start, _n, out), = _run_chunks(
            pl.syn_cast, s_r, feats, [r_d[:nb]], [nb],
            size=pl.cfg.input_size, compute_dtype=pl.compute_dtype,
            out_u8=out_u8, chunk_fn=functools.partial(decode_chunk, **kw))
    return out


def phase_paths(c1: dict) -> dict:
    """Config 1's other paths through the entry points a user calls; each
    gate against ``generate``'s frames with its controls."""
    from float_torch.ops.yuv420 import i420_to_rgb_u8, rgb01_to_i420
    from float_torch.runtime.decode import decode_latents
    pipe, frames = c1["pipe"], c1["frames"]
    s_r, feats, r_d = c1["s_r"], c1["feats"], c1["r_d"][0]
    t_frames = r_d.shape[0]
    size = pipe.cfg.input_size
    n_chunks = math.ceil(t_frames / pipe.cfg.decode_batch)
    n_lv = int(math.log2(size)) - 2
    counts = {}

    def decode(**kw):
        args = dict(size=size, decode_batch=pipe.cfg.decode_batch,
                    compute_dtype=pipe.compute_dtype)
        args.update(kw)
        with torch.inference_mode():
            return decode_latents(pipe.syn_cast, s_r, feats, r_d, **args)

    # the last level's warp + ToRGB as one kernel, A/B against the default
    ms = {False: [], True: []}
    for rgb in (False, True, True, False):
        t0 = sync_time()
        decode(rgb_in_kernel=rgb)
        ms[rgb].append((sync_time() - t0) * 1e3)
    log(f"[path] decode of the clip, ToRGB in the warp vs not (alternating):"
        f" {ms[True]} vs {ms[False]} ms")
    out, _, counts["rgb_in_kernel"] = run_path(
        "decode rgb_in_kernel=True", lambda: decode(rgb_in_kernel=True),
        {"warp_shared": (n_lv - 1) * n_chunks, "warp_rgb": n_chunks}, 0,
        sampled=False)
    check_frames("decode rgb_in_kernel=True", out, frames, DECODE_TOL)
    out_of_order("decode rgb_in_kernel=True", out, frames, DECODE_TOL)

    # one-frame decode chunks: every level warps per frame (K3)
    out, secs, counts["decode_batch=1"] = run_path(
        "decode decode_batch=1", lambda: decode(decode_batch=1),
        {"warp_per_frame": n_lv * t_frames}, 0, sampled=False)
    log(f"[path] decode_batch=1: {t_frames} frames in {secs:.3f} s, "
        f"{t_frames / secs:.2f} frames/s")
    check_frames("decode decode_batch=1", out, frames, DECODE_TOL)
    out_of_order("decode decode_batch=1", out, frames, DECODE_TOL)

    out, _, counts["decode_to_host"] = run_path(
        "decode_to_host", lambda: pipe.decode_to_host(s_r, feats, r_d),
        {"warp_shared": n_lv * n_chunks}, n_chunks, sampled=False)
    check_frames("decode_to_host", out, frames, DECODE_TOL + U8_STEP)
    out_of_order("decode_to_host", out, frames, DECODE_TOL + U8_STEP)
    # the gate's other control: generate's first chunk decoded again with
    # its warp grids rounded to bf16
    nb = pipe.cfg.decode_batch
    coarse = decode_first_chunk(pipe, s_r, feats, r_d, nb,
                                warps=bf16_grid_warps())
    err = (coarse - frames[:nb]).abs().max().item()
    log(f"[path] control, generate's first chunk with bf16 warp grids: max"
        f"|diff| {err:.3e} (must exceed DECODE_TOL {DECODE_TOL:.3g})")
    check(err > DECODE_TOL, f"a chunk with bf16 warp grids passes "
          f"DECODE_TOL ({err} <= {DECODE_TOL})")

    def stream(wire):
        t0 = time.perf_counter()
        parts, first = [], None
        for _start, part in pipe.generate_stream(
                c1["img"], c1["wave"], emotion="none", seed=15,
                first_chunk=4, wire=wire):
            first = first or time.perf_counter() - t0
            parts.append(part)
        return parts, first, time.perf_counter() - t0

    n_disp = 1 + (t_frames - 4) // pipe.cfg.decode_batch \
        + bool((t_frames - 4) % pipe.cfg.decode_batch)
    ref_yuv = rgb01_to_i420(frames).cpu().numpy().astype(np.int16)
    for wire in ("u8", "yuv420"):
        (parts, ttfc, total), _, counts[f"stream {wire}"] = run_path(
            f"generate_stream wire={wire}", lambda: stream(wire),
            {"warp_shared": n_lv * n_disp}, n_disp, sampled=True)
        log(f"[path] generate_stream wire={wire} first_chunk=4: first chunk "
            f"({parts[0].shape[0]} frames) after {ttfc * 1e3:.1f} ms, all "
            f"{t_frames} frames after {total * 1e3:.1f} ms")
        got = np.concatenate(parts)
        if wire == "u8":
            check_frames("generate_stream u8", got.astype(np.float32) / 255.0,
                         frames, DECODE_TOL + U8_STEP)
        else:
            err = int(np.abs(got.astype(np.int16) - ref_yuv).max()) \
                if got.shape == ref_yuv.shape else 10 ** 9
            log(f"[path] generate_stream yuv420: {got.shape} vs generate's "
                f"4:2:0 planes max|diff| {err} LSB")
            check(err <= 255 * DECODE_TOL + 1,
                  f"generate_stream yuv420 vs generate: {err} LSB")
            rgb = i420_to_rgb_u8(got)
            check(rgb.shape == (t_frames, size, size, 3),
                  f"i420_to_rgb_u8 shape {rgb.shape}")

    # two portraits, 10 s and 6 s of audio, in one call
    rng = np.random.default_rng(1)
    img2 = torch.from_numpy(rng.standard_normal((1, 3, size, size))
                            .astype(np.float32) * 0.3).to(pipe.device)
    imgs = torch.cat([c1["img"], img2])
    n6 = 6 * pipe.cfg.sampling_rate
    waves = [c1["wave"][0], c1["wave"][0, :n6] * 0.8]
    t2 = math.ceil(n6 * pipe.cfg.fps / pipe.cfg.sampling_rate)
    n_b = n_chunks + math.ceil(t2 / pipe.cfg.decode_batch)
    outs, secs, counts["generate_batch"] = run_path(
        "generate_batch 10 s + 6 s", lambda: pipe.generate_batch(imgs, waves),
        {"warp_shared": n_lv * n_b}, n_b, sampled=True)
    log(f"[path] generate_batch: {t_frames + t2} frames in {secs:.3f} s, "
        f"{(t_frames + t2) / secs:.2f} frames/s")
    with torch.inference_mode():
        ref2 = pipe.generate(img2, waves[1][None], emotion="none",
                             seed=pipe.cfg.seed + 1)
    check(len(outs) == 2, f"generate_batch returned {len(outs)} clips")
    check_frames("generate_batch clip 0", outs[0], frames,
                 DECODE_TOL + U8_STEP)
    check_frames("generate_batch clip 1", outs[1], ref2, DECODE_TOL + U8_STEP)
    c1["batch"] = (imgs, waves, outs)
    return counts


def phase_sampler_paths(c1: dict) -> dict:
    """Config 1's sampler in its 3-way, 4-way and skip CFG modes, with a
    dynamic we (config 4's) and in bf16 (config 3's sampler_dtype A/B),
    each replayed: K9's launches, 297 a chunk."""
    from float_torch.runtime import sampling
    pipe = c1["pipe"]
    cfg = pipe.cfg
    sdt = pipe.sampler_dtype
    with torch.inference_mode():
        _s_r, _lam, _feats, r_s = pipe.encode_image(c1["img"])
        t_frames = c1["r_d"].shape[1]
        wa = pipe.encode_audio(c1["wave"], t_frames).to(sdt)
        we = pipe.emotion_latent(c1["wave"], "none").to(sdt)
        r_s = r_s.to(sdt)
    n_chunks = math.ceil(t_frames / cfg.num_frames_for_clip)
    per_chunk = K9_FORWARDS * sum(K9_CALLS.values())
    ones = dict(a_cfg_scale=1.0, e_cfg_scale=1.0, r_cfg_scale=1.0)
    modes = {"3way": (cfg, {}, we), "4way": (
        cfg.replace(include_r_cfg=True), dict(r_cfg_scale=1.5), we),
        "skip": (cfg, ones, we),
        "dynamic we": (cfg, {}, we.expand(-1, t_frames, -1).contiguous()),
        "bf16": (cfg, {}, we)}
    counts, outs = {}, {}
    for mode, (c, scales, w) in modes.items():
        dt = torch.bfloat16 if mode == "bf16" else sdt

        def sample():
            with torch.inference_mode():
                return sampling.sample_motion_latents(
                    pipe.params["fmt"], r_s.to(dt), wa.to(dt), w.to(dt),
                    cfg=c,
                    **dict(dict(a_cfg_scale=cfg.a_cfg_scale,
                                e_cfg_scale=cfg.e_cfg_scale,
                                r_cfg_scale=cfg.r_cfg_scale), **scales),
                    generator=torch.Generator(device=pipe.device
                                              ).manual_seed(15))
        sample()                                     # its graph captured
        outs[mode], secs, n = run_path(f"sampler {mode}", sample, {}, 0,
                                       sampled=True)
        got = k9_launches(PATHS[f"sampler {mode}"])
        counts[f"sampler {mode}"] = n
        check(got == per_chunk * n_chunks,
              f"sampler {mode}: K9 launched {got} times, expected "
              f"{per_chunk} for each of {n_chunks} chunks")
        log(f"[path] sampler {mode}: {n_chunks} chunks in {secs * 1e3:.1f} "
            f"ms, K9 {got}")
    # the bf16 sampler within tests/test_serving.py's bf16 integration
    # floor of the f32 one: max|diff| < 0.1 max|f32|
    ref = outs["3way"].float()
    err = ((outs["bf16"].float() - ref).abs().max() / ref.abs().max()).item()
    log(f"[path] sampler bf16 against f32: max|diff| {err:.3e} of max|f32|")
    check(err < 0.1, f"sampler bf16: {err:.3g} of max|f32| from the f32 "
          f"sampler")
    return counts


class NodeTimes:
    """Wall seconds of each node a graph runs, each closed by a
    synchronize: the registry's adapters wrapped while in use."""

    def __enter__(self):
        from float_torch.api import comfy
        self.registry, self.saved, self.secs = comfy.ADAPTERS, dict(
            comfy.ADAPTERS), {}
        for name, fn in self.saved.items():
            self.registry[name] = self._timed(name, fn)
        return self.secs

    def _timed(self, name, fn):
        def run(ctx, inputs):
            t0 = sync_time()
            out = fn(ctx, inputs)
            self.secs[name] = sync_time() - t0
            return out
        return run

    def __exit__(self, *exc):
        self.registry.update(self.saved)


def phase_checkpoint(c1: dict, root: Path) -> str:
    """Config 1's parameters -> unified FLOAT.safetensors (the port's
    writer) -> ``load_float_models`` on the card; every tensor equal."""
    from float_torch.api.nodes import load_float_models
    from float_torch.io.checkpoint import save_safetensors, unified_state_dict
    pipe = c1["pipe"]
    path = root / "float" / "FLOAT.safetensors"
    path.parent.mkdir(parents=True)
    want = pipe.params.state_dict()
    t0 = time.perf_counter()
    save_safetensors(unified_state_dict(want), str(path))
    n = sum(v.numel() for v in want.values())
    log(f"[checkpoint] {n / 1e6:.1f} M parameters written as a unified "
        f"FLOAT.safetensors ({path.stat().st_size / 1e9:.3f} GB) in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = sync_time()
    loaded = load_float_models(model=str(path), target_device="cuda",
                               cfg=pipe.cfg)
    secs = sync_time() - t0
    got = loaded.pipeline.params.state_dict()
    equal = sorted(got) == sorted(want) and all(
        torch.equal(got[k], want[k]) for k in want)
    check(equal, "the loaded checkpoint's tensors differ from the "
          "pipeline's that were written")
    check(loaded.pipeline.device.type == "cuda" and loaded.weights == "real",
          f"loaded onto {loaded.pipeline.device} as {loaded.weights!r}")
    log(f"[checkpoint] load_float_models, file to pipeline on "
        f"{loaded.pipeline.device}: {secs:.2f} s; all {len(want)} tensors "
        f"equal to the written ones: {equal}")
    return str(path)


def phase_regular_graph(c1: dict, root: Path, n_chunks: int) -> dict:
    """graph_regular.json through the port's graph executor on the card."""
    from float_torch.api.comfy import GraphContext, run_comfy_workflow
    from float_torch.audio.features import normalize_waveform
    from float_torch.image.transform import comfy_image_to_model_input
    from float_torch.io.video import video_backend
    size = c1["pipe"].cfg.input_size
    rng = np.random.default_rng(2)
    # k / 255 in float32 maps back to k through the graph's uint8 step, so
    # the split tiers, which take the float image, see the same pixels
    img = rng.integers(0, 256, (size, size, 3)).astype(np.float32) / 255
    wave = c1["wave"][0].cpu().numpy()
    np.save(root / "portrait.npy", img)
    np.save(root / "speech.npy", wave)
    with open(REPO / "example_workflows" / "graph_regular.json") as f:
        wf = json.load(f)
    writer = video_backend()
    if writer:
        log(f"[graph] VHS_VideoCombine writes its mp4 through {writer}")
    else:
        for node in wf["nodes"]:
            if node["type"] == "VHS_VideoCombine":
                node["mode"] = 2
        log("[graph] neither cv2 nor an ffmpeg binary here: VHS_VideoCombine "
            "muted (mode 2)")
    ctx = GraphContext(
        device="cuda", models_root=str(root), inputs_dir=str(root),
        output_dir=str(root / "out"),
        overrides={"LoadImage": {"image": "portrait.npy"},
                   "LoadAudio": {"audio": "speech.npy"},
                   "LoadFloatModelsOpt": {"cfg": c1["pipe"].cfg}})
    with NodeTimes() as node_secs:
        (results, ctx), secs, counts = run_path(
            "graph_regular.json", lambda: run_comfy_workflow(wf, ctx),
            {"warp_shared": len(LEVELS) * n_chunks}, n_chunks, sampled=True)
    log(f"[graph] graph_regular.json: {secs:.3f} s wall, from the checkpoint "
        f"file (LoadFloatModelsOpt) to the frames on the host"
        + (f" and {ctx.artifacts[0]}" if ctx.artifacts else "")
        + "; by node: " + ", ".join(f"{k} {v:.3f} s"
                                    for k, v in node_secs.items()))
    float_pipe, frames = results["3"][0], results["4"][0]
    t_frames = c1["frames"].shape[0]
    check(frames.shape == (t_frames, size, size, 3),
          f"FloatProcessOpt frames {frames.shape}")
    if writer:
        check(len(ctx.artifacts) == 1 and Path(ctx.artifacts[0]).stat()
              .st_size > 0, f"VHS_VideoCombine wrote {ctx.artifacts}")
    model_in, _ = comfy_image_to_model_input(img, size)
    with torch.inference_mode():
        ref = float_pipe.pipeline.generate(
            model_in, normalize_waveform(wave)[None], emotion="none", seed=15)
    check_frames("graph_regular.json", frames, ref, DECODE_TOL + U8_STEP,
                 "generate(seed=15)")
    return {"pipe": float_pipe, "img": img, "frames": torch.from_numpy(
        frames).cuda(), "audio": {"waveform": wave[None, None],
                                  "sample_rate": 16000}, "counts": counts}


def phase_advanced(reg: dict, n_chunks: int) -> dict:
    """The Advanced tier's split nodes on the graph's FLOAT_PIPE, face
    alignment off."""
    from float_torch.api import nodes as N
    pipe = reg["pipe"]

    def tier():
        app, lam = N.float_encode_image_to_latents(pipe, reg["img"][None])
        r_s = N.float_get_identity_reference(pipe, lam)
        wa, t, processed = N.float_encode_audio_to_wa(pipe, reg["audio"])
        we = N.float_encode_emotion_to_we(pipe, processed, "none")
        r_d = N.float_sample_motion_sequence(pipe, r_s, wa, we,
                                             audio_num_frames=t, seed=15)
        return N.float_decode_latents_to_images(pipe, app, r_d)[0], r_d

    (frames, r_d), secs, counts = run_path(
        "advanced tier", tier, {"warp_shared": len(LEVELS) * n_chunks},
        n_chunks, sampled=True)
    log(f"[tier] advanced: {secs:.3f} s for {frames.shape[0]} frames")
    check_frames("advanced tier", frames, reg["frames"], DECODE_TOL + U8_STEP,
                 "graph_regular.json")
    return counts, r_d


def cut_store(unified: str, root: Path) -> Path:
    """The part files of ``extract_parts --all`` cut from the unified file
    under ``root/float``, with a config.json in each audio folder, which
    makes it an HF folder: the layouts the readiness phase loads and the
    Very Advanced loaders read."""
    from float_torch.config import (EMOTION_LABELS, WAV2VEC2_BASE,
                                    WAV2VEC2_LARGE_SER)
    from float_torch.tools.extract_parts import extract_all
    from float_torch.tools.readiness_check import hf_folder
    parts = root / "float"
    t0 = time.perf_counter()
    check(extract_all(unified, str(parts)), f"a part missing in {unified}")
    for part, cfg, labels in (
            ("wav2vec2_base", WAV2VEC2_BASE, ()),
            ("emotion_ser", WAV2VEC2_LARGE_SER, EMOTION_LABELS)):
        raw = dataclasses.asdict(cfg)
        if labels:
            raw["id2label"] = {str(i): lbl for i, lbl in enumerate(labels)}
        (Path(hf_folder(str(parts), part)) / "config.json").write_text(
            json.dumps(raw))
    log(f"[store] 6 part files and 2 HF folders cut from the unified file "
        f"in {time.perf_counter() - t0:.2f} s")
    return parts


def phase_readiness(unified: str, parts: Path) -> None:
    """``float_torch.tools.readiness_check`` on the card: the unified file,
    its part files and its HF folders loaded and held equal, then the
    parity gate against the fixture recorded from float_tpu, in float32
    (K1 counted in its decode), two controls that must fail the stages
    each names, and the recorded latents decoded in bf16 (a reading)."""
    from float_torch.config import FloatConfig
    from float_torch.kernels import warp_shared as ws
    from float_torch.runtime.pipeline import FloatPipeline
    from float_torch.tools import parity_check as pc
    from float_torch.tools import readiness_check as rc
    t_phase = time.perf_counter()
    acts = pc.load_activations(str(FIXTURE))
    frames = len(acts["r_d_frames"][0]) + len(acts["r_d_small"][0])
    try:        # a gate that fails exits, naming itself
        t0 = time.perf_counter()
        params, counts = rc.gate_load(unified)
        rc.gate_layouts(params, str(parts))
        log(f"[readiness] load gate, three layouts: "
            f"{time.perf_counter() - t0:.2f} s; parameters per part {counts}")
        pipe = pc.float32_pipeline(params, "cuda")
        results, secs, _ = run_path(
            "parity", lambda: rc.gate_parity(str(FIXTURE), pipe),
            {"warp_shared": len(LEVELS)}, 1)
    except SystemExit as exc:
        check(False, f"readiness: {exc}")
        return
    log(f"[readiness] parity gate on the card: {secs:.2f} s, the decode of "
        f"{frames} recorded frames in one float32 chunk")
    for r in results:
        ratio = "" if r.floor is None else \
            f", {r.floor_ratio:.2f}x the f32-vs-f64 floor {r.floor:.3e}"
        slack = f" + float16 storage {r.slack:.3e}" if r.slack else ""
        log(f"[readiness] {r.name}: max|err| {r.max_err:.3e} (atol {r.atol},"
            f" rtol {r.rtol}{slack}){ratio}: {'PASS' if r.ok else 'FAIL'}")
        check(r.ok, f"readiness: stage {r.name} max|err| {r.max_err}")

    # controls, each of which must fail the stage it names
    shuffled = pc.run_parity(pipe, dict(acts,
                                        noise=acts["noise"][::-1].copy()))
    # the decode's graphs replay the launches they captured: drop them so
    # that the faulty wrapper is captured, and again so that no later
    # decode replays it
    real = ws.warp_shared_cuda
    ws.warp_shared_cuda = lambda f, g: real(f, g.to(torch.bfloat16).float())
    pipe.syn_cast.decode_graphs = None
    try:
        coarse = pc.run_parity(pipe, acts)
    finally:
        ws.warp_shared_cuda = real
        pipe.syn_cast.decode_graphs = None
    del pipe
    # the recorded latents through the program's own bf16 decode (the
    # default compute dtype), from its bf16 encoding of the image
    bf16 = FloatPipeline(params, FloatConfig(), device="cuda")
    meta = pc.fixture_meta(acts)
    img, _wave = pc.bench_inputs(meta["input_seed"], meta["image_size"],
                                 meta["n_samples"])
    s_r, _lam, feats, _r_s = bf16.encode_image(img)
    low = pc.decode_stages(bf16, acts, s_r, feats)
    del bf16, params, s_r, feats
    for name, res, want, allowed in (
            ("the sampler fed the recorded noise in reversed chunk order",
             shuffled, "r_d", {"r_d"}),
            ("the frames decoded with their warp grids rounded to bf16",
             coarse, "frames", {"frames", "frames_small"})):
        failed = {r.name: r.max_err for r in res if not r.ok}
        log(f"[readiness] control, {name}: failed {failed}")
        check(want in failed and set(failed) <= allowed,
              f"readiness control ({name}): failed {sorted(failed)}, must "
              f"fail {want} and nothing outside {sorted(allowed)}")
    # A reading, not a control: the reference's frame budget (2e-2 + 2e-2
    # of |ref| per element, about 3e-2 to 4e-2 on these frames) admits a
    # bf16 decode.  What sees the decode's precision is K1 bit-exact
    # against its plain version (phase 3) and DECODE_TOL (phase 8).  The
    # check only shows that the bf16 decode ran in bf16.
    f32_err = max(r.max_err for r in results
                  if r.name in dict(pc.DECODE_STAGES))
    for r in low:
        log(f"[readiness] reading, the recorded latents decoded in bf16: "
            f"{r.name} max|err| {r.max_err:.3e} "
            f"({'within' if r.ok else 'outside'} the reference's budget; "
            f"the float32 gate read {f32_err:.3e})")
    check(min(r.max_err for r in low) > 10 * f32_err,
          f"readiness: the bf16 decode reads {[r.max_err for r in low]}, "
          f"not above 10x the float32 gate's {f32_err}")
    torch.cuda.empty_cache()
    log(f"[readiness] phase {time.perf_counter() - t_phase:.1f} s")


def phase_very_advanced(reg: dict, parts: Path) -> dict:
    """The six loaders on the part files and HF folders of ``cut_store``
    (published widths inferred), the eight apply nodes with the arguments
    their graph adapters pass: ApplyFloatSynthesis decodes in float32 in
    chunks of its default decode_batch."""
    import inspect
    from float_torch.api import nodes as N
    from float_torch.config import WAV2VEC2_BASE, WAV2VEC2_LARGE_SER
    from float_torch.runtime.decode import decode_clips_to_host
    from float_torch.tools.extract_parts import DEFAULT_NAMES
    from float_torch.tools.readiness_check import hf_folder
    files = {k: str(parts / rel) for k, rel in DEFAULT_NAMES.items()}
    t0 = sync_time()
    w2v = N.load_wav2vec_model(hf_folder(str(parts), "wav2vec2_base"))
    proj = N.load_audio_projection(files["projection"])
    emo = N.load_emotion_model(hf_folder(str(parts), "emotion_ser"))
    enc = N.load_float_encoder(files["encoder"])
    syn = N.load_float_synthesis(files["decoder"])
    fmt = N.load_fmt_model(files["fmt"])
    secs = sync_time() - t0
    widths = {
        "wav2vec2": w2v.config == WAV2VEC2_BASE,
        "ser": emo.config == WAV2VEC2_LARGE_SER and emo.dim_e == 7,
        "projection": (proj.input_dim, proj.output_dim) == (9216, 512),
        "encoder": (enc.input_size, enc.dim, enc.dim_motion) == (512, 512, 20),
        "synthesis": (syn.size, syn.style_dim, syn.motion_dim) == (512, 512,
                                                                   20),
        "fmt": (fmt.cfg.dim_w, fmt.cfg.dim_h, fmt.cfg.dim_a,
                fmt.cfg.fmt_depth, fmt.cfg.mlp_ratio) == (512, 1024, 512, 8,
                                                          4.0)}
    for name, ok in widths.items():
        check(ok, f"very advanced tier: {name}'s widths inferred from its "
              "checkpoint are not the published ones")
    log(f"[tier] very advanced: six loaders onto the card in {secs:.2f} s; "
        f"published widths inferred: {widths}")
    audio = reg["audio"]
    fb = inspect.signature(N.apply_float_synthesis).parameters[
        "decode_batch"].default
    va_chunks = math.ceil(reg["frames"].shape[0] / fb)

    def tier():
        feats, _processed, t = N.audio_preprocess_and_feature_extract(w2v,
                                                                      audio)
        wa = N.apply_audio_projection(proj, feats)
        we = N.extract_emotion(emo, audio, "none")
        we_dyn, seq = N.extract_emotion_dynamic(emo, audio, t)
        app, lam = N.apply_float_encoder(enc, reg["img"])
        r_s = N.get_identity_reference_va(syn, lam)
        r_d = N.sample_motion_sequence_va(fmt, r_s, wa, we,
                                          audio_num_frames=t, seed=15)
        frames, _fps = N.apply_float_synthesis(syn, app, r_d)
        return frames, we_dyn, seq, app, r_d

    (frames, we_dyn, seq, app, r_d), secs, counts = run_path(
        "very advanced tier", tier, {"warp_shared": len(LEVELS) * va_chunks},
        va_chunks, sampled=True)
    log(f"[tier] very advanced: {secs:.3f} s for the eight apply nodes, "
        f"{frames.shape[0]} frames decoded in float32, {va_chunks} chunks of "
        f"{fb}; dynamic emotion {tuple(we_dyn.shape)} from {seq.shape[1]} "
        f"windows")
    check(tuple(we_dyn.shape) == (1, frames.shape[0], 7)
          and seq.shape == (1, 5, 7) and bool(torch.isfinite(we_dyn).all()),
          f"extract_emotion_dynamic: we {tuple(we_dyn.shape)}, "
          f"windows {seq.shape}")
    err = (r_d - reg["r_d"]).abs().max().item()
    log(f"[tier] very advanced: motion latents vs the advanced tier's "
        f"(same seed and noise) max|diff| {err:.3e} (tol {LATENT_TOL:.3g})")
    check(err <= LATENT_TOL, f"very advanced tier: latents differ from the "
          f"advanced tier's by {err}")
    # the same latents decoded in float32 by the graph's pipeline (its own
    # copy of the weights, from the unified file) in the graph's chunks
    pipe = reg["pipe"].pipeline
    ref = decode_clips_to_host(
        pipe.params["synthesis"], [(app.h_source, app.feats, r_d[0])],
        size=pipe.cfg.input_size, decode_batch=pipe.cfg.decode_batch)[0]
    check_frames("very advanced tier", frames, torch.from_numpy(ref).cuda(),
                 F32_DECODE_TOL + U8_STEP, "a float32 decode of its latents")
    check_frames("very advanced tier", frames, reg["frames"],
                 BF16_DECODE_TOL + U8_STEP, "graph_regular.json (bf16)")
    return counts


def mp4_frames(path: Path) -> int:
    """Frames of an mp4 file, counted by reading it with cv2."""
    import cv2
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


# Phase 13's client, one request per process (``python -c CLIENT op url
# dir [workflow]``): its JSON and base64 work does not share the server's
# interpreter lock, as a real client's would not.  It reads the portrait
# and the audio the graph phase saved in ``dir``, writes what it received
# there, and prints its timings, taken around the request alone.
CLIENT = r"""
import json, sys, time
from pathlib import Path
import numpy as np
from float_torch.client import FloatClient
op, url, d = sys.argv[1], sys.argv[2], Path(sys.argv[3])
c = FloatClient(url)
img, wave = np.load(d / "portrait.npy"), np.load(d / "speech.npy")
out, t0 = {}, time.perf_counter()
if op == "generate":
    video = c.generate(img, wave, seed=15)
    out["total"] = time.perf_counter() - t0
    (d / "generate.mp4").write_bytes(video)
elif op.startswith("stream-"):
    parts = []
    for _start, frames in c.stream(img, wave, seed=15, first_chunk=8,
                                   encoding=op[7:], quality=85):
        out.setdefault("ttfc", time.perf_counter() - t0)
        parts.append(frames)
    out["total"] = time.perf_counter() - t0
    np.save(d / (op + ".npy"), np.concatenate(parts))
elif op == "batch":
    res = c.generate_batch([
        {"image": img, "audio": wave, "seed": 15},
        {"image": np.load(d / "portrait2.npy"),
         "audio": wave[:6 * 16000] * 0.8, "seed": 16}])
    out["total"] = time.perf_counter() - t0
    out["frames"] = [r["frames"] for r in res]
    for i, r in enumerate(res):
        (d / f"batch{i}.mp4").write_bytes(r["video"])
elif op == "graph":
    arts = c.run_graph(json.loads(Path(sys.argv[4]).read_text()),
                       inputs={"portrait.npy": img, "speech.npy": wave},
                       overrides={"LoadImage": {"image": "portrait.npy"},
                                  "LoadAudio": {"audio": "speech.npy"}})
    out["total"] = time.perf_counter() - t0
    out["artifacts"] = sorted(arts)
    for name, blob in arts.items():
        (d / ("graph-" + Path(name).name)).write_bytes(blob)
print(json.dumps(out))
"""


def run_client(op: str, url: str, root: Path, *extra) -> dict:
    """One request of ``CLIENT`` in its own process; its printed timings."""
    proc = subprocess.run(
        [sys.executable, "-c", CLIENT, op, url, str(root), *extra], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)
    if proc.returncode:
        raise RuntimeError(f"client {op} exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def start_server(pipe, **opts):
    """``make_server`` on 127.0.0.1 (a free port) serving in a thread."""
    from float_torch.serve import make_server
    httpd = make_server(pipe, "127.0.0.1", 0, **opts)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop_server(httpd) -> None:
    httpd.shutdown()
    httpd.server_close()


def phase_serve(c1: dict, reg: dict, root: Path, unified: str) -> None:
    """13. The serving daemon on config 1, loaded as ``serve`` loads it."""
    import http.client
    import urllib.error
    from float_torch.api.nodes import (comfy_image_to_model_input,
                                       normalize_waveform)
    from float_torch.client import FloatClient, _b64, _jpeg_to_rgb
    from float_torch.io.video import video_backend
    from float_torch.ops.yuv420 import i420_to_rgb_u8
    from float_torch.runtime.decode import stream_chunk_count
    from float_torch.serve import _jpeg_encode_frames, load_pipe

    cfg = c1["pipe"].cfg
    check(video_backend() != "", "no mp4 writer (cv2 or ffmpeg) for serving")
    # as ``python -m float_torch.cli serve --checkpoint <file>
    # --decode-batch 24`` loads it
    t0 = sync_time()
    pipe = load_pipe(unified, decode_batch=cfg.decode_batch)
    t_load = sync_time() - t0
    check(pipe.cfg == cfg, f"serve's configuration {pipe.cfg} is not "
          f"config 1's {cfg}")
    warm = pipe.pipeline.warmup()
    log(f"[serve] load_pipe(decode_batch={pipe.cfg.decode_batch}) "
        f"{t_load:.2f} s onto {pipe.pipeline.device}; FloatPipeline.warmup "
        f"{warm:.2f} s")
    img, wave = reg["img"], reg["audio"]["waveform"][0, 0]
    size, t_frames = cfg.input_size, c1["frames"].shape[0]
    n_lv = len(LEVELS)
    n_chunks = math.ceil(t_frames / cfg.decode_batch)
    n_stream = stream_chunk_count(t_frames, cfg.decode_batch, 8)
    model_in, _ = comfy_image_to_model_input(img, size)
    wave_n = normalize_waveform(wave)[None]

    httpd, url = start_server(pipe)
    try:
        client = FloatClient(url)
        health = client.health()
        log(f"[serve] /health {health}")
        # the pipeline's device carries its card's index; no mesh
        check(health["status"] == "ok"
              and health["device"] == f"cuda:{torch.cuda.current_device()}"
              and health["device_name"] == torch.cuda.get_device_name(0)
              and health["weights"] == "real" and health["mesh"] is None,
              f"/health {health}")

        got, secs, _ = run_path(
            "/v1/generate", lambda: run_client("generate", url, root),
            {"warp_shared": n_lv * n_chunks}, n_chunks, sampled=True)
        mp4 = root / "generate.mp4"
        n = mp4_frames(mp4)
        log(f"[serve] /v1/generate: {got['total']:.3f} s at the client "
            f"({secs:.3f} s with its process) for a "
            f"{mp4.stat().st_size / 1e6:.2f} MB mp4 of {n} frames")
        check(n == t_frames, f"/v1/generate mp4 holds {n} frames")

        def local_stream(wire):
            t0, first, parts = sync_time(), None, []
            for _s, part in pipe.pipeline.generate_stream(
                    model_in, wave_n, seed=15, first_chunk=8, wire=wire):
                first = first or time.perf_counter() - t0
                parts.append(part)
            return np.concatenate(parts), first, sync_time() - t0

        def in_new_thread(fn, *args):
            """``fn(*args)`` on a thread of its own, as the server runs a
            stream's generation."""
            box = []
            worker = threading.Thread(target=lambda: box.append(fn(*args)))
            worker.start()
            worker.join()
            return box[0]

        # generate's uint8 (the u8 wire's rounding) and the same request's
        # first decode chunk, decoded again as generate decodes it and with
        # its warp grids rounded to bf16 (a fault the gate must see)
        pl, nb = pipe.pipeline, cfg.decode_batch
        with torch.inference_mode():
            gen_u8 = torch.round(pl.generate(model_in, wave_n, seed=15)
                                 * 255.0).to(torch.uint8)
            s_r, _lam, feats, r_s = pl.encode_image(model_in)
            wa = pl.encode_audio(wave_n, t_frames)
            r_d = pl.sample(r_s, wa, pl.emotion_latent(wave_n, "none"),
                            seed=15)
        again = decode_first_chunk(pl, s_r, feats, r_d[0], nb, out_u8=True)
        coarse = decode_first_chunk(pl, s_r, feats, r_d[0], nb, out_u8=True,
                                    warps=bf16_grid_warps())
        for enc in ("raw", "jpeg"):
            got, _, _ = run_path(
                f"/v1/generate stream {enc}",
                lambda: run_client(f"stream-{enc}", url, root),
                {"warp_shared": n_lv * n_stream}, n_stream, sampled=True)
            frames = np.load(root / f"stream-{enc}.npy")
            wire = "u8" if enc == "raw" else "yuv420"
            local, l_ttfc, l_total = local_stream(wire)
            _, t_ttfc, t_total = in_new_thread(local_stream, wire)
            log(f"[serve] stream {enc}: first line at the client after "
                f"{got['ttfc'] * 1e3:.1f} ms, all {frames.shape[0]} frames "
                f"after {got['total'] * 1e3:.1f} ms, "
                f"{frames.shape[0] / got['total']:.2f} delivered frames/s; in "
                f"process (generate_stream, same wire) first chunk "
                f"{l_ttfc * 1e3:.1f} ms, all {l_total * 1e3:.1f} ms; the same "
                f"on a new thread {t_ttfc * 1e3:.1f} and {t_total * 1e3:.1f} ms")
            check(frames.shape == (t_frames, size, size, 3),
                  f"stream {enc}: frames {frames.shape}")
            if enc == "jpeg":
                local = np.stack([_jpeg_to_rgb(b) for b in _jpeg_encode_frames(
                    i420_to_rgb_u8(local), 85)])
            # the served frames are the in-process stream's of the same
            # request (one process, one decode), through the same JPEG
            # codec for "jpeg": equal, as the CPU tests hold them
            d_max, d_mean = u8_levels(frames, local) \
                if frames.shape == local.shape else (255, 255.0)
            log(f"[serve] stream {enc} vs the in-process stream of the same "
                f"request{' through the same codec (q85)' if enc == 'jpeg' else ''}"
                f": max|diff| {d_max} levels, mean {d_mean:.3e} (gate: 0)")
            check(d_max == 0, f"stream {enc} vs in-process: max|diff| "
                  f"{d_max} levels")
            if enc == "raw":
                sound = u8_levels(frames, gen_u8)
                same = u8_levels(again, gen_u8[:nb])
                shifted = u8_levels(frames[1:], gen_u8[:-1])
                rounded = u8_levels(coarse, gen_u8[:nb])
                log(f"[serve] raw stream vs generate(seed=15)'s uint8: max "
                    f"|diff| {sound[0]} levels, mean {sound[1]:.3e} (gate "
                    f"{STREAM_TOL_LEVELS}); generate's first chunk decoded "
                    f"again {same[0]}, mean {same[1]:.3e}; faults: frames "
                    f"one place out of order {shifted[0]}, mean "
                    f"{shifted[1]:.3e}, the first chunk with bf16 warp grids"
                    f" {rounded[0]}, mean {rounded[1]:.3e}")
                check(sound[0] <= STREAM_TOL_LEVELS and same[0]
                      <= STREAM_TOL_LEVELS, f"raw stream vs generate: "
                      f"{sound[0]} levels, the chunk decoded again {same[0]}"
                      f" (gate {STREAM_TOL_LEVELS})")
                check(shifted[0] > STREAM_TOL_LEVELS
                      and rounded[0] > STREAM_TOL_LEVELS,
                      f"a fault passes the stream gate: out of order "
                      f"{shifted[0]}, bf16 grids {rounded[0]} levels")

        # the raw wire's host cost for one 24-frame chunk: what the server
        # does to put a line out, and what a client does to read it back
        u8 = np.ascontiguousarray(np.load(root / "stream-raw.npy")[:24])
        t0 = time.perf_counter()
        line = json.dumps({"start": 0, "shape": list(u8.shape),
                           "dtype": "uint8", "data": base64.b64encode(
                               u8.tobytes()).decode()}).encode()
        t1 = time.perf_counter()
        msg = json.loads(line)
        back = np.frombuffer(base64.b64decode(msg["data"]), np.uint8)
        t2 = time.perf_counter()
        check(back.tobytes() == u8.tobytes(), "raw wire round trip")
        log(f"[serve] raw wire, one 24-frame line ({len(line) / 1e6:.1f} MB) "
            f"on this host: base64 + JSON {(t1 - t0) * 1e3:.1f} ms, back "
            f"{(t2 - t1) * 1e3:.1f} ms")

        rng = np.random.default_rng(1)
        np.save(root / "portrait2.npy", rng.integers(
            0, 256, (size, size, 3)).astype(np.float32) / 255)
        t2 = math.ceil(6 * cfg.fps)
        n_b = n_chunks + math.ceil(t2 / cfg.decode_batch)
        got, _, _ = run_path(
            "/v1/generate_batch 10 s + 6 s",
            lambda: run_client("batch", url, root),
            {"warp_shared": n_lv * n_b}, n_b, sampled=True)
        counts = [(n, mp4_frames(root / f"batch{i}.mp4"))
                  for i, n in enumerate(got["frames"])]
        log(f"[serve] /v1/generate_batch: {got['total']:.3f} s at the client, "
            f"(frames, mp4 frames) {counts}")
        check(counts == [(t_frames, t_frames), (t2, t2)],
              f"/v1/generate_batch clips {counts}")

        got, _, _ = run_path(
            "/v1/graph graph_regular.json", lambda: run_client(
                "graph", url, root,
                str(REPO / "example_workflows" / "graph_regular.json")),
            {"warp_shared": n_lv * n_chunks}, n_chunks)
        names = got["artifacts"]
        n = mp4_frames(root / f"graph-{Path(names[0]).name}") \
            if len(names) == 1 else -1
        log(f"[serve] /v1/graph: {got['total']:.3f} s at the client, "
            f"artifacts {names}, {n} frames")
        check(len(names) == 1 and names[0].endswith(".mp4") and n == t_frames,
              f"/v1/graph artifacts {names}, {n} frames")

        # generate, 2 streams, batch: counted; the graph only waits on the
        # lock and adds to the latencies
        sent = (4, t_frames * 3 + t_frames + t2, 5)
        deadline = time.perf_counter() + 10
        while (client.metrics()["latency_seconds"] or {}).get("count", 0) \
                < sent[2] and time.perf_counter() < deadline:
            time.sleep(0.02)
        m = client.metrics()
        log(f"[serve] /metrics {json.dumps(m)}")
        lat = m["latency_seconds"] or {}
        check((m["requests"], m["frames"], lat.get("count")) == sent
              and m["errors"] == m["rejected_busy"] == m["stream_aborts"]
              == m["queue_depth"] == 0
              and m["frames_per_busy_second"]
              == round(m["frames"] / m["busy_seconds"], 2)
              and 0 < lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]
              and m["lock_wait_seconds"]["count"] == sent[2],
              f"/metrics {m}, expected (requests, frames, latencies) {sent}")
    finally:
        stop_server(httpd)

    # admission: one request holds the only slot, the others get 503
    httpd, url = start_server(pipe, max_pending=1)
    try:
        def fire(_):
            try:
                FloatClient(url).generate(img, wave, seed=15)
                return 200, None
            except urllib.error.HTTPError as exc:
                return exc.code, exc.headers.get("Retry-After")

        with ThreadPoolExecutor(3) as ex:
            codes = list(ex.map(fire, range(3)))
        m = FloatClient(url).metrics()
        n503 = sum(c == 503 for c, _ in codes)
        log(f"[serve] max_pending=1, 3 requests at once: (status, "
            f"Retry-After) {codes}; rejected_busy {m['rejected_busy']}")
        check(n503 >= 1 and any(c == 200 for c, _ in codes)
              and all(c in (200, 503) for c, _ in codes)
              and all(int(r) >= 1 for c, r in codes if c == 503)
              and m["rejected_busy"] == n503, f"admission: {codes}, {m}")
    finally:
        stop_server(httpd)

    # a stalled reader: one line read, then nothing
    httpd, url = start_server(pipe, stream_buffer_mb=1,
                              stream_stall_timeout=2.0)
    srv = httpd.RequestHandlerClass.srv
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1],
                                      timeout=120)
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"image": _b64(img), "audio": _b64(wave), "seed": 15,
             "stream": True, "first_chunk": 8}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        first = json.loads(resp.readline())
        t0 = time.perf_counter()
        while srv.metrics()["stream_aborts"] == 0 \
                and time.perf_counter() - t0 < 60:
            time.sleep(0.05)
        t_abort = time.perf_counter() - t0
        freed = not srv.lock.locked()
        (root / "next.mp4").write_bytes(FloatClient(url).generate(
            img, wave[:2 * cfg.sampling_rate], seed=15))
        n = mp4_frames(root / "next.mp4")
        log(f"[serve] stalled reader (1 MB buffer, 2 s stall timeout): "
            f"status {resp.status}, first line start {first['start']}, "
            f"aborted {t_abort:.2f} s after the last read "
            f"(stream_aborts {srv.metrics()['stream_aborts']}), lock free "
            f"{freed}; the next request: an mp4 of {n} frames")
        check(resp.status == 200 and srv.metrics()["stream_aborts"] == 1
              and freed and n == 50, "stalled reader: not aborted, lock "
              "held or the next request failed")
    finally:
        conn.close()
        stop_server(httpd)


def phase_cli(root: Path, unified: str, decode_batch: int) -> None:
    """14. ``python -m float_torch.cli`` as subprocesses on the card,
    generating at config 1's ``decode_batch``."""
    env = dict(os.environ, PYTHONPATH=str(REPO))

    def cli(*args):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "float_torch.cli", *args],
                              cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"cli {args[0]} exited "
              f"{proc.returncode}: {proc.stderr[-3000:]}")
        return proc.stdout, secs

    out, secs = cli("inspect", unified)
    log(f"[cli] inspect, {secs:.2f} s wall:\n" + out.rstrip())
    check("617.5 M params" in out.splitlines()[0] and "synthesis arch:" in out
          and "fmt arch:" in out, "cli inspect output")
    for extra in ((), ("--stream",)):
        mp4 = root / f"cli{''.join(extra)}.mp4"
        out, secs = cli("generate", "--checkpoint", unified, "--image",
                        str(root / "portrait.npy"), "--audio",
                        str(root / "speech.npy"), "--output", str(mp4),
                        "--decode-batch", str(decode_batch), "--no-progress",
                        *extra)
        n = mp4_frames(mp4) if mp4.exists() else 0
        first = re.search(r"first frames after ([0-9.]+)s", out)
        log(f"[cli] generate {' '.join(extra)}: {secs:.2f} s wall, mp4 of {n}"
            f" frames; it printed: {' | '.join(out.strip().splitlines())}")
        check(n == 250 and "generated 250 frames" in out
              and bool(first) == bool(extra), f"cli generate {extra}: {out}")

# r_d of a mesh pipeline against the single-device pipeline: the
# tolerance of float_tpu's own tests/test_parallel.py (the model axis
# sums each row-parallel layer in another order).
MESH_RD_TOL = 2e-4


def share_launches(chunks, ranks: int, n_lv: int) -> tuple:
    """(launches by kernel, launches at K4's shapes) of decode chunks of
    ``chunks`` frames, each split over ``ranks`` shares as
    ``decode.FrameParallel`` splits them: a share of more than one frame
    warps its shared levels with K1, a share of one frame with K3."""
    k1 = k3 = k4 = 0
    for size in chunks:
        for share in torch.arange(size).tensor_split(ranks):
            n = share.numel()
            k1 += n_lv * (n > 1)
            k3 += n_lv * (n == 1)
            k4 += n > 1 and n % 4 == 0     # its 512² C=32 level
    return {"warp_shared": k1, "warp_per_frame": k3}, k4


def run_mesh(name: str, mesh, c1: dict) -> None:
    """Config 1's generate, generate_stream(first_chunk=4) and ragged
    generate_batch through a pipeline over ``mesh``, against the
    single-device pipeline's."""
    from float_torch.runtime.decode import chunk_sizes, first_chunk_size
    from float_torch.runtime.pipeline import FloatPipeline, audio_num_frames
    pipe, frames = c1["pipe"], c1["frames"]
    cfg = pipe.cfg
    t0 = sync_time()
    mp = FloatPipeline(pipe.params, cfg, pipe.w2v_cfg, pipe.ser_cfg,
                       mesh=mesh)
    model = mesh.shape["model"]
    shards = mp.params["fmt"]["blocks"]["0"]["attn"].tp_shards
    log(f"[mesh] {name}: {mesh.shape} over {[str(d) for d in mesh.flat]}, "
        f"built in {sync_time() - t0:.2f} s; FMT attention in "
        f"{len(shards or [1])} head groups")
    check(model == 1 or len(shards) == model,
          f"mesh {name}: FMT attention not split over the model axis")

    t_frames = frames.shape[0]
    fb, n_lv = cfg.decode_batch, len(LEVELS)
    with torch.inference_mode():
        s_r, _lam, feats, r_s = pipe.encode_image(c1["img"])
        wa = mp.encode_audio(c1["wave"], t_frames)
        we = mp.emotion_latent(c1["wave"], "none")
        r_d = mp.sample(r_s, wa, we, seed=15)
    err = (r_d - c1["r_d"]).abs().max().item()
    log(f"[mesh] {name}: r_d (tensor-parallel wav2vec2 towers and FMT) vs "
        f"one device max|diff| {err:.3e} (tol {MESH_RD_TOL:g})")
    check(err <= MESH_RD_TOL, f"mesh {name}: r_d {err} > {MESH_RD_TOL}")

    want, k4 = share_launches(chunk_sizes(t_frames, fb), mesh.size, n_lv)
    out, secs, _ = run_path(f"mesh {name} generate", lambda: mp.generate(
        c1["img"], c1["wave"], emotion="none", seed=15), want, k4)
    log(f"[mesh] {name}: generate {secs:.3f} s, {t_frames / secs:.2f} "
        f"frames/s")
    check_frames(f"mesh {name} generate", out, frames, DECODE_TOL)
    out_of_order(f"mesh {name} generate", out, frames, DECODE_TOL)

    first = first_chunk_size(4, fb)
    chunks = [first] + [fb] * math.ceil((t_frames - first) / fb)
    want, k4 = share_launches(chunks, mesh.size, n_lv)

    def stream():
        return np.concatenate([part for _s, part in mp.generate_stream(
            c1["img"], c1["wave"], emotion="none", seed=15, first_chunk=4,
            wire="u8")])

    got, secs, _ = run_path(f"mesh {name} generate_stream", stream, want, k4)
    check_frames(f"mesh {name} generate_stream u8",
                 got.astype(np.float32) / 255.0, frames, DECODE_TOL + U8_STEP)

    imgs, waves, ref = c1["batch"]
    lens = [w.shape[-1] for w in waves]
    chunks = [n for w in lens for n in chunk_sizes(
        audio_num_frames(w, cfg), fb)]
    want, k4 = share_launches(chunks, mesh.size, n_lv)
    outs, secs, _ = run_path(f"mesh {name} generate_batch",
                             lambda: mp.generate_batch(imgs, waves),
                             want, k4)
    for i, (a, b) in enumerate(zip(outs, ref)):
        check_frames(f"mesh {name} generate_batch clip {i}", a,
                     torch.from_numpy(b).cuda(), DECODE_TOL + U8_STEP,
                     "one device's generate_batch")
    check(torch.cuda.current_device() == 0,
          f"mesh {name}: current device {torch.cuda.current_device()}")
    del mp
    torch.cuda.empty_cache()


def phase_mesh(c1: dict) -> None:
    """15. The mesh mode: (a) four ranks on card 0 at 2x2 and 1x4, always;
    (b) every card, when there are two or more."""
    from float_torch.parallel import make_mesh
    card0 = [torch.device("cuda", 0)] * 4
    run_mesh("2x2 on cuda:0", make_mesh(devices=card0, data=2, model=2), c1)
    run_mesh("1x4 on cuda:0", make_mesh(devices=card0, data=1, model=4), c1)
    n = torch.cuda.device_count()
    if n >= 2 and c1["pipe"].cfg.decode_batch % n == 0:
        run_mesh(f"{n} cards", make_mesh(), c1)
    else:
        log(f"[mesh] (b) not run: {n} card(s); (a) ran the same paths over "
            f"four ranks of one card")


def run_tool(tag: str, args: list, root: Path, unified: str | None,
             timeout: float) -> tuple:
    """``python -m <args>`` from ``root``, on config 1's unified file
    (``FLOAT_CKPT``, which spares each process the synthetic init) unless
    ``unified`` is None; (JSON lines of its output, its output, wall
    seconds), with its exit code checked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    if unified is not None:
        env["FLOAT_CKPT"] = unified
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", *args], cwd=root,
                              env=env, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        check(False, f"{tag}: still running after {timeout} s")
        return [], "", time.perf_counter() - t0
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"{tag} exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    return lines, proc.stdout, secs


def finite_pos(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x) and x > 0


def phase_bench(root: Path, unified: str) -> None:
    """16. ``python -m float_torch.bench --reps 10`` and ``--stream``."""
    for extra in ((), ("--stream",)):
        lines, _out, secs = run_tool(
            f"bench {' '.join(extra)}",
            ["float_torch.bench", "--reps", "10", *extra], root, unified,
            600)
        line = lines[-1] if lines else {}
        log(f"[bench] {' '.join(extra) or 'clips'}: {secs:.1f} s wall; "
            f"{json.dumps(line)}")
        check(finite_pos(line.get("value")) and "vs_baseline" in line
              and line["vs_baseline"] is None
              and (extra or 0 < line.get("mfu", -1) <= 1),
              f"bench {extra}: {line}")


def phase_configs(root: Path, unified: str) -> None:
    """17. ``python -m float_torch.tools.configs_bench``: the five
    BASELINE configs, each in its own process."""
    rows, out, secs = run_tool("configs_bench",
                               ["float_torch.tools.configs_bench", "--reps",
                                "2"], root, unified, 1200)
    table = out[out.find("| config"):].rstrip()
    log(f"[configs] {secs:.1f} s wall; rows {json.dumps(rows)}\n{table}")
    check(sorted(r.get("config") for r in rows) == [1, 2, 3, 4, 5]
          and all("error" not in r and finite_pos(r.get("fps"))
                  and finite_pos(r.get("seconds")) for r in rows),
          f"configs_bench rows {rows}")


def phase_serve_load(root: Path, unified: str) -> None:
    """18. ``python -m float_torch.tools.serve_load_bench``: the base
    lane, overload and a soak, against ``float_torch.serve``."""
    lines, out, secs = run_tool(
        "serve_load_bench", ["float_torch.tools.serve_load_bench", "--reqs",
                             "2", "--clip-sec", "4", "--overload",
                             "--soak-sec", "20", "--stall-sec", "5"],
        root, unified, 600)
    res = lines[-1] if lines else {}
    log(f"[serve load] {secs:.1f} s wall; {json.dumps(res)}\n"
        + out[out.find("| quantity"):].rstrip())
    over, soak = res.get("overload") or {}, res.get("soak") or {}
    check(res.get("errors") == [] and res.get("requests") == 4,
          f"serve load base lane: {res.get('errors')}")
    check(over.get("rejected_503", 0) >= 1
          and over.get("stream_aborts_delta", 0) >= 1
          and over.get("post_overload_probe_ok") is True
          and not over.get("other_errors"),
          f"serve load overload: {over}")
    check(soak.get("error_count") == 0
          and sum((soak.get("completed") or {}).values()) > 0,
          f"serve load soak: {soak}")


def phase_nodes(c1: dict) -> dict:
    """Phases 9-14 in one temporary directory outside the repository,
    which is gone afterwards."""
    n_chunks = math.ceil(c1["frames"].shape[0] / c1["pipe"].cfg.decode_batch)
    counts = {}
    with tempfile.TemporaryDirectory(prefix="float_chip_smoke_") as tmp:
        root = Path(tmp).resolve()
        check(not root.is_relative_to(REPO),
              f"the temporary directory {root} lies inside the repository")
        unified = phase_checkpoint(c1, root)
        parts = cut_store(unified, root)
        phase_readiness(unified, parts)
        torch.cuda.empty_cache()
        reg = phase_regular_graph(c1, root, n_chunks)
        counts["graph_regular.json"] = reg["counts"]
        counts["advanced"], reg["r_d"] = phase_advanced(reg, n_chunks)
        counts["very_advanced"] = phase_very_advanced(reg, parts)
        t0 = time.perf_counter()
        phase_serve(c1, reg, root, unified)
        log(f"[serve] phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_cli(root, unified, c1["pipe"].cfg.decode_batch)
        log(f"[cli] phase {time.perf_counter() - t0:.1f} s")
        for tag, phase in (("bench", phase_bench), ("configs", phase_configs),
                           ("serve load", phase_serve_load)):
            t0 = time.perf_counter()
            phase(root, unified)
            log(f"[{tag}] phase {time.perf_counter() - t0:.1f} s")
    left = sorted(str(p) for p in REPO.rglob("*.safetensors"))
    check(not Path(tmp).exists() and not left,
          f"checkpoint files left behind: {tmp} exists "
          f"{Path(tmp).exists()}, in the repository {left}")
    log(f"[nodes] {tmp} removed; no checkpoint file in the repository")
    return counts


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of another commit (git archive): build "
                         "its kernels and time them in turns with these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import float_torch  # noqa: F401  (fails outside a checkout)
    from float_torch.kernels import build

    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    import importlib
    import importlib.util
    log("[device] host packages the port does without: " + ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("safetensors", "cv2", "PIL", "face_alignment"))
        + f"; ffmpeg {'on' if shutil.which('ffmpeg') else 'not on'} PATH")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {', '.join(p.name for p in libs)} in "
        f"{time.perf_counter() - t0:.2f} s")

    parent = None
    if args.parent:
        t0 = time.perf_counter()
        parent = ParentKernels(args.parent)
        log(f"[build] the kernels of {args.parent} in "
            f"{time.perf_counter() - t0:.2f} s, timed in turns with these")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {"K1": phase_kernels(gen, parent)}
    rows["K7"] = phase_styled_tail(gen)
    rows["K8"] = phase_flow_merge(gen)
    rows["K9"] = phase_fmt_block(gen)
    rows.update(phase_kernel_variants(gen, parent))
    t0 = time.perf_counter()
    rows.update(phase_experiments(gen, parent))
    log(f"[experiment] phase {time.perf_counter() - t0:.1f} s")
    phase_tiny()
    c1 = phase_config1()
    phase_decode_graphs(c1)
    counts = phase_paths(c1)
    counts.update(phase_sampler_paths(c1))
    t0 = time.perf_counter()
    phase_mesh(c1)
    log(f"[mesh] phase {time.perf_counter() - t0:.1f} s")
    counts.update(phase_nodes(c1))
    for name in ("float_torch.parallel", "float_torch.bench",
                 "float_torch.tools.configs_bench",
                 "float_torch.tools.serve_load_bench",
                 "float_torch.experiments.warp_selection_matmul",
                 "float_torch.experiments.fma_dtype_bench"):
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "float_tpu"))
    check(not leaked, f"imported {leaked}")

    launches = {"K1": c1["launches"].get("warp_shared", 0),
                "K2": counts["rgb_in_kernel"].get("warp_rgb", 0),
                "K3": counts["decode_batch=1"].get("warp_per_frame", 0),
                "K4": c1["launches_k4"],
                "K5": PATHS["experiment warp_selection_matmul"].get(
                    "warp_window", 0),
                "K6": PATHS["experiment fma_dtype_bench"].get("fma_dtype", 0),
                "K7": c1["launches"].get("styled_tail", 0),
                "K8": k8_launches(c1["launches"]),
                "K9": k9_launches(c1["launches"])}
    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} check(s) failed")
        return 1
    names = {"K1": "warp_shared", "K2": "warp_rgb", "K3": "warp_per_frame",
             "K4": "K4", "K5": "warp_window", "K6": "fma_dtype",
             "K7": "styled_tail"}
    summed = {"K8": k8_launches, "K9": k9_launches}
    kernels = [dict(ROWS[k], launches=launches[k], **rows[k],
                    launches_by_path={p: summed[k](c) if k in summed
                                      else c.get(names[k], 0)
                                      for p, c in PATHS.items()})
               for k in ROWS]
    log(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
