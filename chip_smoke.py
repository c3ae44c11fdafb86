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
   driven paths give it (bf16: 24, 12, 8, 4, 1; float32, the Very
   Advanced tier's decode and its reference: 24, 12, 8, 4), on every
   grid kind of ``make_grid``: flows inside and far beyond its staged
   window, grids that leave the image, sparse far pixels in every tile,
   NaN and infinite entries; timed at each level and batch beside its bound, and
   at 24 frames beside F.grid_sample;
4. the port on the card against the port on the CPU at a tiny config in
   float32 (TF32 off), stage by stage;
5. BASELINE config 1 end to end: 617.5 M synthetic parameters, a 512²
   portrait and 10 s of 16 kHz audio -> 250 frames, emotion predicted by
   the SER, 3-way CFG, 10 Euler steps, bf16 decode in 24-frame chunks;
   three timed clips (median), the launch counts of each checked;
6. the first decode chunk through the kernels and through the plain
   warps, and the largest tap displacement of its flows at each level;
7. K3 (``warp_per_frame``) at every level of a 512² decode and, through
   ``grid_sample_bilinear``, at channel counts that fill no 16-byte
   vector (an RGB image in bf16, C = 5 in float32), K2
   (``warp_rgb``) at the 128²..512² levels and K4's shapes through K1
   (the last two on every grid kind), each against its plain version,
   then each kernel's row of the kernel table: ms, plain ms, library ms
   and bound at config-1 shapes;
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
   first-frame latency).  The temporary directory is then gone, and no
   checkpoint file is left in the repository.

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
# Sampling grids every shared-map kernel is held to its plain version on
# (make_grid): the staged kernels' windows, their device-memory fallback
# and coordinates that must never become an index.
GRID_KINDS = ("smooth", "far", "out", "mixed", "nonfinite")
# the kernel libraries a parent checkout (``--parent``) builds
KERNEL_SOURCES = ("warp_shared", "warp_rgb")
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
}
NEW_KERNELS = ("warp_per_frame", "warp_rgb")
# Tolerances.  bf16 kernel vs plain: four f32 products summed in another
# order, then one bf16 rounding -> 2^-7 of the map's magnitude.  f32: the
# kernel rounds in the plain version's order; allow a few ulp.
BF16_TOL = 2.0 ** -7
F32_TOL = 1e-6
# K2 sums its C->3 contraction in another order than the plain matmul:
# 2^-7 (bf16) or 1e-5 (f32) of max|feat| * max_o sum_c |wk[o, c]|.
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
    """K1, K2 and K3 of another checkout (``root``, e.g. the parent commit
    unpacked by ``git archive``), called through that checkout's own
    wrappers: its ``float_torch`` is imported under another name, so its
    kernels are built from its own sources into its own ``build/`` and
    launched with its own C signatures, whatever they are."""

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
        self.shared, self.rgb, build = (
            importlib.import_module(f"{kernels}.{m}")
            for m in ("warp_shared", "warp_rgb", "build"))
        for mod in (self.shared, self.rgb, build):
            if not Path(mod.__file__).is_relative_to(pkg):
                raise RuntimeError(f"{mod.__name__} loaded from {mod.__file__}")
        with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
            list(ex.map(build.build, KERNEL_SOURCES))

    def k1(self, feat, grid):
        return lambda: self.shared.warp_shared_cuda(feat, grid)

    def k3(self, feat, grid):
        return lambda: self.shared.warp_per_frame_cuda(feat, grid)

    def k2(self, feat, grid, wk):
        return lambda: self.rgb.warp_rgb_cuda(feat, grid, wk)


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
    err = (out.float() - ref.float()).abs().max().item()
    check(out.shape == ref.shape and err <= tol,
          f"{name}: max|diff| {err} > {tol}")
    return err


def phase_kernels(gen: torch.Generator, parent=None) -> dict:
    """K1 against its plain version at every level, batch and grid kind
    (bit for bit), then its row: a 24-frame chunk's 7 levels, and each
    level at every batch of K1_BATCHES but 1 beside its bound (and the
    parent commit's build, ``parent``, timed in turns with it)."""
    from float_torch.ops.warp import warp_shared, warp_shared_ref

    max_err = 0.0
    for size, c in LEVELS:
        for dtype, batches in ((torch.bfloat16, K1_BATCHES),
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


def phase_kernel_variants(gen: torch.Generator, parent=None) -> dict:
    """K3, K2 and K4's shapes against their plain versions, then their
    rows of the kernel table at config-1 shapes (each in turns with the
    parent commit's build, ``parent``, when given)."""
    from float_torch.ops.warp import (warp_per_frame, warp_per_frame_ref,
                                      warp_rgb, warp_rgb_ref, warp_shared,
                                      warp_shared_ref)
    errs = {"K2": 0.0, "K3": 0.0, "K4": 0.0}

    for size, c in LEVELS:
        for dtype in (torch.bfloat16, torch.float32):
            for b in (1, 4):
                feat = rand_feat(gen, b, size, c, dtype)
                scale = feat.float().abs().max().item()
                tol = (BF16_TOL if dtype == torch.bfloat16 else F32_TOL) \
                    * scale
                for kind in ("smooth", "far", "out"):
                    grid = make_grid(kind, b, size, gen)
                    errs["K3"] = max(errs["K3"], compare(
                        f"warp_per_frame {size}²xC{c} B={b} {dtype} {kind}",
                        warp_per_frame(feat, grid),
                        warp_per_frame_ref(feat, grid), tol))
        log(f"[kernel] warp_per_frame {size}^2 C={c}: agrees with the plain "
            f"version (bf16 and f32, B 1 and 4)")
    # channels that fill no 16-byte vector (an RGB image at a size the TPU
    # kernel takes), one channel a thread, through grid_sample_bilinear
    from float_torch.kernels import LAUNCHES
    from float_torch.ops.warp import (grid_sample_bilinear,
                                      grid_sample_bilinear_ref)
    for size, c, dtype in ((256, 3, torch.bfloat16), (64, 5, torch.float32)):
        feat = rand_feat(gen, 2, size, c, dtype).permute(0, 3, 1, 2)
        tol = (BF16_TOL if dtype == torch.bfloat16 else F32_TOL) \
            * feat.float().abs().max().item()
        for kind in ("smooth", "far", "out"):
            grid = make_grid(kind, 2, size, gen)
            before = LAUNCHES["warp_per_frame"]
            out = grid_sample_bilinear(feat, grid)
            check(LAUNCHES["warp_per_frame"] == before + 1,
                  f"grid_sample_bilinear C={c} {dtype}: K3 not launched")
            errs["K3"] = max(errs["K3"], compare(
                f"grid_sample_bilinear {size}²xC{c} B=2 {dtype} {kind}", out,
                grid_sample_bilinear_ref(feat, grid), tol))
        log(f"[kernel] warp_per_frame {size}^2 C={c} {dtype}: K3 through "
            f"grid_sample_bilinear agrees with the plain version")

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
    check(not any(launches.get(k, 0) for k in NEW_KERNELS),
          f"the default generate launched {launches}, expected only "
          f"warp_shared")
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


def u8_levels(a, b) -> tuple:
    """max and mean |a - b| of two uint8 stacks (numpy or torch), in
    levels, on the card."""
    d = (torch.as_tensor(a).cuda().int() - torch.as_tensor(b).cuda().int()
         ).abs()
    return int(d.max().item()), d.float().mean().item()


def run_path(name: str, fn, want: dict, want_k4: int):
    """Run ``fn`` with every launch count at 0 before it; check the counts
    read right after against ``want`` (kernels not named must be 0) and
    the warp_shared launches at K4's shapes against ``want_k4``.
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
    check(got == {k: v for k, v in want.items() if v},
          f"{name}: launches {got}, expected {want}")
    check(k4 == want_k4,
          f"{name}: {k4} launches at K4's shapes, expected {want_k4}")
    log(f"[path] {name}: {secs * 1e3:.1f} ms, launches {got}, of which at "
        f"K4's shapes (C <= 32, B % 4 == 0) {k4}")
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


def phase_paths(c1: dict) -> dict:
    """Config 1's other paths through the entry points a user calls; each
    gate against ``generate``'s frames with its controls."""
    from float_torch.ops.yuv420 import i420_to_rgb_u8, rgb01_to_i420
    from float_torch.runtime.decode import (_prepare, decode_chunk,
                                            decode_latents)
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
        {"warp_shared": (n_lv - 1) * n_chunks, "warp_rgb": n_chunks}, 0)
    check_frames("decode rgb_in_kernel=True", out, frames, DECODE_TOL)
    out_of_order("decode rgb_in_kernel=True", out, frames, DECODE_TOL)

    # one-frame decode chunks: every level warps per frame (K3)
    out, secs, counts["decode_batch=1"] = run_path(
        "decode decode_batch=1", lambda: decode(decode_batch=1),
        {"warp_per_frame": n_lv * t_frames}, 0)
    log(f"[path] decode_batch=1: {t_frames} frames in {secs:.3f} s, "
        f"{t_frames / secs:.2f} frames/s")
    check_frames("decode decode_batch=1", out, frames, DECODE_TOL)
    out_of_order("decode decode_batch=1", out, frames, DECODE_TOL)

    out, _, counts["decode_to_host"] = run_path(
        "decode_to_host", lambda: pipe.decode_to_host(s_r, feats, r_d),
        {"warp_shared": n_lv * n_chunks}, n_chunks)
    check_frames("decode_to_host", out, frames, DECODE_TOL + U8_STEP)
    out_of_order("decode_to_host", out, frames, DECODE_TOL + U8_STEP)
    # the gate's other control: generate's first chunk decoded again with
    # its warp grids rounded to bf16
    nb = pipe.cfg.decode_batch
    wa_c, feats_c = _prepare(s_r, feats, r_d[:nb], nb, pipe.compute_dtype)
    with torch.inference_mode():
        coarse = decode_chunk(pipe.syn_cast, wa_c, feats_c, size,
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
            {"warp_shared": n_lv * n_disp}, n_disp)
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
        {"warp_shared": n_lv * n_b}, n_b)
    log(f"[path] generate_batch: {t_frames + t2} frames in {secs:.3f} s, "
        f"{(t_frames + t2) / secs:.2f} frames/s")
    with torch.inference_mode():
        ref2 = pipe.generate(img2, waves[1][None], emotion="none",
                             seed=pipe.cfg.seed + 1)
    check(len(outs) == 2, f"generate_batch returned {len(outs)} clips")
    check_frames("generate_batch clip 0", outs[0], frames,
                 DECODE_TOL + U8_STEP)
    check_frames("generate_batch clip 1", outs[1], ref2, DECODE_TOL + U8_STEP)
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
            {"warp_shared": len(LEVELS) * n_chunks}, n_chunks)
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
        n_chunks)
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
    real = ws.warp_shared_cuda
    ws.warp_shared_cuda = lambda f, g: real(f, g.to(torch.bfloat16).float())
    try:
        coarse = pc.run_parity(pipe, acts)
    finally:
        ws.warp_shared_cuda = real
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
        va_chunks)
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
    from float_torch.runtime.decode import (_prepare, decode_chunk,
                                            stream_chunk_count)
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
        check(health["status"] == "ok" and health["device"] == "cuda"
              and health["device_name"] == torch.cuda.get_device_name(0)
              and health["weights"] == "real", f"/health {health}")

        got, secs, _ = run_path(
            "/v1/generate", lambda: run_client("generate", url, root),
            {"warp_shared": n_lv * n_chunks}, n_chunks)
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
            wa_c, feats_c = _prepare(s_r, feats, r_d[0, :nb], nb,
                                     pl.compute_dtype)
            again = decode_chunk(pl.syn_cast, wa_c, feats_c, size,
                                 out_u8=True)
            coarse = decode_chunk(pl.syn_cast, wa_c, feats_c, size,
                                  out_u8=True, warps=bf16_grid_warps())
        for enc in ("raw", "jpeg"):
            got, _, _ = run_path(
                f"/v1/generate stream {enc}",
                lambda: run_client(f"stream-{enc}", url, root),
                {"warp_shared": n_lv * n_stream}, n_stream)
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
            {"warp_shared": n_lv * n_b}, n_b)
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
    rows.update(phase_kernel_variants(gen, parent))
    phase_tiny()
    c1 = phase_config1()
    counts = phase_paths(c1)
    counts.update(phase_nodes(c1))
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "float_tpu"))
    check(not leaked, f"imported {leaked}")

    launches = {"K1": c1["launches"].get("warp_shared", 0),
                "K2": counts["rgb_in_kernel"].get("warp_rgb", 0),
                "K3": counts["decode_batch=1"].get("warp_per_frame", 0),
                "K4": c1["launches_k4"]}
    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} check(s) failed")
        return 1
    names = {"K1": "warp_shared", "K2": "warp_rgb", "K3": "warp_per_frame",
             "K4": "K4"}
    kernels = [dict(ROWS[k], launches=launches[k], **rows[k],
                    launches_by_path={p: c.get(names[k], 0)
                                      for p, c in PATHS.items()})
               for k in ("K1", "K2", "K3", "K4")]
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
