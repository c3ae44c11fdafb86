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
   driven paths give it (24, 12, 8, 4, 1), on every grid kind of
   ``make_grid``: flows inside and far beyond its staged window, grids
   that leave the image, sparse far pixels in every tile, NaN and
   infinite entries; timed at each level and batch beside its bound, and
   at 24 frames beside F.grid_sample;
4. the port on the card against the port on the CPU at a tiny config in
   float32 (TF32 off), stage by stage;
5. BASELINE config 1 end to end: 617.5 M synthetic parameters, a 512²
   portrait and 10 s of 16 kHz audio -> 250 frames, emotion predicted by
   the SER, 3-way CFG, 10 Euler steps, bf16 decode in 24-frame chunks;
   three timed clips (median), the launch counts of each checked;
6. the first decode chunk through the kernels and through the plain
   warps, and the largest tap displacement of its flows at each level;
7. K3 (``warp_per_frame``) at every level of a 512² decode, K2
   (``warp_rgb``) at the 128²..512² levels and K4's shapes through K1
   (the last two on every grid kind), each against its plain version,
   then each kernel's row of the kernel table: ms, plain ms, library ms
   and bound at config-1 shapes;
8. config 1's other paths, each with its launch counts: a decode with the
   ToRGB in the last warp (K2), a one-frame-chunk decode (K3), decode to
   host, ``generate_stream`` on the u8 and 4:2:0 wires, and
   ``generate_batch`` of two portraits with 10 s and 6 s of audio.

A failed check is printed and the run goes on, so one run reports every
phase; the script then exits 1 before printing its result lines.
Output: one line per measurement, then a JSON line with every kernel's
numbers (K1's per level and batch under ``levels``), the card's name and
power limit as nvidia-smi reports them, and last the line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
U8_STEP = 1.0 / 255.0
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 FLOP/s
# outside the tensor cores (the warps' multiply-adds run there).
HBM_BPS = 3.35e12
F32_FLOPS = 67e12

FAILURES: list = []


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
                               (torch.float32, (12,))):
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
    check(got == {k: v for k, v in want.items() if v},
          f"{name}: launches {got}, expected {want}")
    check(k4 == want_k4,
          f"{name}: {k4} launches at K4's shapes, expected {want_k4}")
    log(f"[path] {name}: {secs * 1e3:.1f} ms, launches {got}, of which at "
        f"K4's shapes (C <= 32, B % 4 == 0) {k4}")
    return out, secs, got


def check_frames(name: str, got, ref, tol: float) -> None:
    got = torch.as_tensor(got).float().to(ref.device)
    lo, hi = got.min().item(), got.max().item()
    check(bool(torch.isfinite(got).all()) and 0.0 <= lo and hi <= 1.0,
          f"{name}: frames not finite or outside [0, 1]: {lo}..{hi}")
    err = (got - ref).abs().max().item() if got.shape == ref.shape \
        else float("inf")
    log(f"[path] {name}: {tuple(got.shape)} frames vs generate's max|diff| "
        f"{err:.3e} (tol {tol:.3g})")
    check(err <= tol, f"{name}: vs generate max|diff| {err} > {tol}")


def phase_paths(c1: dict) -> dict:
    """Config 1's other paths through the entry points a user calls."""
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
        {"warp_shared": (n_lv - 1) * n_chunks, "warp_rgb": n_chunks}, 0)
    check_frames("decode rgb_in_kernel=True", out, frames, DECODE_TOL)

    # one-frame decode chunks: every level warps per frame (K3)
    out, secs, counts["decode_batch=1"] = run_path(
        "decode decode_batch=1", lambda: decode(decode_batch=1),
        {"warp_per_frame": n_lv * t_frames}, 0)
    log(f"[path] decode_batch=1: {t_frames} frames in {secs:.3f} s, "
        f"{t_frames / secs:.2f} frames/s")
    check_frames("decode decode_batch=1", out, frames, DECODE_TOL)

    out, _, counts["decode_to_host"] = run_path(
        "decode_to_host", lambda: pipe.decode_to_host(s_r, feats, r_d),
        {"warp_shared": n_lv * n_chunks}, n_chunks)
    check_frames("decode_to_host", out, frames, DECODE_TOL + U8_STEP)

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
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        libs = list(ex.map(build.build, KERNEL_SOURCES))
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
    kernels = [dict(ROWS[k], launches=launches[k], **rows[k])
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
