"""The bilinear warp of the TPU's selection-matmul experiment (twin of
``experiments/pallas_warp_selection_matmul.py``), and its answer on an
H100.

The TPU experiment asked whether the matrix unit beats a gather for the
decode's warp: a bilinear tap is a weighted one-hot selection, so a
tile's output is a sum over window rows of (selection weights) x (window
row).  Mosaic has no vector gather, so on the TPU the matrix unit was the
only way to select.  On an NVIDIA H100 80GB HBM3 (700 W power limit,
``chip_smoke.py`` phase 7b, 512^2 x 32 channels, 16 frames, bf16) the
selection products on the tensor cores (``mma.sync`` bf16, only the
products that can hold a nonzero weight, one accumulator per tap) took
0.6145 ms, 27.7 % of the 0.1703 ms bytes bound, where the gather K3 took
0.2314 ms and ``F.grid_sample`` 0.4583 ms: the function does about two
operations per byte, so no tensor-core design can be bound by anything
but bytes, and selecting on them costs latency, fragments and barriers.
So K5 is now a gather on the CUDA cores (``kernels/csrc/warp_window.cu``)
that computes the experiment's function exactly.

The function (``warp_bilinear_windowed``, the TPU's
``warp_bilinear_pallas``): feat (B, C, H, W) sampled at grid (B, H, W, 2)
with grid_sample's bilinear taps, zeros padding, align_corners=False.  An
output pixel in tile (i, j) = (y // 8, x // 128) reads the window rows
[rs, rs + wr) x columns [cs, cs + wc) (``window_starts``).  A pixel whose
in-image taps all lie there takes the selection product: each tap weighs
bf16(wx * wy), the four products are summed in f32, row y0 before row
y0 + 1, and rounded once to bf16 (``warp_window_ref``).  Any other pixel
(``overflow_mask``) takes the exact warp,
``float_torch.ops.warp.grid_sample_bilinear_ref``.  Taps follow
``float_torch.ops.warp.tap_floor``: a NaN coordinate gives NaN in every
channel, as on the TPU.

CUDA tensors take K5; CPU tensors take the plain version.  ``main``
prints the experiment's table: per level, K5 beside K3 (the exact warp),
``F.grid_sample``, the plain version, its bound and its overflow pixels.

    python -m float_torch.experiments.warp_selection_matmul [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import sys

import torch
import torch.nn.functional as F

from ..kernels.warp_window import TC, TR
from ..ops.warp import grid_sample_bilinear_ref, tap_floor, warp_per_frame
from ..runtime.pipeline import _checked_device
from ..utils.flops import H100_HBM_BPS
from . import time_ms

# The TPU experiment's levels (size, channels) and frame chunk.
LEVELS = ((128, 128), (256, 64), (512, 32))
BATCH = 16
# --device cpu: the plain version at a tiny size.
CPU_LEVELS = ((128, 16),)
CPU_BATCH = 1


def window_size(h: int, w: int, my: int, mx: int) -> tuple:
    """(wr, wc): the window's rows and columns."""
    return min(h, TR + 2 * my), min(w, TC + 2 * mx)


def window_starts(h: int, w: int, my: int, mx: int, device=None) -> tuple:
    """(rs (H,), cs (W,)): the first window row of each output row's tile
    and the first window column of each output column's tile."""
    wr, wc = window_size(h, w, my, mx)
    ys = torch.arange(h, device=device) // TR * TR
    xs = torch.arange(w, device=device) // TC * TC
    return (ys - my).clamp(0, h - wr), (xs - mx).clamp(0, w - wc)


def _taps(h: int, w: int, gy: torch.Tensor, gx: torch.Tensor) -> tuple:
    """(y0, x0, ty, tx): the top-left tap (``tap_floor``: int64, NaN -> 0,
    far values saturated) and the fractions, rounded op by op in f32."""
    y0, ty = tap_floor(((gy.float() + 1.0) * h - 1.0) * 0.5)
    x0, tx = tap_floor(((gx.float() + 1.0) * w - 1.0) * 0.5)
    return y0, x0, ty, tx


def _bad(t, lo, size: int, win: int):
    """Tap index t lies in the image but outside [lo, lo + win)."""
    return (t >= 0) & (t < size) & ((t < lo) | (t >= lo + win))


def overflow_mask(h: int, w: int, gy: torch.Tensor, gx: torch.Tensor,
                  my: int, mx: int) -> torch.Tensor:
    """(B, H, W) bool: some in-image tap of the pixel falls outside its
    tile's window."""
    y0, x0, _, _ = _taps(h, w, gy, gx)
    wr, wc = window_size(h, w, my, mx)
    rs, cs = window_starts(h, w, my, mx, gy.device)
    rs, cs = rs[None, :, None], cs[None, None, :]
    return (_bad(y0, rs, h, wr) | _bad(y0 + 1, rs, h, wr)
            | _bad(x0, cs, w, wc) | _bad(x0 + 1, cs, w, wc))


def warp_window_ref(feat_nhwc: torch.Tensor, gy: torch.Tensor,
                    gx: torch.Tensor, my: int, mx: int,
                    weight_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of K5's body (the TPU's ``_warp_pallas_nhwc``): feat
    (B, H, W, C), gy, gx (B, H, W) -> (B, H, W, C) in feat's dtype.  Each
    axis weighs a tap in the image and in the pixel's window by its
    bilinear weight and any other tap 0, and a tap weighs
    ``weight_dtype(wy * wx)``, as the TPU body's selection product (a NaN
    axis weight makes the pixel NaN there too); the products are summed in
    f32 as (t00 + t01) + (t10 + t11) and rounded once.  Overflow pixels
    keep their in-window taps only, as the TPU body computes them."""
    b, h, w, c = feat_nhwc.shape
    y0, x0, ty, tx = _taps(h, w, gy, gx)
    wr, wc = window_size(h, w, my, mx)
    rs, cs = window_starts(h, w, my, mx, feat_nhwc.device)
    rs, cs = rs[None, :, None], cs[None, None, :]
    flat = feat_nhwc.float().reshape(b, h * w, c)
    frame = torch.arange(b, device=feat_nhwc.device)[:, None, None]
    xs = []
    for dx, wx in ((0, 1.0 - tx), (1, tx)):
        xx = x0 + dx
        ok = (xx >= 0) & (xx < w) & (xx >= cs) & (xx < cs + wc)
        xs.append((xx, ok, torch.where(ok, wx, 0.0)))
    rows = []
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        yy = y0 + dy
        row_ok = (yy >= 0) & (yy < h) & (yy >= rs) & (yy < rs + wr)
        wy = torch.where(row_ok, wy, 0.0)
        row = None
        for xx, ok, wx in xs:
            sel = (wy * wx).to(weight_dtype).float()
            idx = torch.where(row_ok & ok, yy * w + xx, 0)
            term = flat[frame, idx] * sel[..., None]
            row = term if row is None else row + term
        rows.append(row)
    return (rows[0] + rows[1]).to(feat_nhwc.dtype)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance of two bf16 tensors in bf16 ulps: how many
    representable values lie between them (+0 and -0 are one value), as
    int32.  K5's gate against its plain version is 1."""
    def ordinal(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordinal(a) - ordinal(b)).abs()


def supports(feat_shape, grid_shape, dtype) -> bool:
    """Kernel applicability, exactly the TPU's: bf16, H, W >= 128, H % 8 ==
    0, W % 128 == 0, the grid at the map's size."""
    b, c, h, w = feat_shape
    return (dtype == torch.bfloat16 and h >= 128 and w >= 128
            and h % TR == 0 and w % TC == 0
            and grid_shape[1] == h and grid_shape[2] == w
            and c % min(c, 128) == 0)


def _check(feat_nchw: torch.Tensor, grid: torch.Tensor) -> None:
    if not supports(feat_nchw.shape, grid.shape, feat_nchw.dtype):
        raise ValueError(f"warp_bilinear_windowed takes a bf16 (B, C, H, W) "
                         f"map with H, W >= 128, H % {TR}, W % {TC} == 0 and "
                         f"a grid at its size, got {tuple(feat_nchw.shape)} "
                         f"{feat_nchw.dtype} and {tuple(grid.shape)}")
    if grid.ndim != 4 or grid.shape[0] != feat_nchw.shape[0] \
            or grid.shape[-1] != 2:
        raise ValueError(f"grid must be (B, H, W, 2), got "
                         f"{tuple(grid.shape)}")


def warp_bilinear_windowed_ref(feat_nchw: torch.Tensor, grid: torch.Tensor,
                               my: int = 8, mx: int = 64) -> torch.Tensor:
    """Plain version of ``warp_bilinear_windowed`` on any device: the
    window's selection product, overflow pixels from the exact warp."""
    _check(feat_nchw, grid)
    h, w = feat_nchw.shape[2:]
    gy, gx = grid[..., 1], grid[..., 0]
    out = warp_window_ref(feat_nchw.permute(0, 2, 3, 1), gy, gx, my, mx)
    ovf = overflow_mask(h, w, gy, gx, my, mx)
    return torch.where(ovf[:, None], grid_sample_bilinear_ref(feat_nchw, grid),
                       out.permute(0, 3, 1, 2))


def warp_bilinear_windowed(feat_nchw: torch.Tensor, grid: torch.Tensor,
                           my: int = 8, mx: int = 64) -> torch.Tensor:
    """grid_sample_bilinear by the windowed selection products (twin of
    ``warp_bilinear_pallas``): feat (B, C, H, W) bf16, grid (B, H, W, 2)
    normalised xy -> (B, C, H, W) bf16.  CUDA tensors take K5 (one launch,
    overflow pixels exact inside it), CPU tensors the plain version.
    Raises on what ``supports`` refuses."""
    _check(feat_nchw, grid)
    if feat_nchw.device.type == "cpu" and grid.device.type == "cpu":
        return warp_bilinear_windowed_ref(feat_nchw, grid, my, mx)
    from ..kernels.warp_window import warp_window_cuda
    nhwc = feat_nchw.permute(0, 2, 3, 1).contiguous()
    out = warp_window_cuda(nhwc, grid.float().contiguous(), my, mx)
    return out.permute(0, 3, 1, 2)


def make_grid(b: int, size: int, amp_px: float, gen: torch.Generator,
              device) -> torch.Tensor:
    """(b, size, size, 2): the pixel-centre identity plus a smooth random
    flow of at most ``amp_px`` pixels, from ``gen``."""
    coarse = max(2, size // 32)
    low = torch.randn((b, 2, coarse, coarse), generator=gen, device=device)
    low = low / low.abs().amax() * amp_px
    flow = F.interpolate(low, size=(size, size), mode="bilinear",
                         align_corners=False)
    ax = torch.linspace(-1 + 1 / size, 1 - 1 / size, size, device=device)
    gy, gx = torch.meshgrid(ax, ax, indexing="ij")
    return (torch.stack([gx, gy], -1) + flow.permute(0, 2, 3, 1)
            * (2.0 / size)).contiguous()


def bytes_bound_ms(b: int, size: int, c: int) -> float:
    """Least ms of one call on an H100: feat and grid read once, the
    output written once, at the HBM rate."""
    n_bytes = b * size * size * (2 * c * 2 + 8)
    return n_bytes / H100_HBM_BPS * 1e3


def level_row(size: int, c: int, b: int, device: torch.device,
              gen: torch.Generator, amp_px: float = 3.0,
              iters: int = 20) -> dict:
    """One row of the table at (size, c, b) on a smooth flow."""
    feat = torch.randn((b, c, size, size), generator=gen,
                       device=device).to(torch.bfloat16)
    grid = make_grid(b, size, amp_px, gen, device)
    gy, gx = grid[..., 1], grid[..., 0]
    row = {"size": size, "c": c, "b": b,
           "overflow_px": int(overflow_mask(size, size, gy, gx, 8, 64)
                              .sum().item()),
           "plain_ms": time_ms(
               lambda: warp_bilinear_windowed_ref(feat, grid), device,
               max(1, iters // 10))}
    if device.type == "cuda":
        # the kernels on the NHWC map; F.grid_sample on the NCHW one, its
        # grid cast to the map's dtype (outside the timing)
        from ..kernels.warp_window import warp_window_cuda
        nhwc = feat.permute(0, 2, 3, 1).contiguous()
        grid_bf16 = grid.to(feat.dtype)
        row.update(
            k5_ms=time_ms(lambda: warp_window_cuda(nhwc, grid), device,
                          iters),
            k3_ms=time_ms(lambda: warp_per_frame(nhwc, grid), device, iters),
            grid_sample_ms=time_ms(
                lambda: F.grid_sample(feat, grid_bf16, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=False), device, iters),
            bound_ms=bytes_bound_ms(b, size, c))
    return row


def format_row(row: dict) -> str:
    head = f"{row['size']}^2 x {row['c']} B={row['b']}"
    ovf = f"overflow px {row['overflow_px']}"
    if "k5_ms" not in row:
        return (f"{head}: plain {row['plain_ms']:.3f} ms (CPU host clock); "
                f"{ovf}")
    return (f"{head}: K5 {row['k5_ms']:.4f} ms, K3 {row['k3_ms']:.4f} ms, "
            f"F.grid_sample {row['grid_sample_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"(bytes, {row['bound_ms'] / row['k5_ms']:.1%}); {ovf}")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain version at a "
                         "tiny size")
    device = _checked_device(ap.parse_args(argv).device)
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    if on_card:
        print(f"device: {torch.cuda.get_device_name(device)}")
    rows = []
    for size, c in (LEVELS if on_card else CPU_LEVELS):
        rows.append(level_row(size, c, BATCH if on_card else CPU_BATCH,
                              device, gen))
        print(format_row(rows[-1]), flush=True)
        if not all(math.isfinite(v) for v in rows[-1].values()):
            raise RuntimeError(f"non-finite reading: {rows[-1]}")
    return rows


if __name__ == "__main__":
    try:
        main()
    except RuntimeError as e:
        print(f"warp_selection_matmul: {e}", file=sys.stderr)
        sys.exit(1)
