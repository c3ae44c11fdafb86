"""Launch plans of the shared-map warps (K1 ``warp_shared`` and K2
``warp_rgb``, ``csrc/warp_shared.cu`` and ``csrc/warp_rgb.cu``).

A staged kernel's thread block owns one output tile: ``tile_h`` x
``tile_w`` pixels x ``cslice`` channels x ``frames`` frames.  It stages
a window of the map once (at most the tile plus ``halo`` pixels on each
side and 1 on the far side) and gathers every frame's taps from there; a
tap outside the window reads device memory.  K1 copies the tile's grid
entries of its frames into shared memory first and fits the window to
their taps, then stages the window's channel slice; K2 stages the
largest window, the map contracted to its 3 RGB channels, and reads each
grid entry where it uses it.  The block index is (spatial tile, channel
slice, frame group), tiles row-major.  K1's ``DIRECT`` plan skips all of
that for calls too small to pay for it.

Everything here mirrors the launchers' arithmetic (``smem_bytes``,
``grid_dims``), so the CPU tests can check a plan's coverage and its
shared memory without a card.  The rules of ``plan_shared`` and
``plan_rgb`` come from timing candidate plans at every config-1 level
and frame batch on an H100 (``PERF.md``).  The planner raises on shapes
it does not take; it never falls back to a plain version.
"""
from __future__ import annotations

import math
from typing import Iterator, NamedTuple

# dynamic shared memory of a block: Hopper's 227 KB less 1 KB for the
# kernels' static shared memory (csrc/warp_common.cuh kSmemLimit)
SMEM_LIMIT = 232448 - 1024
N_SM = 132                    # H100 SXM streaming multiprocessors
MAX_GRID_YZ = 65535           # CUDA's limit on gridDim.y and gridDim.z
SLICE_BYTES = 128             # K1's channel slice: a pixel's 128 bytes at most
HALO = 3                      # staged window: the tile + 3 px each side (+1)
DIRECT_BELOW = 16 << 20       # K1 output bytes below which DIRECT wins
GRID_TILE = 3072              # K1: most (frame, pixel) grid entries a block
                              # stages before tiles narrow to 16 columns
VPTS = (4, 2, 1)              # vectors per thread the kernels are built for


class Plan(NamedTuple):
    tile_h: int               # 0: the direct plan (K1 only, see DIRECT)
    tile_w: int
    cslice: int               # channels per block (K2: all of C)
    frames: int               # frames per block
    halo: int                 # window cap: tile + halo px each side, + 1
    vpt: int                  # 16-byte vectors of a pixel per thread
                              # (K2: 1, a thread takes whole pixels)


# K1's direct plan: no tiles and no staging, one thread per (pixel, 16-byte
# vector) gathering its 4 taps from device memory (the first version).  It
# wins where a call writes too little to hide the staged kernel's
# barriers and copies behind (the 8²-16² levels, and small batches).
DIRECT = Plan(0, 0, 0, 0, 0, 1)


def vec(esize: int) -> int:
    """Channels in one 16-byte vector."""
    return 16 // esize


def window_cap(plan: Plan, h: int, w: int) -> tuple[int, int]:
    """The most rows and columns a block stages."""
    return (min(plan.tile_h + 2 * plan.halo + 1, h),
            min(plan.tile_w + 2 * plan.halo + 1, w))


def smem_bytes(plan: Plan, h: int, w: int, c: int, esize: int,
               rgb: bool = False) -> int:
    """Dynamic shared memory of one block.  K1: the window's channel slice
    and the tile's grid entries of its frames (float2, rounded up to 16
    bytes).  K2: the contracted window (16 bytes a pixel) and wk (3, C)
    f32."""
    if plan == DIRECT:
        return 0
    cap_h, cap_w = window_cap(plan, h, w)
    if rgb:
        return cap_h * cap_w * 16 + 3 * c * 4
    return (cap_h * cap_w * plan.cslice * esize
            + -(-plan.frames * plan.tile_h * plan.tile_w * 8 // 16) * 16)


def grid_dims(plan: Plan, b: int, h: int, w: int, c: int):
    """(spatial tiles, channel slices, frame groups): gridDim x, y, z."""
    if plan == DIRECT:
        return 1, 1, 1
    tiles = math.ceil(h / plan.tile_h) * math.ceil(w / plan.tile_w)
    return tiles, c // plan.cslice, math.ceil(b / plan.frames)


def blocks(plan: Plan, b: int, h: int, w: int,
           c: int) -> Iterator[tuple[range, range, range, range]]:
    """Each block's (frames, rows, columns, channels), as the kernels
    decode their block index; the direct plan's flat thread index covers
    the whole output once."""
    if plan == DIRECT:
        yield range(b), range(h), range(w), range(c)
        return
    tiles, slices, groups = grid_dims(plan, b, h, w, c)
    tiles_x = math.ceil(w / plan.tile_w)
    for z in range(groups):
        for y in range(slices):
            for x in range(tiles):
                ty0 = (x // tiles_x) * plan.tile_h
                tx0 = (x % tiles_x) * plan.tile_w
                b0 = z * plan.frames
                c0 = y * plan.cslice
                yield (range(b0, min(b0 + plan.frames, b)),
                       range(ty0, min(ty0 + plan.tile_h, h)),
                       range(tx0, min(tx0 + plan.tile_w, w)),
                       range(c0, c0 + plan.cslice))


def check(plan: Plan, b: int, h: int, w: int, c: int, esize: int,
          rgb: bool = False) -> Plan:
    """Raise unless the launcher takes ``plan`` for this shape."""
    v = vec(esize)
    if min(b, h, w, c) < 1 or c % v:
        raise ValueError(f"shape B={b} H={h} W={w} C={c} is not a warp of "
                         f"whole {v}-channel vectors")
    if plan == DIRECT and not rgb:
        return plan
    if min(plan.tile_h, plan.tile_w, plan.frames) < 1 or plan.halo < 0 \
            or plan.vpt not in VPTS:
        raise ValueError(f"bad plan {plan}")
    if plan.cslice < v or plan.cslice % v or c % plan.cslice \
            or (rgb and plan.cslice != c):
        raise ValueError(f"channel slice {plan.cslice} does not divide C={c} "
                         f"into {v}-channel vectors" + (" (K2 takes all of C)"
                                                        if rgb else ""))
    if rgb and plan.vpt != 1:
        raise ValueError("K2 takes whole pixels a thread (vpt 1)")
    if (plan.cslice // v) % plan.vpt:
        raise ValueError(f"{plan.vpt} vectors per thread do not divide the "
                         f"{plan.cslice // v} vectors of a pixel's slice")
    _, slices, groups = grid_dims(plan, b, h, w, c)
    if max(slices, groups) > MAX_GRID_YZ:
        raise ValueError(f"plan {plan} needs {slices} x {groups} blocks in "
                         f"grid y, z (at most {MAX_GRID_YZ})")
    n = smem_bytes(plan, h, w, c, esize, rgb)
    if n > SMEM_LIMIT:
        raise ValueError(f"plan {plan} needs {n} bytes of shared memory "
                         f"(at most {SMEM_LIMIT})")
    return plan


def _frames(b: int, groups: int) -> int:
    """Frames per block for at most ``groups`` equal frame groups: the
    most groups that divide B."""
    groups = min(b, max(1, groups))
    groups = max(g for g in range(1, groups + 1) if b % g == 0)
    return max(b // groups, math.ceil(b / MAX_GRID_YZ))


def _vpt(nvec: int) -> int:
    """Vectors per thread that give a pixel's ``nvec`` vectors two threads
    (the fastest on the card at every staged level), else the most of
    VPTS that divide ``nvec``."""
    half = nvec // 2
    if nvec % 2 == 0 and half in VPTS:
        return half
    return next(k for k in VPTS if nvec % k == 0)


def plan_shared(b: int, h: int, w: int, c: int, esize: int) -> Plan:
    """K1's plan: the direct plan below DIRECT_BELOW bytes of output;
    else 8-row tiles, 32 columns wide where the map is 256 wide or more and
    the frames' grid tile stays within GRID_TILE entries (16 otherwise),
    channel slices of at most 128 bytes per pixel (C=512 bf16 in 8
    slices), two threads per pixel and a 3 px window cap."""
    v = vec(esize)
    if c % v:
        raise ValueError(f"C={c} must be a multiple of {v}")
    if b * h * w * c * esize < DIRECT_BELOW:
        return DIRECT
    cslice = c
    if c * esize > SLICE_BYTES:
        cslice = max(k for k in range(v, SLICE_BYTES // esize + 1, v)
                     if c % k == 0)
    th = min(8, h)
    tw = min(32 if w >= 256 and b * th * 32 <= GRID_TILE else 16, w)
    spatial = math.ceil(h / th) * math.ceil(w / tw) * (c // cslice)
    # split the frames only where the tiles alone would leave SMs idle:
    # into N_SM blocks, or 2 * N_SM for a map of under N_SM / 2 tiles
    want = N_SM if spatial >= N_SM // 2 else 2 * N_SM
    plan = Plan(th, tw, cslice, _frames(b, math.ceil(want / spatial)), HALO,
                _vpt(cslice // v))
    return check(plan, b, h, w, c, esize)


def plan_rgb(b: int, h: int, w: int, c: int, esize: int) -> Plan:
    """K2's plan: all C in one block (its window holds the map contracted
    to 3 channels), 16 x 32 tiles (two pixels a thread; the window, which
    every block contracts, is then 1.75x its tile), a 3 px window cap."""
    if c % vec(esize):
        raise ValueError(f"C={c} must be a multiple of {vec(esize)}")
    th, tw = min(16, h), min(32, w)
    spatial = math.ceil(h / th) * math.ceil(w / tw)
    # split the frames only into groups of at least N_SM blocks
    plan = Plan(th, tw, c, _frames(b, N_SM // spatial), HALO, 1)
    return check(plan, b, h, w, c, esize, rgb=True)
