"""``torch.profiler`` over a stretch of a traced run, reduced to what the
per-layer metrics and the result line read: the device's busy seconds (the
union of its operations' intervals) against the stretch's wall seconds,
device seconds by kernel name, the longest idle gaps labelled by the
innermost host operation open across each, and the program's kernel
launches by shape (``float_torch.kernels.LAUNCH_SHAPES``) over the
stretch.
"""
from __future__ import annotations

import time
from collections import Counter, defaultdict

import torch


WINDOW = "benchmark.window"     # the host range around the profiled stretch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Profiled:
    """Profile from ``start()`` to ``stop()``; ``stop`` returns the
    reduction (see ``reduce``)."""

    def __init__(self, device, launch_shapes: Counter):
        self.device = device
        self.shapes = launch_shapes
        self.prof = None

    def start(self) -> None:
        _sync(self.device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(WINDOW)
        self.mark.__enter__()
        self.shapes0 = Counter(self.shapes)
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        _sync(self.device)
        window = time.perf_counter() - self.t0
        launches = Counter(self.shapes)
        launches.subtract(self.shapes0)
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        out = reduce(_raw(self.prof), window)
        out["launch_shapes"] = {k: v for k, v in launches.items() if v > 0}
        self.prof = None
        return out


def short(name: str, width: int = 160) -> str:
    """A kernel's name without its trailing argument list, at most
    ``width`` characters."""
    if name.endswith(")"):
        depth = 0
        for k in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                name = name[:k]
                break
    return name[:width]


def _raw(prof) -> list:
    """(start, end, name, on the device) of every profiled event, times
    in microseconds, read from the profiler's raw results (building its
    event tree takes tens of seconds for a clip)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        on_device = getattr(ev.device_type(), "name",
                            str(ev.device_type())) != "CPU"
        if on_device and getattr(ev, "is_user_annotation", bool)():
            continue           # a host range's shadow on the device
        lo = ev.start_ns() * 1e-3
        out.append((lo, lo + ev.duration_ns() * 1e-3, ev.name(), on_device))
    return out


def _union(intervals) -> list:
    merged: list = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def reduce(events, window_s: float, top: int = 10) -> dict:
    """busy_s, window_s, kernel_s {name: s}, device_ops and idle_gaps
    (the ``top`` largest, [name, s]) of events (start, end, name, on the
    device), times in microseconds."""
    dev, host = [], []
    for lo, hi, name, on_device in events:
        if hi > lo and not (on_device and name == WINDOW):
            (dev if on_device else host).append((lo, hi, name))
    by_name: dict = defaultdict(float)
    for lo, hi, name in dev:
        by_name[name] += (hi - lo) * 1e-6
    merged = _union((lo, hi) for lo, hi, _ in dev)
    busy = sum(hi - lo for lo, hi in merged) * 1e-6
    # the idle stretches between device operations, and before the first
    # and after the last where the stretch's host range is known
    edges = [hi for _lo, hi in merged]
    starts = [lo for lo, _hi in merged]
    window = [(lo, hi) for lo, hi, n in host if n == WINDOW]
    if window and merged:
        edges = [window[0][0]] + edges
        starts = starts + [window[0][1]]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges, starts) if b > a),
                  reverse=True)[:top]
    idle = []
    for length, lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        open_ = [(h - lo_, n) for lo_, h, n in host
                 if lo_ <= mid <= h and n != WINDOW]
        idle.append([short(min(open_)[1]) if open_ else "(no host operation)",
                     length * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ops = [(short(n), s) for n, s in ops]
    return {"busy_s": busy, "window_s": window_s, "kernel_s": dict(by_name),
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}
