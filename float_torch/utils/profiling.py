"""Step timing + progress instrumentation (twin of
``float_tpu.utils.profiling``).

Stage timers with device synchronisation, a progress-callback protocol
the runtime hooks into, and optional ``torch.profiler`` traces.  CUDA
work is asynchronous: a host clock around it measures the enqueue unless
the stage ends in a synchronize, which ``device_sync`` does.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_sync(x) -> None:
    """Wait for the work producing ``x`` (a tensor or a nested
    list/tuple/dict of them): synchronize the CUDA device it lives on; a
    CPU tensor is ready already."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@dataclass
class StageTimes:
    times: Dict[str, List[float]] = field(default_factory=dict)

    def add(self, name: str, dt: float):
        self.times.setdefault(name, []).append(dt)

    def summary(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.times.items()}

    def report(self) -> str:
        return "\n".join(f"{k}: {v*1000:.1f} ms"
                         for k, v in self.summary().items())


class Profiler:
    """Collects per-stage wall times; optionally wraps torch.profiler,
    writing a Chrome trace into ``trace_dir``."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.stages = StageTimes()
        self.trace_dir = trace_dir

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            device_sync(sync_on)
        self.stages.add(name, time.perf_counter() - t0)

    @contextlib.contextmanager
    def trace(self):
        if not self.trace_dir:
            yield
            return
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts,
                     on_trace_ready=tensorboard_trace_handler(self.trace_dir)):
            yield


class ProgressCallback:
    """Progress protocol: total units, per-unit update — the ComfyUI
    ProgressBar contract without the UI."""

    def __init__(self, total: int, on_update: Optional[Callable] = None):
        self.total = total
        self.done = 0
        self.on_update = on_update

    def update(self, n: int = 1):
        self.done += n
        if self.on_update:
            self.on_update(self.done, self.total)
