"""The port's span recorder, and the progress-callback protocol.

Spans mark the runtime's layer boundaries (``runtime/``: a request's
root, the encoders, each sampler and decode chunk, the host wire).
Tracing is off by default; ``span`` then returns one shared no-op
context and records nothing.  ``tracing_on()`` starts recording into a
fixed-size buffer in memory (spans past its end are dropped and
counted), ``take()`` hands the recorded spans over and clears them,
``tracing_off()`` stops.  Nothing is written out and nothing
synchronizes the device: a span's times are the host's, when the work
was enqueued.

A span's start and end are nanoseconds on the clock of ``torch.profiler``'s
kineto events (the Unix clock, ``time.time_ns``), so under a profile its
times lie on the device trace's; each span also opens a
``record_function("float." + name)`` range, inside the span's own times,
so a span counts what recording it costs.  Its parent is the innermost
span open on the same thread; a span with none opens a new request id,
and every span under it shares that id.  No span stays open across a
``yield``: a generator that goes on making a request's work after its
root closed carries the id through ``resumed``.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Callable, NamedTuple, Optional

import torch

CAPACITY = 1 << 16      # spans held between two takes; later ones dropped


class Span(NamedTuple):
    id: int
    parent: Optional[int]          # the innermost span open on its thread
    request: int
    name: str
    start_ns: int                  # the profiler's clock (time.time_ns)
    end_ns: int
    attrs: dict                    # counts: frames, index, bytes


class Taken(NamedTuple):
    spans: list
    dropped: int                   # spans lost to a full buffer


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.spans: list = []
        self.dropped = 0

    def add(self, span: Span) -> None:
        with self.lock:
            if len(self.spans) < CAPACITY:
                self.spans.append(span)
            else:
                self.dropped += 1

    def take(self) -> Taken:
        with self.lock:
            out = Taken(self.spans, self.dropped)
            self.spans, self.dropped = [], 0
        return out


_recorder: Optional[_Recorder] = None      # None: tracing is off
_OFF = contextlib.nullcontext()
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()                 # .stack, .request


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span while it is open; ``request`` is its request id."""
    __slots__ = ("rec", "name", "attrs", "id", "parent", "request",
                 "range", "t0")

    def __init__(self, rec: _Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.t0 = time.time_ns()
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent = stack[-1].id
            self.request = stack[-1].request
        else:
            self.parent = None
            self.request = getattr(_local, "request", None) or next(
                _requests)
        stack.append(self)
        self.range = torch.profiler.record_function("float." + self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        _stack().pop()
        self.rec.add(Span(self.id, self.parent, self.request, self.name,
                          self.t0, time.time_ns(), self.attrs))
        return False


def span(name: str, **attrs):
    """A context that records one span named ``name`` with ``attrs`` (its
    counts) while tracing is on; a shared no-op context while it is off.
    Entered, it gives the open span (None while off)."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Open(rec, name, attrs)


def resumed(items, root):
    """Iterate ``items`` (a generator of the request whose root span is
    ``root``) so that the spans its work opens after ``root`` closed keep
    ``root``'s request id; ``items`` itself when ``root`` is None."""
    if root is None:
        return items
    return _resumed(items, root.request)


def _resumed(items, request: int):
    try:
        while True:
            saved = getattr(_local, "request", None)
            _local.request = request
            try:
                item = next(items)
            except StopIteration:
                return
            finally:
                _local.request = saved
            yield item
    finally:
        items.close()


def tracing_on() -> None:
    """Start recording spans (a fresh, empty buffer)."""
    global _recorder
    _recorder = _Recorder()


def tracing_off() -> None:
    """Stop recording; spans not taken are discarded."""
    global _recorder
    _recorder = None


def take() -> Taken:
    """The spans recorded since tracing was turned on or last taken, in
    the order they closed, with the count dropped; clears both.  Empty
    while tracing is off."""
    rec = _recorder
    return rec.take() if rec is not None else Taken([], 0)


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
