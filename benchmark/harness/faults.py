"""Faults planted in the program under test, to show that the comparison
that decides ``correct`` catches them: each takes a ``setattr`` (a test's
``monkeypatch.setattr``) and breaks the timed path underneath.  One card
a cell, so no exchange between chips is left out."""
from __future__ import annotations

import torch


def state_unchanged(setattr_):
    """Each Euler step of the sampler returns its state unchanged."""
    import float_torch.ops.ode as ode
    setattr_(ode, "_rk_step", lambda f, t0, dt, y0, method: y0)


def half_left_out(setattr_):
    """Each decode chunk computes half of its frames; the other half
    repeats them."""
    import float_torch.runtime.decode as dec
    real = dec.decode_chunk

    def half(params, wa, feats, size, **kw):
        n = wa.shape[0]
        out = real(params, wa[:max(1, n // 2)], feats, size, **kw)
        return out[torch.arange(n, device=out.device) % out.shape[0]]
    setattr_(dec, "decode_chunk", half)


def frame_altered(setattr_):
    """The first frame of each decode chunk halved where it is made."""
    import float_torch.runtime.decode as dec
    real = dec.decode_chunk

    def altered(params, wa, feats, size, **kw):
        out = real(params, wa, feats, size, **kw).clone()
        out[0] = out[0] // 2 if out.dtype == torch.uint8 else out[0] * 0.5
        return out
    setattr_(dec, "decode_chunk", altered)


def scene_altered(setattr_):
    """One composited scene frame halved where it is made."""
    import float_torch.image.composite as comp
    real = comp.composite_faces_stream

    def altered(*a, **kw):
        for i, fr in enumerate(real(*a, **kw)):
            yield fr // 2 if i == 3 else fr
    setattr_(comp, "composite_faces_stream", altered)


FAULTS = {f.__name__: f for f in (state_unchanged, half_left_out,
                                  frame_altered, scene_altered)}
# the faults each traffic kind's path can have
BY_KIND = {"clip": ("state_unchanged", "half_left_out", "frame_altered"),
           "stream": ("state_unchanged", "half_left_out", "frame_altered"),
           "scene": ("state_unchanged", "half_left_out", "frame_altered",
                     "scene_altered")}
