"""Everything a run makes from its ``--seed``: the weights, on the device
in a few large draws, and each request's inputs.

The weights follow the layout and the per-leaf scales of
``float_torch.models.init.init_pipeline``; its ``mk`` argument takes the
leaf maker here, which hands out slices of one N(0, 1) draw a parameter
group (encoder, synthesis, wav2vec2, projection, SER, FMT), made by a
``torch.Generator`` on the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for ``path`` under the run's ``seed`` (any integer)."""
    words = np.random.SeedSequence([seed % 2 ** 64, *path]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) % 2 ** 63


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def weight_tree(init_pipeline, cfgs, seed: int, device) -> dict:
    """The whole pipeline's weights as a nested dict of float32 tensors on
    ``device``: ``init_pipeline(*cfgs, mk=...)`` run twice, once to count
    each group's elements and once to hand out slices of one draw a
    group, each scaled as that init function scales it."""
    counts: list = []

    class Count:
        def __init__(self, _seed, scale=0.05):
            counts.append(0)
            self.k = len(counts) - 1

        def t(self, *shape, scale=None):
            counts[self.k] += math.prod(shape)

        def zeros(self, *shape):
            return None

        ones = zeros

    init_pipeline(*cfgs, seed=0, mk=Count)
    draws = [torch.randn(n, generator=_generator(sub_seed(seed, 1, k),
                                                 device), device=device)
             for k, n in enumerate(counts)]
    made = iter(range(len(draws)))

    class Draw:
        def __init__(self, _seed, scale=0.05):
            self.buf = draws[next(made)]
            self.off = 0
            self.scale = scale

        def t(self, *shape, scale=None):
            n = math.prod(shape)
            leaf = self.buf[self.off:self.off + n].view(shape)
            self.off += n
            return leaf.mul_(self.scale if scale is None else scale)

        def zeros(self, *shape):
            return torch.zeros(shape, device=device)

        def ones(self, *shape):
            return torch.ones(shape, device=device)

    return init_pipeline(*cfgs, seed=0, mk=Draw)


def portrait(seed: int, size: int, device) -> torch.Tensor:
    """(1, 3, S, S) in [-1, 1]: smooth colour fields plus fine noise."""
    g = _generator(seed, device)
    low = torch.randn((1, 3, max(size // 32, 2), max(size // 32, 2)),
                      generator=g, device=device)
    img = F.interpolate(low, size=(size, size), mode="bicubic",
                        align_corners=False) * 0.5
    img = img + 0.05 * torch.randn((1, 3, size, size), generator=g,
                                   device=device)
    return img.clamp(-1.0, 1.0)


def wave(seed: int, n_samples: int, device) -> torch.Tensor:
    """(1, N) noise of speech level, its loudness varying by syllable."""
    g = _generator(seed, device)
    x = 0.1 * torch.randn((1, n_samples), generator=g, device=device)
    env = torch.rand((1, 1, max(n_samples // 4000, 2)), generator=g,
                     device=device)
    env = F.interpolate(env, size=n_samples, mode="linear",
                        align_corners=True)[:, 0]
    return x * (0.25 + env)


def scene(seed: int, height: int, width: int) -> np.ndarray:
    """(H, W, 3) uint8 scene on the host, uniform noise."""
    rng = np.random.default_rng(seed)
    return (rng.random((height, width, 3)) * 255).astype(np.uint8)
