"""What the traffic kinds that send clips of one portrait and one wave
share: a request's inputs, made on the device from its seed, its frame
count, and the reference's frames of it."""
from __future__ import annotations

import math

from . import reference, seeded


def audio_frames(run, n_samples: int) -> int:
    f = run.model["float"]
    return math.ceil(n_samples * f["fps"] / f["sampling_rate"])


def inputs(run, params):
    """(portrait, wave, sampler seed) of a request, made on the device."""
    s = params["seed"]
    size = run.model["float"]["input_size"]
    return (seeded.portrait(seeded.sub_seed(s, 0), size, run.device),
            seeded.wave(seeded.sub_seed(s, 1), params["samples"], run.device),
            seeded.sub_seed(s, 2))


def expected(run, req, prec):
    """The reference's frames of the request, at ``prec``."""
    img, wave, seed = inputs(run, req.params)
    return reference.generate(run.ref_params(), img, wave, seed, run.model,
                              prec)[1]
