"""The whole clip's share of the H100's dense bf16 peak: the frozen count
of its matrix FLOPs (decode and sampler, harness/yardstick.py) over the
seconds of the traced run's stage-by-stage clips, in per cent."""
from harness import yardstick
from harness.readers import span_seconds


def read(run):
    if run.device.type != "cuda":
        return None
    staged = span_seconds(run, "decode")
    clips = [r for r in run.requests if r.index in staged]
    if not clips:
        return None
    flops = sum(yardstick.clip_matmul_flops(r.frames, run.model["float"])
                for r in clips)
    secs = sum(r.t1 - r.t0 for r in clips)
    return 100.0 * flops / secs / yardstick.BF16_PEAK_FLOPS
