"""K8 (``flow_merge``) as a share of its roofline in the profiled
stretch: the frozen bytes bound of its launches, counted from their
shapes (``float_torch.kernels.LAUNCH_SHAPES``), over its device time by
kernel name, in per cent.  None on a program without K8."""
import re

from harness import yardstick

# K8's kernel in kernels/csrc/flow_merge.cu, both of its forms
K8 = re.compile(r"\bflow_merge_kernel<")
# launch names: a merge with the next conv's modulation, the last level's
MERGED = {"flow_merge": True, "flow_merge_last": False}
OPS_PER_PIXEL = 4          # the mask's sigmoid
OPS_PER_ELEMENT = {True: 5, False: 1}


def merge_bytes(merged: bool, b: int, h: int, w: int, c: int,
                esize: int) -> float:
    """One K8 launch's bytes, each needed byte once: a merge reads warped
    and x and writes the warped feature and the merged map (four maps),
    the last level reads warped and writes the warped feature (two); both
    read the mask channel, a merge the (B, C) scale too."""
    px = b * h * w
    return ((4 if merged else 2) * px * c + px
            + (b * c if merged else 0)) * esize


def read(run):
    tr = run.trace
    if tr is None:
        return None
    esize = 2 if run.model["float"]["compute_dtype"] == "bfloat16" else 4
    bound = 0.0
    for (name, b, h, w, c), n in tr["launch_shapes"].items():
        if name in MERGED:
            merged = MERGED[name]
            ops = b * h * w * (c * OPS_PER_ELEMENT[merged] + OPS_PER_PIXEL)
            bound += n * yardstick.bound_s(
                merge_bytes(merged, b, h, w, c, esize), ops)
    took = sum(s for name, s in tr["kernel_s"].items() if K8.search(name))
    if not bound or not took:
        return None
    return 100.0 * bound / took
