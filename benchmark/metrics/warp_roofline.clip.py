"""K1 (``warp_shared``) as a share of its roofline in the profiled
stretch: the frozen bytes bound of its launches, counted from their
shapes (``float_torch.kernels.LAUNCH_SHAPES``), over its device time by
kernel name, in per cent."""
import re

from harness import yardstick

# K1's two forms in kernels/csrc/warp_shared.cu: the staged kernel, and
# the gather kernel on one shared map (its per-frame form is K3)
K1 = re.compile(r"\bstaged_kernel<|\bgather_kernel<[^,]*,\s*false")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    esize = 2 if run.model["float"]["compute_dtype"] == "bfloat16" else 4
    bound = sum(n * yardstick.warp_shared_bound_s(b, h, w, c, esize)
                for (name, b, h, w, c), n in tr["launch_shapes"].items()
                if name == "warp_shared")
    took = sum(s for name, s in tr["kernel_s"].items() if K1.search(name))
    if not bound or not took:
        return None
    return 100.0 * bound / took
