"""frames_per_s: frames of every request started in the window over the
seconds from the window's start to the end of the last of them."""
from harness.readers import rate


def read(run):
    return rate(run)
