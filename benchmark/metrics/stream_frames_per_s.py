"""stream_frames_per_s: frames of every stream started in the window,
delivered to the host, over the seconds from the window's start to the
last chunk of the last of them; the stream's own name, so its host's
spread cannot widen the clips' bound."""
from harness.readers import rate


def read(run):
    return rate(run)
