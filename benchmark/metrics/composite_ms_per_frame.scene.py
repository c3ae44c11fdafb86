"""Host milliseconds of the spans around each ``next()`` of
``composite_faces_stream`` a composited scene frame (image/)."""
from harness.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, ("composite",), lambda r: r.frames)
