"""Milliseconds of the ``sample`` span a sampler chunk, ceil(T / 50)
chunks a request (runtime/sampling.py)."""
from harness.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, ("sample",), lambda r: r.chunks)
