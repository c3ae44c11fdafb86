"""What the sampler's and the decode's CUDA graphs share: one capture
stream a device, and a cache of graphs that goes with the weights they
read.

Each graph reads its weights in place, so a cache is held by the weights'
``ParamTree`` (``chunk_graphs`` on the FMT, ``decode_graphs`` on the
synthesis) and forgets its graphs when the weights move to new storage.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import torch

_NEW = threading.Lock()             # makes caches and capture streams
_CAPTURE_STREAMS: dict = {}         # device -> (its captures' stream, lock)


def capture_stream(device):
    """The side stream every graph of ``device`` is warmed up and captured
    on, one a device so that cuBLAS keeps one workspace for them (it keeps
    one a stream) however many graphs are made, and the lock that keeps
    two captures off it at once."""
    with _NEW:
        if device not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[device] = (torch.cuda.Stream(device),
                                        threading.Lock())
        return _CAPTURE_STREAMS[device]


def cache_on(tree, attr: str, make):
    """``tree``'s cache ``attr``, made by ``make()`` at its first use."""
    with _NEW:
        if getattr(tree, attr) is None:
            setattr(tree, attr, make())
    return getattr(tree, attr)


def storage(params) -> tuple:
    """Where ``params``' weights are: what a graph reads in place."""
    return tuple(p.data_ptr() for p in params.parameters())


class GraphCache:
    """Graphs by key: the ``size`` keys used last.  ``lock`` covers one
    graph's copy-in, replay and copy-out: a graph's static buffers are
    shared by every caller."""

    def __init__(self, size: int):
        self.size = size
        self.lock = threading.Lock()
        self.graphs: OrderedDict = OrderedDict()
        self.weights: tuple = ()        # the storage the graphs read

    def fresh(self, weights: tuple) -> None:
        """Drop every graph if the weights are no longer in ``weights``'s
        storage (called under ``lock``)."""
        if weights != self.weights:
            self.graphs.clear()
            self.weights = weights

    def get(self, key, make):
        """The graph of ``key``, made by ``make()`` where there is none;
        the least recently used beyond ``size`` are dropped."""
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = make()
            while len(self.graphs) > self.size:
                self.graphs.popitem(last=False)
        else:
            self.graphs.move_to_end(key)
        return graph
