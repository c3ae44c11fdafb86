"""Device mesh for several devices in one process (twin of
``float_tpu.parallel.mesh``).

- ``data`` axis: clips of a batch split across the mesh's rows
  (``FloatPipeline.generate_batch``);
- ``model`` axis: the FMT and wav2vec2 layers split across a row's
  devices (``sharding``), and, with the data axis, the frames of every
  decode chunk split across all devices (``runtime.decode.FrameParallel``).

JAX inserts the collectives from its shardings; here the tensors are
copied between devices by plain ``Tensor.to`` calls made by one host
thread.  A mesh may name one device several times (``[cpu] * 8`` in the
tests, ``[cuda:0] * 4`` on one card): every split then runs on that
device in turn, with the same arithmetic as on distinct devices.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

AXES = ("data", "model")


def _indexed(device) -> torch.device:
    """A CUDA device with its index ("cuda" -> the current card's)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A (data, model) grid of torch devices.

    ``devices[i][j]`` is the device of data row i, model rank j; a row's
    first device is where its activations live and its partial sums
    meet."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [[_indexed(d) for d in row] for row in devices]
        if not self.devices or len({len(r) for r in self.devices}) != 1 \
                or not self.devices[0]:
            raise ValueError("a mesh is a non-empty rectangle of devices")
        self.axis_names = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self) -> List[torch.device]:
        """Every device in row-major order (a frame split's order)."""
        return [d for row in self.devices for d in row]

    @property
    def primary(self) -> torch.device:
        """Row 0's first device: where results are gathered."""
        return self.devices[0][0]


def _all_cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh takes every CUDA device unless given "
                           "devices=, and none is available")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: Optional[int] = None, devices=None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` of ``devices``
    (default: every CUDA device).  With neither axis given the model axis
    is 4, else 2, else 1, whichever divides the count; one axis given, the
    other is the quotient.  Raises ValueError when data x model != n.
    ``devices`` may repeat a device; it is never repeated unless asked."""
    devs = [torch.device(d) for d in
            (devices if devices is not None else _all_cuda_devices())]
    n = n_devices or len(devs)
    devs = devs[:n]
    if data is None and model is None:
        model = next((m for m in (4, 2) if n % m == 0), 1)
        data = n // model
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n or len(devs) != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices "
                         f"({len(devs)} given)")
    return Mesh([devs[i * model:(i + 1) * model] for i in range(data)])


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """"data=D,model=M" (either axis optional) -> make_mesh keywords."""
    axes = {}
    for kv in spec.split(","):
        key, _, val = kv.partition("=")
        if key.strip() not in AXES or not val.strip().isdigit():
            raise ValueError(f"mesh spec {spec!r}: expected data=D,model=M")
        axes[key.strip()] = int(val)
    return axes


def replicate(x: torch.Tensor, devices: Sequence[torch.device]) -> list:
    """A copy of ``x`` on every device (``replicated``); a device that
    appears twice, or is x's own, shares one tensor."""
    copies = {}
    return [copies.setdefault(d, x.to(d)) for d in devices]


def batch_split(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> list:
    """``x`` split evenly along ``dim`` over the data axis, piece i on data
    row i's first device (``batch_sharding``).  Raises unless it divides."""
    d = mesh.shape["data"]
    if x.shape[dim] % d:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {d} data rows")
    return [piece.to(row[0]) for piece, row in
            zip(x.chunk(d, dim), mesh.devices)]


def gather(pieces, device: torch.device, dim: int = 0):
    """The inverse of a split: matching tensors (or tuples and lists of
    them) concatenated along ``dim`` on ``device``."""
    first = pieces[0]
    if isinstance(first, (tuple, list)):
        return type(first)(gather([p[k] for p in pieces], device, dim)
                           for k in range(len(first)))
    return torch.cat([p.to(device) for p in pieces], dim)
