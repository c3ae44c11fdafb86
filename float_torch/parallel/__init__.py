"""Several devices in one process (twin of ``float_tpu.parallel``).

- ``mesh``      a (data, model) grid of torch devices, ``make_mesh``, and
                the copies and splits that stand for JAX's replicated and
                batch shardings
- ``sharding``  the tensor-parallel split of the FMT and wav2vec2 layers
                over the model axis

One host thread drives every device, as JAX's single controller does:
there is no ``torch.distributed`` process group and no worker process.
"""
from .mesh import (Mesh, batch_split, gather, make_mesh, parse_mesh_spec,
                   replicate)
from .sharding import shard_fmt, shard_wav2vec2

__all__ = ["Mesh", "make_mesh", "parse_mesh_spec", "replicate",
           "batch_split", "gather", "shard_fmt", "shard_wav2vec2"]
