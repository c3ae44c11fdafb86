"""float_torch — the FLOAT talking-portrait pipeline in PyTorch, for CUDA.

The PyTorch counterpart of ``float_tpu``, laid out module for module so
each function's twin is easy to find:

- ``ops``      primitives (upfirdn2d, modulated conv, warp, ODE, ...)
- ``kernels``  hand-written CUDA kernels for Hopper (``csrc/``), their
               build step and their ctypes wrappers
- ``models``   networks (motion-AE encoder, synthesis, wav2vec2, FMT)
               and the synthetic-weight initialiser
- ``runtime``  the pipeline stages (encode / sample / decode)

The package imports ``torch`` and never ``jax``; configuration is shared
with ``float_tpu.config``, which is free of JAX.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    CHANNELS_MAP, EMOTION_LABELS, WAV2VEC2_BASE, WAV2VEC2_LARGE_SER,
    FloatConfig, Wav2Vec2Config,
)
