"""float_torch — the FLOAT talking-portrait pipeline in PyTorch, for CUDA.

The PyTorch counterpart of ``float_tpu``, laid out module for module so
each function's twin is easy to find:

- ``config``   the pipeline's configuration dataclasses and constants
- ``ops``      primitives (upfirdn2d, modulated conv, warps, ODE, 4:2:0
               wire codec, ...)
- ``kernels``  hand-written CUDA kernels for Hopper (``csrc/``), their
               build step and their ctypes wrappers
- ``models``   networks (motion-AE encoder, synthesis, wav2vec2, FMT)
               and the synthetic-weight initialiser
- ``runtime``  the pipeline stages (encode / sample / decode) and the
               host-delivery entry points (decode to host, streaming,
               batches of clips)
- ``io``, ``image``, ``audio``, ``api``  checkpoints, host media and the
               ComfyUI node surface
- ``utils``    FLOP and parameter counts, stage timing, logging
- ``serve``, ``client``, ``cli``  the HTTP daemon, its client and the
               command line (``python -m float_torch.cli``)

The package imports ``torch`` and never ``jax`` nor ``float_tpu``.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    CHANNELS_MAP, EMOTION_LABELS, WAV2VEC2_BASE, WAV2VEC2_LARGE_SER,
    FloatConfig, Wav2Vec2Config,
)
