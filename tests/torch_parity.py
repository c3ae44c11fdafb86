"""Shared pieces of the float_torch parity tests: the tiny configs of
tests/test_pipeline.py, seeded inputs, and carrying float_tpu params into
the port's modules."""
import jax
import numpy as np
import torch

from float_tpu.config import FloatConfig, Wav2Vec2Config
from float_torch.models.init import ParamTree, params_to_state_dict

TINY_W2V = Wav2Vec2Config(
    conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, feat_extract_norm="group",
    conv_bias=False, do_stable_layer_norm=False)

TINY_SER = Wav2Vec2Config(
    conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, feat_extract_norm="layer",
    conv_bias=True, do_stable_layer_norm=True, num_labels=7)

TINY = FloatConfig(input_size=64, dim_w=64, dim_a=64, dim_h=64, dim_m=20,
                   dim_e=7, fmt_depth=2, num_heads=4, wav2vec_sec=0.4,
                   num_prev_frames=3, decode_batch=4, compute_dtype="float32")


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def port_params(jax_tree) -> ParamTree:
    """The port's module for a float_tpu params tree, its weights loaded
    through params_to_state_dict with load_state_dict(strict=True)."""
    mod = ParamTree(jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                                 jax_tree))
    mod.load_state_dict(params_to_state_dict(jax_tree), strict=True)
    return mod


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def max_err(a, b) -> float:
    return float(np.max(np.abs(np32(a) - np32(b))))
