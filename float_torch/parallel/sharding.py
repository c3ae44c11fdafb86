"""Tensor-parallel split of the FMT and wav2vec2 layers over a mesh row
(twin of ``float_tpu.parallel.sharding``: the same Megatron rules).

torch weight layout (out, in):

- FMT ``attn.qkv`` (3H, H): split by heads, ``attn.proj`` (H, H): by input;
  ``mlp.fc1`` (4H, H): by output, ``mlp.fc2`` (H, 4H): by input;
- wav2vec2 ``q_proj``/``k_proj``/``v_proj``: by heads, ``out_proj``: by
  input; ``intermediate_dense``: by output, ``output_dense``: by input;
- everything else replicated.

Model rank r of a row holds its slices on its own device
(``ParamTree.tp_shards`` of the attention or MLP node: one dict a rank,
its ``device`` beside the sliced weights).  The model functions
(``models.fmt._attention``/``_mlp``, ``models.wav2vec2._attention``/
``_feed_forward``) run each rank's part on its device and sum the
row-parallel outputs onto the row's first device (``row_parallel``).

``qkv.weight`` stacks q, k and v: rank r takes head group r of each of the
three, not a contiguous third of the rows.  A layer whose heads or hidden
width do not divide by the model axis stays replicated, with the same
results, just not split (GSPMD would pad it).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def _rows(w: torch.Tensor, m: int, r: int, parts: int = 1) -> torch.Tensor:
    """Rank r's share of the rows of each of ``parts`` stacked blocks."""
    blocks = w.chunk(parts, 0)
    return torch.cat([b.chunk(m, 0)[r] for b in blocks]).contiguous()


def _cols(w: torch.Tensor, m: int, r: int) -> torch.Tensor:
    return w.chunk(m, 1)[r].contiguous()


def _column(p, m: int, r: int, device, parts: int = 1) -> dict:
    """A column-parallel linear's slice: output rows (weight and bias)."""
    return {"weight": _rows(p["weight"], m, r, parts).to(device),
            "bias": _rows(p["bias"], m, r, parts).to(device)}


def _row(p, m: int, r: int, device) -> dict:
    """A row-parallel linear's slice: input columns, no bias (it is added
    once, after the sum)."""
    return {"weight": _cols(p["weight"], m, r).to(device)}


def _split(node, devices: Sequence[torch.device], width: int,
           make: Callable[[int, torch.device], dict]) -> bool:
    """Set ``node.tp_shards`` to one slice a rank when ``width`` divides by
    the rank count; leave the node whole otherwise."""
    m = len(devices)
    if m == 1 or width % m:
        return False
    node.tp_shards = [dict(make(r, d), device=d)
                      for r, d in enumerate(devices)]
    return True


def shard_fmt(fmt, devices: Sequence[torch.device], num_heads: int) -> int:
    """Split every FMT block's attention (by heads) and MLP (by hidden
    width) over ``devices``, a mesh row; returns the layers split."""
    n = 0
    for blk in fmt["blocks"].children():
        attn, mlp = blk["attn"], blk["mlp"]
        n += _split(attn, devices, num_heads, lambda r, d: {
            "qkv": _column(attn["qkv"], len(devices), r, d, parts=3),
            "proj": _row(attn["proj"], len(devices), r, d)})
        n += _split(mlp, devices, mlp["fc1"]["weight"].shape[0],
                    lambda r, d: {
                        "fc1": _column(mlp["fc1"], len(devices), r, d),
                        "fc2": _row(mlp["fc2"], len(devices), r, d)})
    return n


def shard_wav2vec2(w2v, devices: Sequence[torch.device],
                   num_heads: int) -> int:
    """Split every wav2vec2 encoder layer's attention (by heads) and feed
    forward (by intermediate width) over ``devices``; returns the layers
    split."""
    n, m = 0, len(devices)
    for layer in w2v["encoder"]["layers"].children():
        att, ff = layer["attention"], layer["feed_forward"]
        n += _split(att, devices, num_heads, lambda r, d: {
            **{k: _column(att[k], m, r, d)
               for k in ("q_proj", "k_proj", "v_proj")},
            "out_proj": _row(att["out_proj"], m, r, d)})
        n += _split(ff, devices, ff["intermediate_dense"]["weight"].shape[0],
                    lambda r, d: {
                        "intermediate_dense": _column(
                            ff["intermediate_dense"], m, r, d),
                        "output_dense": _row(ff["output_dense"], m, r, d)})
    return n


def row_parallel(shards, x: torch.Tensor, part: Callable,
                 bias) -> torch.Tensor:
    """sum over ranks of ``part(shard, x on the rank's device)``, each
    partial copied to x's device and added in rank order, plus ``bias``
    once: a row-parallel layer's all-reduce onto the row's first device."""
    out = None
    for s in shards:
        y = part(s, x.to(s["device"])).to(x.device)
        out = y if out is None else out + y
    return out + bias.to(x.dtype)
