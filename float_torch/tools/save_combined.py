"""Build the unified FLOAT.safetensors from split component checkpoints
(twin of tools/save_combined.py, over the port's numpy-only reader and
writer): prefixes each part's keys with its unified-checkpoint namespace
and writes one file.

    python -m float_torch.tools.save_combined -o FLOAT.safetensors \\
        --encoder encoder.safetensors --decoder decoder.safetensors \\
        --projection projection.safetensors --fmt fmt.safetensors \\
        --wav2vec2 wav2vec_dir_or_file --emotion ser_dir_or_file
"""
from __future__ import annotations

import argparse
import os

from ..io.checkpoint import load_safetensors, load_torch_pth, save_safetensors
from ..io.download import EXTRACTION_PREFIXES
from ..io.hf import load_state_dict_file

ARGS_TO_KEYS = {
    "encoder": "encoder", "decoder": "decoder", "projection": "projection",
    "fmt": "fmt", "wav2vec2": "wav2vec2_base", "emotion": "emotion_ser",
}


def load_any(path: str) -> dict:
    """An HF folder, a torch .bin/.pth file or a safetensors file -> a flat
    {key: numpy array}."""
    if os.path.isdir(path):
        return load_state_dict_file(path)
    if path.endswith(".bin") or path.endswith(".pth"):
        return load_torch_pth(path)
    return load_safetensors(path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--output", required=True)
    for name in ARGS_TO_KEYS:
        ap.add_argument(f"--{name}")
    args = ap.parse_args(argv)

    combined = {}
    for arg_name, part_key in ARGS_TO_KEYS.items():
        path = getattr(args, arg_name)
        if not path:
            continue
        prefix = EXTRACTION_PREFIXES[part_key]
        flat = load_any(path)
        for k, v in flat.items():
            combined[f"{prefix}.{k}"] = v
        print(f"{arg_name}: {len(flat)} tensors under {prefix}.*")

    if not combined:
        ap.error("no parts given")
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    save_safetensors(combined, args.output)
    print(f"wrote {len(combined)} tensors -> {args.output}")


if __name__ == "__main__":
    main()
