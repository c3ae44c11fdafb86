"""Extract component checkpoints from the unified FLOAT.safetensors (twin
of tools/extract_parts.py, over the port's numpy-only reader and writer):

    python -m float_torch.tools.extract_parts FLOAT.safetensors --part fmt -o fmt.safetensors
    python -m float_torch.tools.extract_parts FLOAT.safetensors --all -o models/float/
"""
from __future__ import annotations

import argparse
import os
import sys

from ..io.download import EXTRACTION_PREFIXES, extract_part

DEFAULT_NAMES = {
    "encoder": "motion_autoencoder/encoder.safetensors",
    "decoder": "motion_autoencoder/decoder.safetensors",
    "projection": "audio_projections/projection.safetensors",
    "fmt": "fmt/fmt.safetensors",
    "wav2vec2_base": "audio/wav2vec2-base-960h/model.safetensors",
    "emotion_ser": "audio/wav2vec-english-speech-emotion-recognition/model.safetensors",
}


def extract_all(unified: str, out_dir: str) -> bool:
    """Every part of ``unified`` under ``out_dir`` at its DEFAULT_NAMES
    path; False if any part is missing."""
    ok = True
    for key, rel in DEFAULT_NAMES.items():
        ok &= extract_part(unified, key, os.path.join(out_dir, rel))
    return ok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("unified", help="path to FLOAT.safetensors")
    ap.add_argument("--part", choices=sorted(EXTRACTION_PREFIXES),
                    help="single part to extract")
    ap.add_argument("--all", action="store_true", help="extract every part")
    ap.add_argument("-o", "--output", required=True,
                    help="output file (--part) or directory (--all)")
    args = ap.parse_args(argv)

    if args.all:
        sys.exit(0 if extract_all(args.unified, args.output) else 1)
    if not args.part:
        ap.error("need --part or --all")
    sys.exit(0 if extract_part(args.unified, args.part, args.output) else 1)


if __name__ == "__main__":
    main()
