"""Checkpoint readiness gate (twin of tools/readiness_check.py): one
command that, given weights, says the port is ready to serve them.

  1. load    the checkpoint loads through every storage layout the port
             reads: the unified FLOAT.safetensors and, given ``--parts``
             (a directory written by ``extract_parts --all``), its part
             files and, where its two audio folders hold a config.json,
             those folders read as HF folders; the parameter count of
             each part is printed, and every layout must hold the unified
             file's tensors;
  2. parity  per-stage parity against activations recorded from
             ``float_tpu`` (``parity_check.run_parity``, in this process)
             when ``--activations`` is given.

The reference's flow-probe and warp-profile gates are not ported: they
tune the TPU decode's displacement ratchet (the static D of its warp
kernels), which the port does not have; its Hopper warp kernels are exact
for any flow.

    python -m float_torch.tools.readiness_check --checkpoint FLOAT.safetensors \\
        [--parts DIR] [--activations tests/fixtures/float_tpu_config1_f32.npz] \\
        [--device cpu]

Prints READY and exits 0 when every gate passes; otherwise exits non-zero
naming the gate.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..io.checkpoint import (UNIFIED_PREFIXES, load_safetensors,
                             params_from_parts, split_unified)
from ..io.hf import load_wav2vec2_dir
from .extract_parts import DEFAULT_NAMES

LAYOUTS = ("unified", "parts", "hf")
# extract_parts' part names -> the components of split_unified
PART_COMPONENTS = {"encoder": "encoder", "decoder": "synthesis",
                   "projection": "audio_projection", "fmt": "fmt",
                   "wav2vec2_base": "wav2vec2", "emotion_ser": "emotion"}
# the two audio towers, which HF folders can also hold
HF_PARTS = {"wav2vec2_base": "wav2vec2", "emotion_ser": "emotion"}
REQUIRED = ("encoder", "synthesis", "audio_encoder", "emotion", "fmt")


def hf_folder(parts_dir: str, part: str) -> str:
    return os.path.join(parts_dir, os.path.dirname(DEFAULT_NAMES[part]))


def has_hf_folders(parts_dir: str) -> bool:
    return all(os.path.exists(os.path.join(hf_folder(parts_dir, p),
                                           "config.json")) for p in HF_PARTS)


def _flat_parts(path: str, layout: str) -> dict:
    """{component: flat dict} of one layout, keyed as split_unified keys
    them."""
    if layout == "unified":
        return split_unified(load_safetensors(path))
    files = {PART_COMPONENTS[p]: os.path.join(path, rel)
             for p, rel in DEFAULT_NAMES.items()}
    return {comp: load_safetensors(files[comp]) for comp in UNIFIED_PREFIXES}


def gate_load(path: str, layout: str = "unified"):
    """Load one storage layout: a unified file, or a directory of
    ``extract_parts --all`` read as part files ("parts") or with its audio
    towers read as HF folders ("hf").  Prints the tensor and parameter
    counts per part; returns (params, {component: parameters in the
    file})."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    flat_parts = _flat_parts(path, layout)
    n_tensors = sum(len(p) for p in flat_parts.values())
    counts = {name: sum(v.size for v in part.values())
              for name, part in flat_parts.items()}
    print(f"[load] {path} ({layout}): {n_tensors} tensors, "
          f"{sum(counts.values()) / 1e6:.1f} M params")
    for name, n in counts.items():
        if n:
            print(f"[load]   {name}: {n / 1e6:.1f} M")
    params = params_from_parts(flat_parts)
    if layout == "hf":
        for part, comp in HF_PARTS.items():
            tree, cfg, _labels = load_wav2vec2_dir(hf_folder(path, part))
            print(f"[load]   {comp} from the HF folder "
                  f"{hf_folder(path, part)}: {cfg.num_hidden_layers} x "
                  f"{cfg.hidden_size}")
            if comp == "wav2vec2":
                params["audio_encoder"]["wav2vec2"] = tree
            else:
                params["emotion"] = tree
    missing = [k for k in REQUIRED if not params.get(k)]
    if missing:
        raise SystemExit(f"[load] FAIL: missing parts {missing}")
    print("[load] ok")
    return params, counts


def same_params(a: dict, b: dict) -> bool:
    """Two params trees hold the same keys and equal arrays."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys()
                and all(same_params(a[k], b[k]) for k in a))
    return np.array_equal(np.asarray(a), np.asarray(b))


def gate_layouts(params: dict, parts_dir: str) -> None:
    """The part files (and the HF folders where the audio folders hold a
    config.json) of ``parts_dir`` must load to ``params``, tensor for
    tensor."""
    layouts = ["parts"]
    if has_hf_folders(parts_dir):
        layouts.append("hf")
    else:
        print(f"[load] hf: no config.json in the audio folders of "
              f"{parts_dir}; read as part files only")
    for layout in layouts:
        got, _counts = gate_load(parts_dir, layout)
        if not same_params(got, params):
            raise SystemExit(f"[load] FAIL: the {layout} layout of "
                             f"{parts_dir} differs from the unified file")
        print(f"[load] {layout}: every tensor equal to the unified file's")


def gate_parity(activations: str, pipe) -> list:
    """``parity_check.run_parity`` on ``pipe``, a float32 pipeline
    (``parity_check.float32_pipeline``); returns its StageResults."""
    from .parity_check import FixtureMismatch, load_activations, run_parity
    print(f"[parity] {activations} on {pipe.device}")
    try:
        results = run_parity(pipe, load_activations(activations))
    except FixtureMismatch as exc:
        raise SystemExit(f"[parity] FAIL: {exc}")
    if not all(r.ok for r in results):
        raise SystemExit("[parity] FAIL (see above)")
    print("[parity] ok")
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--checkpoint", required=True,
                    help="the unified FLOAT.safetensors")
    ap.add_argument("--parts", default=None,
                    help="a directory written by extract_parts --all from "
                         "the same checkpoint (with config.json in its audio "
                         "folders, also read as HF folders)")
    ap.add_argument("--activations", default=None,
                    help=".npz recorded from float_tpu; enables the "
                         "per-stage parity gate")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the parity gate (default cuda)")
    args = ap.parse_args(argv)

    params, _counts = gate_load(args.checkpoint)
    if args.parts:
        gate_layouts(params, args.parts)
    else:
        print("[load] part files and HF folders: skipped (no --parts)")
    if args.activations:
        from .parity_check import float32_pipeline
        gate_parity(args.activations, float32_pipeline(params, args.device))
    else:
        print("[parity] skipped (no --activations)")
    print("[probe] not ported: the flow probe and the warp profile tune the "
          "TPU decode's displacement ratchet, which the port's exact warp "
          "kernels do not need")
    print("READY")


if __name__ == "__main__":
    main()
