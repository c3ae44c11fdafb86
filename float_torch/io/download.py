"""Model store management: download + unified->part extraction (twin of
``float_tpu.io.download``).

Parity with the reference's L5 layer (utils/downloader.py, SURVEY §2.11):
- same part URL table and extraction-prefix table,
- ``ensure_model_part_exists``: prefer extraction from the local unified
  checkpoint, fall back to direct download,
- gated gracefully when the environment has no network egress.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger("float_torch.download")

BASE_FLOAT = "https://huggingface.co/set-soft/float_advanced/resolve/main/"
FLOAT_URL = ("https://huggingface.co/set-soft/float/resolve/main/"
             "FLOAT.safetensors?download=true")
FLOAT_UNIFIED_MODEL = "FLOAT.safetensors"

MODEL_PART_URLS = {
    "encoder": BASE_FLOAT + "motion_autoencoder/encoder.safetensors",
    "decoder": BASE_FLOAT + "motion_autoencoder/decoder.safetensors",
    "projection": BASE_FLOAT + "audio_projections/projection.safetensors",
    "fmt": BASE_FLOAT + "fmt/fmt.safetensors?download=true",
    "wav2vec2_base": ("https://huggingface.co/facebook/wav2vec2-base-960h/"
                      "resolve/main/model.safetensors"),
    "emotion_ser": ("https://huggingface.co/r-f/"
                    "wav2vec-english-speech-emotion-recognition/resolve/main/"
                    "pytorch_model.bin"),
}

# prefixes within the unified checkpoint (reference: utils/downloader.py:34-42)
EXTRACTION_PREFIXES = {
    "encoder": "motion_autoencoder.enc",
    "decoder": "motion_autoencoder.dec",
    "projection": "audio_encoder.audio_projection",
    "fmt": "fmt",
    "wav2vec2_base": "audio_encoder.wav2vec2",
    "emotion_ser": "emotion_encoder.wav2vec2_for_emotion",
}


def download_file(url: str, dest: str, timeout: float = 60.0) -> bool:
    """Best-effort HTTP download; returns False when offline/unavailable."""
    import urllib.request
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    tmp = dest + ".part"
    try:
        logger.info("downloading %s -> %s", url, dest)
        with urllib.request.urlopen(url, timeout=timeout) as r, \
                open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
        os.replace(tmp, dest)
        return True
    except Exception as exc:
        logger.warning("download failed (%s): %s", url, exc)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def extract_part(unified_path: str, part_key: str, dest: str) -> bool:
    """Extract one component from the unified checkpoint into its own
    safetensors file (equivalent of the tools/extract_* scripts), with
    the port's own numpy-only reader and writer."""
    from .checkpoint import load_safetensors, save_safetensors, subtree
    prefix = EXTRACTION_PREFIXES[part_key]
    flat = load_safetensors(unified_path)
    part = subtree(flat, prefix)
    if not part:
        logger.warning("no keys under %r in %s", prefix, unified_path)
        return False
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    save_safetensors(part, dest)
    logger.info("extracted %d tensors (%s.*) -> %s", len(part), prefix, dest)
    return True


def ensure_model_part_exists(part_key: str, dest: str,
                             unified_model_path: Optional[str] = None) -> Optional[str]:
    """Part file path if present; else extract from unified; else download.

    Mirrors the reference flow (utils/downloader.py:44-125).
    """
    if os.path.exists(dest):
        return dest
    if unified_model_path and os.path.exists(unified_model_path):
        if extract_part(unified_model_path, part_key, dest):
            return dest
    url = MODEL_PART_URLS.get(part_key)
    if url and download_file(url, dest):
        return dest
    return None


def ensure_model_file(dest: str, url: str = FLOAT_URL) -> Optional[str]:
    """Ensure the unified checkpoint exists (download when possible)."""
    if os.path.exists(dest):
        return dest
    if download_file(url, dest):
        return dest
    return None


# ---------------------------------------------------------------------------
# model-store discovery (reference: utils/downloader.py:135-175,
# nodes_vadv_loader.py:29-34) — directory conventions under <models_root>:
#   float/FLOAT.safetensors                  unified checkpoint
#   float/audio_projections/*.safetensors    projection parts
#   float/motion_autoencoder/*.safetensors   encoder/decoder parts
#   float/fmt/*.safetensors                  FMT parts
#   audio/<hf-dir>/                          wav2vec2 / SER HF dirs
# ---------------------------------------------------------------------------

PROJECTIONS_DIR = "float/audio_projections"
MOTION_AE_DIR = "float/motion_autoencoder"
FMT_SUBDIR = "float/fmt"
WAV2VEC_DIRS_ROOT = "audio"


def look_for_models(models_root: str, f_dir: str, default_name: str) -> list:
    """List .safetensors files under <models_root>/<f_dir>, default first.

    Mirrors the reference's loader-dropdown population
    (utils/downloader.py:135-148): the default name always leads, even when
    the file does not exist yet (it would be downloaded on demand).
    """
    models_path = os.path.join(models_root, f_dir)
    if not os.path.isdir(models_path):
        try:
            os.makedirs(models_path, exist_ok=True)
        except OSError:
            pass
    others = []
    if os.path.isdir(models_path):
        others = sorted(f for f in os.listdir(models_path)
                        if f.endswith(".safetensors") and f != default_name)
    return [default_name] + others


def look_for_model_dirs(models_root: str, f_dir: str, default_name: str) -> list:
    """List HF model directories (config.json + weights file) under
    <models_root>/<f_dir>, default first
    (reference: utils/downloader.py:151-175)."""
    models_path = os.path.join(models_root, f_dir)
    if not os.path.isdir(models_path):
        try:
            os.makedirs(models_path, exist_ok=True)
        except OSError:
            pass
    others = []
    if os.path.isdir(models_path):
        for name in os.listdir(models_path):
            if name == default_name:
                continue
            full = os.path.join(models_path, name)
            if (os.path.isdir(full)
                    and os.path.exists(os.path.join(full, "config.json"))
                    and any(os.path.exists(os.path.join(full, w)) for w in
                            ("pytorch_model.bin", "model.safetensors",
                             "tf_model.h5"))):
                others.append(name)
    return [default_name] + sorted(others)


def resolve_model_path(models_root: str, f_dir: str, name: str) -> str:
    """<models_root>/<f_dir>/<name> — the store's path convention."""
    return os.path.join(models_root, f_dir, name)


def snapshot_download_fallback(repo_id: str, local_dir: str) -> bool:
    """Best-effort huggingface_hub.snapshot_download (the legacy-path
    fallback, reference: nodes.py:93-94).  Returns False offline."""
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        logger.warning("huggingface_hub not available; cannot snapshot %s",
                       repo_id)
        return False
    try:
        snapshot_download(repo_id=repo_id, local_dir=local_dir)
        return True
    except Exception as exc:
        logger.warning("snapshot_download(%s) failed: %s", repo_id, exc)
        return False
