"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into ``lib<name>-<hash>.so``
under ``build/float_torch_kernels/`` at the repository root, keyed by a
hash of the sources and flags, then loaded with ``ctypes``.  A missing
``nvcc`` or a failed build raises with the compiler's output: there is no
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "float_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# every kernel library of the package, one per csrc/<name>.cu: the
# decode's warps, styled tails and flow merge and the sampler's FMT block
# passes, then the two experiments' kernels
PIPELINE_SOURCES = ("warp_shared", "warp_rgb", "styled_tail", "flow_merge",
                    "fmt_block")
SOURCES = PIPELINE_SOURCES + ("warp_window", "fma_dtype")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}: the CUDA kernels of "
            "float_torch are built from source at first use")
    return str(path)


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its build is current; returns the
    shared library's path.  The compiler's report (registers, spills) is
    kept beside it as ``.log``."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    out = BUILD_DIR / f"lib{name}-{_source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name`` once."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]


def build_all(names: tuple = SOURCES) -> list[Path]:
    """Build the kernel libraries ``names`` (every one of ``SOURCES`` by
    default) at once, one nvcc each."""
    with ThreadPoolExecutor(len(names)) as ex:
        return list(ex.map(build, names))
