"""Version-consistency check: ``pyproject.toml`` against
``float_torch.__version__`` (twin of tools/check_versions.py, which checks
``float_tpu``):

    python -m float_torch.tools.check_versions
"""
from __future__ import annotations

import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def read_version(path: str, key: str) -> str | None:
    """The quoted value of ``key = "..."`` at the start of a line."""
    with open(path) as f:
        m = re.search(rf'^{key}\s*=\s*"([^"]+)"', f.read(), re.M)
    return m.group(1) if m else None


def main() -> None:
    pyproject_version = read_version(os.path.join(ROOT, "pyproject.toml"),
                                     "version")
    module_version = read_version(
        os.path.join(ROOT, "float_torch", "__init__.py"), "__version__")
    if pyproject_version is None or pyproject_version != module_version:
        print(f"version mismatch: pyproject={pyproject_version} "
              f"float_torch.__version__={module_version}")
        sys.exit(1)
    print(f"versions consistent: {pyproject_version}")


if __name__ == "__main__":
    main()
