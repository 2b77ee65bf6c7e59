"""Where the port keeps what persists between processes — the counterpart
of ``roadvision_tpu/utils/cache.py``.

The JAX package points XLA's persistent compilation cache at a directory
so that later processes start warm. The port compiles no graphs; what it
keeps across processes is the hand-written kernels' ``nvcc`` builds
(``kernels/_build.py``, hashed on source and flags) and the native host
ops' ``g++`` builds beside them (``runtime/native``, under ``native/``).
:func:`enable_compilation_cache` points both at ``path``. As in the JAX
package, ``RVT_NO_CACHE=1`` makes it a no-op, and calling it twice is
safe. It adds no environment knob: where the JAX package reads
``RVT_JAX_CACHE``, the port's default is its build directory,
``build/roadvision_tpu_torch/`` at the repo root.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union


def enable_compilation_cache(path: Optional[Union[str, Path]] = None
                             ) -> Optional[Path]:
    """Build (and look for) the port's kernels under ``path`` (default:
    the build directory in use); returns it, or None under
    ``RVT_NO_CACHE=1``. Libraries already loaded stay loaded."""
    if os.environ.get("RVT_NO_CACHE") == "1":
        return None
    from ..kernels import _build
    if path is not None:
        _build.BUILD_DIR = Path(path).resolve()
    return Path(_build.BUILD_DIR)
