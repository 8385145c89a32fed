"""Where the port's compiled kernels live across processes.

The JAX package points XLA's persistent compilation cache at a directory
(``kubernetes_tpu/utils/compile_cache.py``). The port's one compiled
artifact is the ``nvcc`` build of each ``csrc/<name>.cu`` (``build.py``),
a shared library named by a hash of its source and flags. This module
chooses the directory those libraries are built into and loaded from, so
that a restart, a second process or a read-only install with the
libraries already built loads them without running ``nvcc``.

Unlike the JAX package, a directory that cannot be written is no reason to
carry on without the cache: the port cannot launch a kernel it cannot
build. ``build.compile_library`` raises ``KernelError`` naming the
directory when it holds no library for the current source and cannot be
created or written.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

from .. import build

ENV = "KUBERNETES_TPU_COMPILE_CACHE"

_LOCK = threading.Lock()


def enable_persistent_cache(cache_dir: str | os.PathLike | None = None) -> str:
    """Idempotently fix the kernel build directory for this process:
    ``cache_dir``, else ``$KUBERNETES_TPU_COMPILE_CACHE``, else
    ``kubernetes_tpu_torch/_build``. The first call wins, as in the JAX
    package; every call returns the directory in use. A library already
    loaded stays loaded from where it was (``build.load``)."""
    with _LOCK:
        if build.BUILD_DIR is None:
            build.BUILD_DIR = Path(
                cache_dir or os.environ.get(ENV) or build.DEFAULT_BUILD_DIR
            )
        return str(build.BUILD_DIR)
