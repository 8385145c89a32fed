"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` inside this package (a
directory that ``.gitignore`` lists), where ``<hash>`` is taken from the
source and the flags: an edited source builds anew, an unchanged one is
loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``,
    then ``/usr/local/cuda/bin/nvcc``. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels are built from csrc/ on a machine with the toolkit"
    )


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Safe to call from several processes: each writes a private temporary
    file and renames it into place."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_library(name)))
            _LOADED[name] = lib
        return lib


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
