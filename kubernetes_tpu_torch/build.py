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
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
# called as fn(name, seconds) after each nvcc run that built a library
# (obs/compile.py counts them); an already-built library calls nothing
BUILD_LISTENERS: list = []


class KernelError(RuntimeError):
    """A kernel of the port did not build, load or launch. The scheduler's
    resilience ladder never takes it (``resilience.card_fault``): a card
    whose kernels cannot run is a fault to surface, not a reason to
    schedule from the CPU."""


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
    raise KernelError(
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
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    for fn in list(BUILD_LISTENERS):
        fn(name, seconds)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = compile_library(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(f"cannot load {path.name}: {e}") from e
            _LOADED[name] = lib
        return lib


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
