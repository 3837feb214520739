"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use into its own shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build dir>/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source builds anew and an unchanged one is reused.  The build directory is
``build/kernels`` at the root of the checkout (git-ignored), or
``$HOROVOD_TPU_TORCH_BUILD_DIR``.  Nothing here is touched when a module is
imported: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Mapping, Sequence

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
NVCC_FLAGS: tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    d = os.environ.get("HOROVOD_TPU_TORCH_BUILD_DIR")
    return Path(d) if d else _PKG.parent / "build" / "kernels"


def nvcc() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, then ``PATH``,
    then the toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from source at first use")


def _target(name: str) -> tuple[Path, Path]:
    src = SRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str) -> Path:
    """The named kernel's library, compiled with one ``nvcc`` unless a
    current build is already there.  Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    src, so = _target(name)
    if so.is_file():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if p.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{p.returncode}\n"
                           f"{p.stdout.decode(errors='replace')}")
    os.replace(tmp, so)
    return so


def load(name: str,
         signatures: Mapping[str, tuple[object, Sequence[object]]]
         ) -> ctypes.CDLL:
    """The named kernel's library, built if needed, with ``restype`` and
    ``argtypes`` set from ``signatures`` (function -> (restype,
    argtypes)).  Pointers and streams must be ``ctypes.c_void_p``: an
    unset argtype passes a Python int as a 32-bit C int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = list(argtypes)
            _libs[name] = lib
        return lib
