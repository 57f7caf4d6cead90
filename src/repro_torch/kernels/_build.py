"""Build the CUDA sources at first use and load them with ``ctypes``.

``nvcc`` compiles ``csrc/*.cu`` into one shared library with a plain C
interface, for ``sm_90a`` (Hopper), into ``build/repro_torch_kernels/``
at the repository root.  The file name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is loaded
from the previous build.  Nothing is built when this module is imported:
:func:`load` runs on the first kernel launch (or when a caller wants the
build time, as ``chip_smoke.py`` does).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnomad_sgd_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if this exact build is missing; returns the
    library path.  The library is written under a temporary name and
    renamed into place, so concurrent builders never load a partial
    file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, declaring the C
    signatures: ``c_void_p`` for every pointer and the stream."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p = ctypes.c_void_p
            lib.nomad_sgd_waves.argtypes = [
                p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, p]
            lib.nomad_sgd_waves.restype = ctypes.c_int
            lib.nomad_sgd_max_k.argtypes = []
            lib.nomad_sgd_max_k.restype = ctypes.c_int
            _lib = lib
        return _lib
