"""Build the CUDA sources at first use and load them with ``ctypes``.

``nvcc`` compiles each ``csrc/*.cu`` into a shared library of its own
with a plain C interface, for ``sm_90a`` (Hopper), into
``build/repro_torch_kernels/`` at the repository root: one ``nvcc``
process per source, all started together.  Each file name carries a
hash of its source and the flags, so an edited source is rebuilt and an
unchanged one is loaded from the previous build.  Nothing is built when
this module is imported: :func:`load` runs on the first kernel launch
(or when a caller wants the build time, as ``chip_smoke.py`` does).
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_p, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
#: each source's exported functions: (argument types, result type), every
#: pointer and the stream a ``c_void_p``
SIGNATURES = {
    "flash_attn": {
        "flash_attention_fwd": ([_p] * 5 + [_i] * 6 + [_f, _i] + [_ll] * 12
                                + [_p], _i),
        "flash_attention_max_d": ([], _i),
        "flash_attention_kernel_attrs": ([_i, _p], _i),
    },
    "nomad_sgd": {
        "nomad_sgd_waves": ([_p] * 8 + [_i, _ll, _ll, _i, _i, _f, _f, _i,
                                        _i, _i, _i, _ll, _p], _i),
        "nomad_sgd_waves_profile": ([_p] * 8 + [_i, _ll, _ll, _i, _i, _f,
                                                _f, _i, _i, _i, _ll, _p,
                                                _p], _i),
        "nomad_sgd_smem": ([_i] * 5, _ll),
        "nomad_sgd_max_k": ([], _i),
    },
    "topk": {
        "topk_scores": ([_p, _p, _p, _i, _ll, _i, _i, _i, _i, _i, _ll, _ll,
                         _i, _ll, _p, _p, _ll, _p, _p, _p], _i),
        "topk_scratch_elems": ([_i, _ll, _i, _i], _ll),
        "topk_score_only": ([_p, _p, _p, _i, _ll, _i, _i, _i, _i, _i, _ll,
                             _ll, _i, _ll, _p, _ll, _p], _i),
        "topk_kernel_attrs": ([_i, _ll, _i, _i, _i, _i, _i, _ll, _ll, _i,
                               _ll, _p], _i),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_paths() -> list[Path]:
    """The library of each source, in :func:`_sources` order."""
    out = []
    for src in _sources():
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        h.update(src.read_bytes())
        out.append(BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so")
    return out


def build() -> list[Path]:
    """Compile every source whose library is missing, all at once;
    returns the library paths.  Each library is written under a
    temporary name and renamed into place, so concurrent builders never
    load a partial file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, out in zip(_sources(), library_paths()):
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
        procs.append((out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for out, tmp, cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return library_paths()


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load every kernel library, declaring the C
    signatures of :data:`SIGNATURES`; returns the library of
    ``csrc/<source>.cu``."""
    with _lock:
        if not _libs:
            for src, path in zip(_sources(), build()):
                lib = ctypes.CDLL(str(path))
                for name, (args, res) in SIGNATURES[src.stem].items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = args, res
                _libs[src.stem] = lib
        return _libs[source]
