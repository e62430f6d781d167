"""One build path for the port's hand-written CUDA kernels (csrc/*.cu).

`load(source, flags)` compiles a source with `nvcc` for sm_90a into a shared library
with a plain C interface under `build/kernels/` at the checkout root, named by a hash
of the source and the flags, and loads it with ctypes. A library that exists is reused;
a failed build raises with nvcc's output. Each source gets its own library, so kernels
build independently (and in parallel: the compile runs in a subprocess, which releases
the interpreter lock). Nothing is compiled at import time.
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
from typing import Dict, Mapping, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[Tuple[Path, Tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def library_path(source: Path, flags: Sequence[str]) -> Path:
    """Where the library of `source` built with `flags` lives (hash of both)."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libssd_{source.stem}_{digest}.so"


def build(source: Path, flags: Sequence[str]) -> Path:
    """Compile `source` unless its library already exists; returns the library path."""
    target = library_path(source, flags)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never see half a file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, str(source)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return target


Signatures = Mapping[str, Tuple[Sequence[type], type]]


def load(source: Path, flags: Sequence[str], signatures: Signatures) -> ctypes.CDLL:
    """The loaded library of `source` (built first if needed), one per process, with
    `signatures` ({C function: (argtypes, restype)}) declared on first load. Every
    library also exports `ssd_cuda_error_string(int) -> const char*`. After the first
    call this is a dictionary lookup: no file is read or hashed on the launch path."""
    key = (source, tuple(flags))
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    with _lock:
        if key not in _loaded:
            lib = ctypes.CDLL(str(build(source, flags)))
            declared = dict(signatures, ssd_cuda_error_string=([ctypes.c_int], ctypes.c_char_p))
            for name, (argtypes, restype) in declared.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _loaded[key] = lib
        return _loaded[key]


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.ssd_cuda_error_string(err).decode()} ({err})")
