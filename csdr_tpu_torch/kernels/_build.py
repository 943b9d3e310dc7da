"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ctypes: no PyTorch headers, so a build
takes seconds.  The library is built at first use into
``build/csdr_tpu_torch/`` beside the package (``build/`` is git-ignored) and
named by a hash of its sources and flags, so an edited source rebuilds.

No fallback: on a machine without ``nvcc``, or when the build fails, this
raises.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "csdr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_VP, _LL, _I, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_double
# name -> argtypes of the C entry points (restype int: a cudaError_t)
_SIGNATURES = {
    "csdr_fir_decimate": [_VP, _LL, _VP, _LL, _VP, _I, _I, _LL, _VP, _VP],
    "csdr_shift_fir_decimate": [_VP, _LL, _VP, _LL, _VP, _I, _I, _LL, _VP,
                                _D, _D, _VP],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's build


def nvcc_path() -> str:
    """The nvcc to build with: on PATH, else under CUDA_HOME or
    /usr/local/cuda.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("csdr_tpu_torch: nvcc not found (PATH, CUDA_HOME, "
                       "/usr/local/cuda); the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for p in sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; returns
    the library path."""
    global build_seconds
    sources = _sources()
    out = BUILD_DIR / f"libcsdr_kernels_{_digest(sources)}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build to a private name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"csdr_tpu_torch: nvcc failed ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.csdr_cuda_error_string.argtypes = [ctypes.c_int]
        handle.csdr_cuda_error_string.restype = ctypes.c_char_p
        handle.csdr_fir_decimate_tile.argtypes = []
        handle.csdr_fir_decimate_tile.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib().csdr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
