"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of
them started together, and the objects are linked into one shared library
with a plain C interface, loaded with ctypes: no PyTorch headers, so a
build takes seconds.  The library is built at first use into
``build/csdr_tpu_torch/`` beside the package (``build/`` is git-ignored) and
named by a hash of its sources and flags, so an edited source rebuilds;
a lock file there lets one process build while the others wait.

No fallback: on a machine without ``nvcc``, or when the build fails, this
raises.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "csdr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC")

_VP, _LL, _I, _D, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_double, ctypes.c_float
# name -> argtypes of the C entry points (restype int: a cudaError_t)
_SIGNATURES = {
    "csdr_fir_decimate": [_VP, _LL, _VP, _LL, _VP, _I, _I, _LL, _VP, _I, _I,
                          _I, _VP],
    "csdr_shift_fir_decimate": [_VP, _LL, _VP, _LL, _VP, _I, _I, _LL, _VP,
                                _D, _D, _I, _I, _I, _VP],
    "csdr_shift_fir_decimate_dev": [_VP, _LL, _VP, _LL, _VP, _I, _I, _LL,
                                    _VP, _D, _VP, _I, _I, _I, _VP],
    "csdr_fft_ko": [_VP, _VP, _VP, _I, _LL, _VP],
    "csdr_ifft_ko": [_VP, _VP, _VP, _I, _LL, _VP],
    "csdr_fft_natural": [_VP, _VP, _VP, _I, _LL, _VP],
    "csdr_fastddc_inv": [_VP, _VP, _VP, _VP, _VP, _VP, _LL, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _VP],
    "csdr_fir_poly": [_VP, _LL, _VP, _I, _I, _LL, _I, _I, _I, _VP, _VP],
    "csdr_adpcm_encode": [_VP, _VP, _VP, _VP, _I, _LL, _VP],
    "csdr_adpcm_decode": [_VP, _VP, _VP, _VP, _I, _LL, _VP],
    "csdr_adpcm_chain_probe": [_VP, _VP, _I, _I, _VP],
    "csdr_fma_chain": [_VP, _VP, _LL, _I, _F, _F, _VP],
    "csdr_ted_scan": [_VP, _I, _VP, _VP, _VP, _VP] + [_I] * 11
                     + [_F] * 3 + [_I] * 3 + [_VP] * 7,
    "csdr_ted_scan_l2": [_VP, _I, _VP, _VP, _VP, _VP] + [_I] * 11
                        + [_F] * 3 + [_VP] * 7,
    "csdr_ted_chain_probe": [_VP, _VP, _VP, _I, _VP],
    "csdr_agc_relax": [_VP, _LL] + [_I] * 4 + [_F] * 5
                      + [_VP, _F, _VP, _I, _I, _I, _I] + [_VP] * 9,
    "csdr_agc_chain_probe": [_VP, _VP, _I, _VP],
    "csdr_agc_ff_scan": [_VP, _LL, _I] + [_F] * 5 + [_I] * 2 + [_VP] * 10,
    "csdr_agc_ff_chain_probe": [_VP, _VP, _I] + [_F] * 5
                               + [_I, _I, _F, _I, _F, _I, _VP, _VP],
    "csdr_costas_scan": [_VP, _I, _I, _F, _F, _F, _I, _I] + [_VP] * 10,
    "csdr_pll_scan": [_VP, _I, _I, _F, _F, _I] + [_VP] * 9,
    "csdr_costas_chain_probe": [_VP, _VP, _I, _F, _F, _F, _I, _I, _F, _F,
                                _F, _VP, _VP],
    "csdr_pll_chain_probe": [_VP, _VP, _I, _F, _F, _I, _F, _F, _F, _VP,
                             _VP],
    "csdr_baudot_scan": [_VP, _I, _I, _I, _I, _I] + [_VP] * 15,
    "csdr_baudot_empty": [_VP],
    "csdr_baudot_phase_probe": [_VP, _I, _I, _I, _I, _I] + [_VP] * 16,
    "csdr_baudot_chain_probe": [_VP, _VP, _I, _VP, _VP] + [_I] * 5
                               + [_VP, _VP],
}
# name -> argtypes of the int-returning queries (shared memory, tiles)
_QUERIES = {
    "csdr_fir_decimate_smem_bytes": [_I, _I, _I, _I],
    "csdr_fastddc_inv_smem_bytes": [_I, _I, _I],
    "csdr_fir_poly_smem_bytes": [_I, _I, _I, _I, _I],
    "csdr_fft_ko_pass_bits": [_I, _I],
    "csdr_fft_ko_frames_per_block": [_I, _LL],
    "csdr_agc_relax_clusters": [_I, _I, _I],
    "csdr_agc_relax_threads": [_I, _I, _I],
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


def _run(cmd: list[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"csdr_tpu_torch: nvcc failed ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; returns
    the library path.  One nvcc per source, in parallel, then one link."""
    sources = _sources()
    out = BUILD_DIR / f"libcsdr_kernels_{_digest(sources)}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one build at a time: the processes of a CLI pipeline start together,
    # and the first builds while the others wait for its library
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.is_file():
            _build_locked(sources, out)
    return out


def _build_locked(sources: list[Path], out: Path) -> None:
    global build_seconds
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    # build under a private directory, then rename: a process that does
    # not take the lock never loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp, p.stem + ".o")) for p in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                for p, o in zip(sources, objs)]
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            list(pool.map(_run, cmds))
        so = str(Path(tmp, out.name))
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs])
        os.replace(so, out)
    build_seconds = time.perf_counter() - t0


def ptxas_usage(source: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel of one
    ``csrc`` source, as ``nvcc -Xptxas -v`` reports them compiling it
    alone with the build's flags: {mangled name: {"registers",
    "stack_bytes", "spill_store_bytes", "spill_load_bytes"}}."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp, "k.o")), str(CSRC / source)],
            capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"csdr_tpu_torch: nvcc failed on {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return parse_ptxas(proc.stdout + proc.stderr)


def parse_ptxas(text: str) -> dict:
    """:func:`ptxas_usage`'s table from ptxas's ``-v`` report."""
    info, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            info[name] = {}
        elif name and re.search(r"Used \d+ registers", line):
            info[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
        elif name and "stack frame" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            info[name].update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                              spill_load_bytes=nums[2])
    return info


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
        for name, argtypes in _QUERIES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib().csdr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
