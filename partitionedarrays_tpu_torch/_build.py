"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, which is loaded with
``ctypes``.  The build runs on first use, in the process that first needs
a kernel, and lands in ``build/torch_kernels/`` beside the package (a
directory git ignores).  The library's name carries a hash of the sources
and flags, so an edited source is rebuilt and a stale library is never
loaded.  A missing ``nvcc`` or a failed build raises with the compiler's
output: there is no fallback.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # register and spill report, kept in the build log
)

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_longlong
# C entry points (one per dtype suffix) and their argument types: every
# pointer and the stream are c_void_p, or ctypes would pass 32-bit ints
_SIGNATURES = {
    # vals, x, y, offsets (host int array), n_off, R, n_cols, P, stream
    "pat_dia_spmv": [_VP, _VP, _VP, ctypes.POINTER(_INT), _INT, _I64, _I64, _INT, _VP],
    # vals, x, out, tap (device int [m, n_off]), P, m, n_off, Lq, stream
    "pat_ax_core": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _I64, _VP],
    # vals, bd, invd, x, tap (device int [m, n_off]), c, P, m, n_off, Lq, stream
    "pat_gs_color": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _I64, _VP],
}
DTYPE_SUFFIX = {"float32": "f32", "float64": "f64"}

# the loaded library: a process-wide resource, built and opened once
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels of partitionedarrays_tpu_torch cannot be built"
        )
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libpat_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cu, _ = _sources()
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(f) for f in cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(CSRC))
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build_log() -> str:
    """The compiler's output of the last build of the current sources."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for base, argtypes in _SIGNATURES.items():
            for suffix in DTYPE_SUFFIX.values():
                fn = getattr(lib, f"{base}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = _INT
        _lib = lib
    return _lib


def entry(base: str, dtype: torch.dtype):
    """The C entry point ``base`` for a torch dtype (float32 or float64)."""
    name = str(dtype).replace("torch.", "")
    return getattr(library(), f"{base}_{DTYPE_SUFFIX[name]}")


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on the device of tensor ``t``."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
