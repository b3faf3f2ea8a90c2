"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, which is loaded
with ``ctypes``.  The build runs on first use, in the process that first
needs a kernel, and lands in ``build/torch_kernels/`` beside the package (a
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

from .utils import profiling

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    # as pat_dia_spmv, then the values' and x's part strides and lanes per
    # row group
    "pat_dia_spmv_strided": [
        _VP, _VP, _VP, ctypes.POINTER(_INT), _INT, _I64, _I64, _INT, _I64, _I64,
        _INT, _VP,
    ],
    # rows, cols, vals, group lanes, x, y, Nr, K, n_cols, R, P, warps per
    # row group, stream
    "pat_ghost_spmv": [
        _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _I64, _I64, _INT, _INT, _VP,
    ],
    # vals, x, out, tap (device int [m, n_off]), P, m, n_off, Lq, lanes per
    # row group, stream
    "pat_ax_core": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _I64, _INT, _VP],
    # vals, bd, invd, x_in (NULL from a zero guess), x, tap (device int
    # [m, n_off]), steps (device int [n_steps]), n_steps, zero_guess,
    # lanes, width (CTAs per part), P, m, n_off, Lq, stream
    "pat_gs_sweeps": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP,
        _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VP,
    ],
    # vals_hi, vals_lo, x_hi, x_lo, y_hi, y_lo, offsets (host int array),
    # n_off, R, n_cols, P, stream
    "pat_dia_spmv_df": [
        _VP, _VP, _VP, _VP, _VP, _VP, ctypes.POINTER(_INT), _INT, _I64, _I64, _INT, _VP,
    ],
    # pack, rows, cols, vals, tile_ptr, tile_lanes, wave_tiles, steps
    # (device int [n_steps]), b, x, n_steps, nt, D (planes per tile), B, W,
    # Nr, K, P, x in shared memory (1, 0, -1: where it fits), stream
    "pat_tile_gs_sweeps": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
        _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VP,
    ],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
           torch.float16: "f16"}
# (values dtype, vector dtype) pairs whose values are narrower than the
# vectors: the reduced-precision preconditioner values, which K2, K3 and K4
# read and widen exactly to the vector dtype
NARROW_PAIRS = (
    (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.float64),
    (torch.float32, torch.float64),
    (torch.float16, torch.float32),
    (torch.float16, torch.float64),
)
_PAIRS = ((torch.float32, torch.float32), (torch.float64, torch.float64)) + NARROW_PAIRS


def _suffix(values: torch.dtype, vectors: torch.dtype) -> str:
    """An entry's suffix: the vector dtype's where the values share it
    (``f32``), else the values' and the vectors' (``bf16_f32``)."""
    if values == vectors:
        return _SUFFIX[vectors]
    return f"{_SUFFIX[values]}_{_SUFFIX[vectors]}"


# the dtype suffixes of each entry point: K2, K3 and K4 take every pair,
# K7 its one float32 entry (df64 pairs are float32 words), the others
# float32 and float64 (_SAME)
_SUFFIXES = {
    base: tuple(_suffix(v, t) for v, t in _PAIRS)
    for base in ("pat_dia_spmv_strided", "pat_ax_core", "pat_gs_sweeps")
}
_SUFFIXES["pat_dia_spmv_df"] = ("f32",)
_SAME = ("f32", "f64")


def check_pair(name: str, values: torch.dtype, vectors: torch.dtype) -> None:
    """Raise TypeError unless values of dtype ``values`` may go with vectors
    of dtype ``vectors``: the same dtype, or one of ``NARROW_PAIRS``."""
    if values != vectors and (values, vectors) not in NARROW_PAIRS:
        pairs = ", ".join(f"{_SUFFIX[v]} values with {_SUFFIX[t]} vectors"
                          for v, t in NARROW_PAIRS)
        raise TypeError(
            f"{name}: values {values} with vectors {vectors}; the supported pairs are "
            f"one dtype for both, or {pairs}"
        )

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


def _run_all(cmds):
    """Run the commands in parallel; return (return codes, combined log)."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, cwd=str(CSRC))
        for c in cmds
    ]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(f"$ {' '.join(c)}\n{text}" for c, text in zip(cmds, logs))
    return [p.returncode for p in procs], log


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc -c`` per source, all at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    cu, _ = _sources()
    objs = [BUILD_DIR / f"{tag}.{f.stem}.o" for f in cu]
    compile_cmds = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)] for f, o in zip(cu, objs)
    ]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link_cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *(str(o) for o in objs)]
    try:
        codes, log = _run_all(compile_cmds)
        if not any(codes):
            link_codes, link_log = _run_all([link_cmd])
            codes, log = codes + link_codes, log + link_log
        out.with_suffix(".log").write_text(log)
        if any(codes):
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed (exit codes {codes}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
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
            for suffix in _SUFFIXES.get(base, _SAME):
                fn = getattr(lib, f"{base}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = _INT
        _lib = lib
    return _lib


_entries = {}


def entry(base: str, dtype: torch.dtype, values_dtype: Optional[torch.dtype] = None):
    """The C entry point ``base`` for vectors of ``dtype`` (float32 or
    float64) and values of ``values_dtype`` (default: ``dtype``; K2, K3 and
    K4 also take the ``NARROW_PAIRS``)."""
    key = (base, dtype, values_dtype or dtype)
    fn = _entries.get(key)
    if fn is None:
        fn = _entries[key] = getattr(library(), f"{base}_{_suffix(key[2], dtype)}")
    return fn


def check(code: int, what: str) -> None:
    """Count a launch of the C entry ``what`` (``profiling.COUNTS``) and
    raise if it returned a CUDA error code."""
    profiling.count_launch(what)
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on the device of tensor ``t``, as the
    raw ``cudaStream_t`` (the one call PyTorch's own generated kernels make:
    no Stream object is built per launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
