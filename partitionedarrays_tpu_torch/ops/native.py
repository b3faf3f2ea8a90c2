"""The native host setup library: COO compression, greedy coloring, Vanek
aggregation and ILU(0), in C++ loaded with ``ctypes``.

Counterpart of ``partitionedarrays_tpu/ops/native.py`` (:1-210), built from
the port's copy of the source, ``native/native.cpp``.  The library is
compiled with ``g++ -O3 -shared -fPIC -std=c++17`` on first use into
``build/torch_native/`` beside the package (a directory git ignores), named
by a hash of the source and flags, written under a temporary name and
renamed, so that processes building at once never load a half-written file.
A missing ``g++`` or a failed build raises with the compiler's output:
unlike the reference, there is no silent fallback to Python.

The plain versions are the reference's Python fallbacks:
``_ilu0_python`` (:183-210) and ``_greedy_coloring_python`` (the body of
``partitionedarrays_tpu/solvers/smoothers.py::greedy_coloring``, :42-53)
here, ``solvers/amg.py::aggregate_plain``, and scipy's COO to CSR
conversion.  The tests hold the library against them; the entry points
never use them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import scipy.sparse as sp

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "native.cpp"
BUILD_DIR = _PKG.parent / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
# every pointer is c_void_p, every count int64 (the C entries' types)
_SIGNATURES = {
    "coo_to_csr": [_VP, _VP, _VP, _I64, _I64, _VP, _VP, _VP],
    "greedy_coloring": [_VP, _VP, _I64, _VP],
    "vanek_aggregate": [_VP, _VP, _VP, _I64, ctypes.c_double, _VP],
    "ilu0": [_VP, _VP, _VP, _I64],
}

# the loaded library: a process-wide resource, built and opened once
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpatnative_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the one for this source exists."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the native setup library of "
            "partitionedarrays_tpu_torch cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit code {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The native library, built and loaded on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I64
        _lib = lib
    return _lib


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def coo_to_csr_native(I, J, V, m: int, n: int) -> sp.csr_matrix:
    """COO -> scipy CSR (float64 values, int32 columns) with duplicates
    summed; entries with a negative row or column are dropped."""
    I, J, V = _i64(I), _i64(J), _f64(V)
    nnz = I.size
    indptr = np.zeros(m + 1, dtype=np.int64)
    indices = np.zeros(max(nnz, 1), dtype=np.int64)
    data = np.zeros(max(nnz, 1), dtype=np.float64)
    w = library().coo_to_csr(I.ctypes.data, J.ctypes.data, V.ctypes.data, nnz, m,
                             indptr.ctypes.data, indices.ctypes.data, data.ctypes.data)
    return sp.csr_matrix((data[:w], indices[:w].astype(np.int32, copy=False), indptr),
                         shape=(m, n))


def greedy_coloring_native(A) -> np.ndarray:
    """Greedy coloring of the symmetrized adjacency of a local sparse
    matrix: int32 color per row."""
    S = (A + A.T).tocsr()
    n = S.shape[0]
    indptr, indices = _i64(S.indptr), _i64(S.indices)
    colors = np.zeros(n, dtype=np.int32)
    library().greedy_coloring(indptr.ctypes.data, indices.ctypes.data, n, colors.ctypes.data)
    return colors


def _greedy_coloring_python(A) -> np.ndarray:
    """``greedy_coloring_native`` in Python (its plain version)."""
    n = A.shape[0]
    S = (A + A.T).tocsr()
    colors = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        nbr = S.indices[S.indptr[i] : S.indptr[i + 1]]
        used = set(colors[nbr[nbr < n]].tolist())
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


def vanek_aggregate_native(A, eps: float) -> np.ndarray:
    """Vanek et al. alg. 5.1 aggregation (three passes) of a local sparse
    matrix: int64 aggregate id per row."""
    A = A.tocsr()
    n = A.shape[0]
    indptr, indices, data = _i64(A.indptr), _i64(A.indices), _f64(A.data)
    agg = np.zeros(n, dtype=np.int64)
    library().vanek_aggregate(indptr.ctypes.data, indices.ctypes.data, data.ctypes.data, n,
                              float(eps), agg.ctypes.data)
    return agg


def _with_diagonal(A) -> sp.csr_matrix:
    """A as a canonical CSR (sorted indices) with an explicit zero on every
    missing diagonal entry: ILU(0) needs a structural diagonal.  (The
    reference adds a matrix of explicit zeros, which scipy's sum drops, so
    its ilu0 raises on such a block: the zeros are inserted as COO entries
    here, which the conversion keeps.)"""
    A = A.tocsr()
    if not A.has_sorted_indices:
        A = A.copy()
        A.sort_indices()
    n = A.shape[0]
    rows_all = np.repeat(np.arange(n), np.diff(A.indptr))
    diag_missing = np.setdiff1d(np.arange(n), A.indices[rows_all == A.indices],
                                assume_unique=False)
    if diag_missing.size:
        C = A.tocoo()
        A = sp.csr_matrix(
            (np.concatenate([C.data, np.zeros(diag_missing.size, C.data.dtype)]),
             (np.concatenate([C.row, diag_missing]), np.concatenate([C.col, diag_missing]))),
            shape=A.shape,
        )
        A.sort_indices()
    return A


def _factors(indptr, indices, data, n: int, shape):
    """Split the combined in-place storage into L (unit lower, its
    diagonal stored) and U (upper), canonical CSR."""
    rows = np.repeat(np.arange(n), np.diff(indptr))
    lower = rows > indices
    upper = ~lower
    L = sp.csr_matrix(
        (np.concatenate([data[lower], np.ones(n)]),
         (np.concatenate([rows[lower], np.arange(n)]),
          np.concatenate([indices[lower], np.arange(n)]))),
        shape=shape,
    )
    U = sp.csr_matrix((data[upper], (rows[upper], indices[upper])), shape=shape)
    L.sort_indices()
    U.sort_indices()
    return L, U


def ilu0(A):
    """ILU(0) of a square sparse matrix (zero fill), in float64 on the
    host: returns (L, U), L unit lower (its unit diagonal stored) and U
    upper, canonical CSR with exactly A's lower and upper patterns (a
    missing diagonal entry is inserted as an explicit zero first).  Tiny
    pivots (|u_ii| < 1e-12 of the mean |a_ij|) are perturbed to that size
    instead of failing: the factors serve a preconditioner.  The caller
    casts."""
    A = _with_diagonal(A)
    n = A.shape[0]
    indptr, indices = _i64(A.indptr), _i64(A.indices)
    data = np.array(A.data, dtype=np.float64)  # a copy: factored in place
    if library().ilu0(indptr.ctypes.data, indices.ctypes.data, data.ctypes.data, n) < 0:
        raise ValueError("ilu0: structurally missing diagonal")
    return _factors(indptr, indices, data, n, A.shape)


def _ilu0_python(indptr, indices, data, n):
    """The IKJ factorization in Python, in place on a canonical CSR with a
    structural diagonal (``_with_diagonal``; split with ``_factors``): the
    plain version of the library's ``ilu0``."""
    pos = np.full(n, -1, dtype=np.int64)
    diagpos = np.full(n, -1, dtype=np.int64)
    scale = np.abs(data).mean() if data.size else 1.0
    tiny = 1e-12 * max(scale, 1e-300)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        for p in range(lo, hi):
            pos[indices[p]] = p
            if indices[p] == i:
                diagpos[i] = p
        for p in range(lo, hi):
            k = indices[p]
            if k >= i:
                break
            dk = diagpos[k]
            data[p] /= data[dk]
            lik = data[p]
            for q in range(dk + 1, indptr[k + 1]):
                pp = pos[indices[q]]
                if pp >= 0:
                    data[pp] -= lik * data[q]
        if diagpos[i] < 0:
            raise ValueError("ilu0: structurally missing diagonal")
        if abs(data[diagpos[i]]) < tiny:
            data[diagpos[i]] = tiny if data[diagpos[i]] >= 0 else -tiny
        pos[indices[lo:hi]] = -1
