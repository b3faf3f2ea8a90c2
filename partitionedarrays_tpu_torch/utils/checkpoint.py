"""Save and load a PVector or a PSparseMatrix's values with their partitions.

Counterpart of ``partitionedarrays_tpu/utils/checkpoint.py``: the files
hold what the reference's ``.npz`` files hold, under the same keys (the
partition: ``n_parts``, ``n_global`` and each part's ``own_p``,
``ghost_p``, ``gowner_p``; a vector's own values ``vals_p``; a matrix's
global CSR ``indptr``, ``indices``, ``data``, ``shape`` with its row and
column partitions under ``r_`` and ``c_``), each a CPU tensor in one
``torch.save`` file, read back with ``torch.load(weights_only=True)``.  A
loaded object lives on the ``device`` given, which need not be the one it
was saved from; the values keep their dtype.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..parallel.partition import LocalIndices, PRange
from ..psparse import PSparseMatrix, psparse_from_global, to_global_scipy
from ..pvector import PVector, pvector_from_own


def _cpu(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _partition_arrays(pr: PRange) -> dict:
    out = {"n_parts": _cpu(np.int64(pr.n_parts)), "n_global": _cpu(np.int64(pr.n_global))}
    for p, li in enumerate(pr.partition()):
        out[f"own_{p}"] = _cpu(li.own_to_global)
        out[f"ghost_{p}"] = _cpu(li.ghost_to_global)
        out[f"gowner_{p}"] = _cpu(li.ghost_to_owner)
    return out


def _partition_from_arrays(d: dict, prefix: str = "") -> PRange:
    P = int(d[prefix + "n_parts"])
    n = int(d[prefix + "n_global"])
    owner = np.empty(n, dtype=np.int64)
    for p in range(P):
        owner[d[prefix + f"own_{p}"].numpy()] = p

    def g2o(q):
        q = np.asarray(q)
        return np.where(q >= 0, owner[np.clip(q, 0, n - 1)], -1)

    return PRange([
        LocalIndices(n, p, P, d[prefix + f"own_{p}"].numpy(), d[prefix + f"ghost_{p}"].numpy(),
                     d[prefix + f"gowner_{p}"].numpy(), global_to_owner=g2o)
        for p in range(P)
    ])


def save_pvector(path, v: PVector) -> None:
    """``v``'s partition and own values, into ``path``."""
    arrays = _partition_arrays(v.layout.pr)
    for p, vals in enumerate(v.own_values()):
        arrays[f"vals_{p}"] = _cpu(vals)
    torch.save(arrays, path)


def load_pvector(path, backend, dtype=None, device="cuda") -> PVector:
    """The vector saved in ``path``, on ``device`` (its own dtype unless
    ``dtype`` says otherwise)."""
    d = torch.load(path, weights_only=True)
    pr = _partition_from_arrays(d)
    vals = [d[f"vals_{p}"].numpy() for p in range(pr.n_parts)]
    return pvector_from_own(vals, pr, backend, dtype=dtype, device=device)


def save_psparse(path, A: PSparseMatrix) -> None:
    """``A``'s global values (CSR) and its row and column partitions (the
    columns without ghosts, which assembly finds again), into ``path``."""
    G = to_global_scipy(A)
    arrays = {"indptr": _cpu(G.indptr), "indices": _cpu(G.indices), "data": _cpu(G.data),
              "shape": _cpu(np.array(G.shape, dtype=np.int64))}
    cols = PRange([li.remove_ghost() for li in A.col_prange.partition()])
    arrays.update({"r_" + k: v for k, v in _partition_arrays(A.row_prange).items()})
    arrays.update({"c_" + k: v for k, v in _partition_arrays(cols).items()})
    torch.save(arrays, path)


def load_psparse(path, backend, device="cuda") -> PSparseMatrix:
    """The assembled matrix saved in ``path``, on ``device``."""
    d = torch.load(path, weights_only=True)
    G = sp.csr_matrix((d["data"].numpy(), d["indices"].numpy(), d["indptr"].numpy()),
                      shape=tuple(int(s) for s in d["shape"]))
    return psparse_from_global(G, _partition_from_arrays(d, "r_"),
                               _partition_from_arrays(d, "c_"), backend, device=device)
