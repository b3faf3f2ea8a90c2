"""The port's public surface against the JAX package's.

Every public name of ``partitionedarrays_tpu/__init__.py`` (found by
parsing it with ``ast``) exists in ``partitionedarrays_tpu_torch``, and
is callable where the reference's is, except the names of ``EXCLUDED``,
each with its reason.  The names that the surface gained with it are held
against the reference's: ``nzindex``, ``compresscoo(combine=)``, the
host-level ``dia_spmv``, and ``nbytes``/``astype`` of the device blocks and
matrices.
"""
import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import partitionedarrays_tpu
import partitionedarrays_tpu_torch as port
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.ops import dia as jax_dia
from partitionedarrays_tpu.ops import sparse_host as jax_sparse_host

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.ops import dia, sparse_host
from partitionedarrays_tpu_torch.psparse import psparse

jax_gallery = importlib.import_module("partitionedarrays_tpu.models.gallery")
jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_prange = importlib.import_module("partitionedarrays_tpu.parallel.p_range")

# name -> why the port does not give it as the reference does
EXCLUDED = {
    "pallas_enabled": "configures the TPU's Pallas kernels; the port's kernels are CUDA",
    "enable_compilation_cache": "configures XLA's compilation cache; the port compiles no XLA",
    "psparse": "the port exports the module psparse (its tests import it as a module); the "
               "COO constructor is psparse.psparse",
    "pvector": "the port exports the module pvector (its tests import it as a module); the "
               "COO constructor is pvector.pvector",
}


def _reference_names():
    tree = ast.parse(Path(partitionedarrays_tpu.__file__).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return sorted(n for n in names if not n.startswith("_"))


def test_every_public_name_of_the_reference_exists():
    names = _reference_names()
    assert len(names) > 250 and set(EXCLUDED) <= set(names)
    missing = [n for n in names if n not in EXCLUDED and not hasattr(port, n)]
    assert not missing, missing
    kinds = [n for n in names if n not in EXCLUDED
             and callable(getattr(partitionedarrays_tpu, n)) and not callable(getattr(port, n))]
    assert not kinds, kinds
    for n in ("psparse", "pvector"):
        assert callable(getattr(getattr(port, n), n))


def test_nzindex_matches_reference():
    A = sp.random(30, 40, density=0.2, format="csr", random_state=3)
    A.sort_indices()
    for i in range(30):
        for j in range(0, 40, 3):
            assert port.nzindex(A, i, j) == jax_sparse_host.nzindex(A, i, j)


@pytest.mark.parametrize("combine", ["add", "max"])
def test_compresscoo_combine_matches_reference(combine):
    """``combine="add"`` equals the reference bit for bit (duplicates and
    negative ids included); the reference ignores any other value and adds,
    so the port refuses it."""
    rng = np.random.default_rng(4)
    I = rng.integers(-2, 20, 200)
    J = rng.integers(-2, 15, 200)
    V = rng.standard_normal(200)
    if combine != "add":
        with pytest.raises(ValueError, match="'add' only"):
            sparse_host.compresscoo(I, J, V, 20, 15, combine=combine)
        return
    got = port.compresscoo(I, J, V, 20, 15, combine=combine)
    want = jax_sparse_host.compresscoo(I, J, V, 20, 15, combine=combine)
    for k in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_host_dia_spmv_matches_reference():
    """The reference's per-part signature (vals [n_off, R], x [n_cols_pad])."""
    rng = np.random.default_rng(5)
    offsets = (-7, -1, 0, 2, 9)
    vals = rng.standard_normal((len(offsets), 50))
    x = rng.standard_normal(56)
    got = port.dia_spmv(offsets, torch.from_numpy(vals), torch.from_numpy(x), 56).numpy()
    want = np.asarray(jax_dia.dia_spmv(offsets, vals, x, 56))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14 * np.abs(want).max())
    assert dia.dia_spmv is port.dia_spmv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nbytes_and_astype_match_reference(dtype):
    """The Laplacian's DIA own block and its compressed-row own-ghost block
    on (2,2) parts: ``astype`` casts the values as the reference's (bit for
    bit), shares the structure, and ``nbytes`` counts the DIA values as the
    reference does and the compressed rows' arrays as they are stored."""
    I, J, V, rows, cols = gallery.laplacian_fdm((12, 12), (2, 2))
    A = psparse(I, J, V, rows, cols, SerialBackend(4), assembled=True, device="cpu")
    Ij, Jj, Vj, rj, cj = jax_gallery.laplacian_fdm((12, 12), (2, 2))
    Aj = jax_psparse.psparse(Ij, Jj, Vj, jax_prange.PRange(rj), jax_prange.PRange(cj),
                             JaxSerialBackend(4), assembled=True)
    dev, dev_j = A.device(), Aj.device()
    assert dev.oo.kind == "dia" and dev.oo.nbytes() == dev_j.oo.nbytes()
    oh = dev.oh
    assert oh.nbytes() == sum(t.numel() * t.element_size()
                              for t in (oh.vals, oh.rows, oh.cols, oh.plan.group_lanes))
    assert dev.nbytes() == dev.oo.nbytes() + oh.nbytes()
    cast, cast_j = dev.astype(dtype), dev_j.astype(dtype)
    assert cast.oo.vals.dtype == getattr(torch, dtype) and cast.oh.cols is oh.cols
    got = cast.oo.vals.to(torch.float64).numpy()
    np.testing.assert_array_equal(got, np.asarray(cast_j.oo.vals).astype(np.float64))
    assert cast.oo.nbytes() == cast_j.oo.nbytes()
    np.testing.assert_array_equal(cast.oh.vals.to(torch.float64).numpy(),
                                  oh.vals.to(getattr(torch, dtype)).to(torch.float64).numpy())
