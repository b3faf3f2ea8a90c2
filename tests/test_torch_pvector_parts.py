"""The partitioned vector of the PyTorch port across parts, against the JAX
reference, on (2,2) parts of ``laplacian_fem``'s node partition: the COO
constructor ``pvector`` (contributions to rows of other parts, assembled
to their owners or left in the ghost slots), ``consistent`` and
``assemble`` as tasks, ``collect``, the reductions and the distances.

Values are made with numpy from a seed.  The gathered ghosts, the
partitions and ``collect`` are held equal bit for bit; sums (the assembled
values, the reductions and the distances) to 1e-12 (float64) and 1e-6
(float32) relative, since the two packages may add in another order.
"""
import importlib

import numpy as np
import pytest
import torch

from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange

from partitionedarrays_tpu_torch import pvector as pv
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.parallel.partition import PRange

jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

torch.set_num_threads(1)

NODES, PARTS = (10, 12), (2, 2)
RTOL = {np.float64: 1e-12, np.float32: 1e-6}
DTYPES = pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])


def contributions(rows, dtype, seed=1):
    """Per part: its own ids, and ids of the neighbouring parts' rows (each
    own id once, some ids of other parts several times), with values."""
    rng = np.random.default_rng(seed)
    n = rows[0].n_global
    I, V = [], []
    for li in rows:
        near = rng.integers(0, n, 30)
        ids = np.concatenate([li.own_to_global, near, near[:7]])
        I.append(ids)
        V.append(rng.standard_normal(ids.size).astype(dtype))
    return I, V


def build(dtype, assemble_result=True):
    _, _, _, rows, _ = gallery.laplacian_fem(NODES, PARTS)
    _, _, _, rows_ref, _ = jax_gallery.laplacian_fem(NODES, PARTS)
    I, V = contributions(rows, dtype)
    v = pv.pvector(I, V, PRange(rows), SerialBackend(4), assemble_result=assemble_result,
                   device="cpu")
    v_ref = jax_pvector.pvector(I, V, JaxPRange(rows_ref), JaxSerialBackend(4),
                                assemble_result=assemble_result)
    return v, v_ref, I, V


def _same_partition(v, v_ref):
    for li, li_ref in zip(v.layout.pr.parts, v_ref.layout.pr.partition()):
        np.testing.assert_array_equal(li.ghost_to_global, li_ref.ghost_to_global)
        np.testing.assert_array_equal(li.ghost_to_owner, li_ref.ghost_to_owner)


@DTYPES
@pytest.mark.parametrize("assemble_result", [True, False], ids=["assembled", "ghosts"])
def test_coo_pvector_matches_jax(dtype, assemble_result):
    """The ghosted partition the contributions make, the own and ghost
    values, and (assembled) the global sums of the contributions."""
    v, v_ref, I, V = build(dtype, assemble_result)
    _same_partition(v, v_ref)
    assert v.layout.n_ghost_pad == v_ref.layout.n_ghost_pad > 0
    np.testing.assert_allclose(v.own.numpy(), np.asarray(v_ref.own), rtol=RTOL[dtype])
    np.testing.assert_allclose(v.ghost.numpy(), np.asarray(v_ref.ghost), rtol=RTOL[dtype])
    if assemble_result:
        want = np.zeros(v.n_global)
        np.add.at(want, np.concatenate(I), np.concatenate(V).astype(np.float64))
        np.testing.assert_allclose(pv.collect(v), want, rtol=0, atol=10 * RTOL[dtype] * np.abs(want).max())
        assert not v.ghost.any()


@DTYPES
def test_consistent_and_assemble_tasks_match_jax(dtype):
    """``consistent`` fills the ghosts from their owners (bit for bit);
    ``assemble`` adds them to their owners and zeroes them."""
    v, v_ref, _, _ = build(dtype, assemble_result=False)
    c = pv.consistent(v).wait()
    c_ref = jax_pvector.consistent(v_ref).wait()
    np.testing.assert_array_equal(c.ghost.numpy(), np.asarray(c_ref.ghost))
    np.testing.assert_array_equal(c.own.numpy(), v.own.numpy())
    own = pv.collect(v)
    for li, g in zip(c.layout.pr.parts, c.ghost.numpy()):
        np.testing.assert_array_equal(g[: li.n_ghost], own[li.ghost_to_global])
    a = pv.assemble(v)
    assert a.fetch() is a.wait()
    a_ref = jax_pvector.assemble(v_ref).wait()
    np.testing.assert_allclose(a.wait().own.numpy(), np.asarray(a_ref.own), rtol=RTOL[dtype])
    assert not a.wait().ghost.any()
    np.testing.assert_array_equal(pv.collect(a.wait()), jax_pvector.collect(a_ref))


@DTYPES
def test_reductions_and_distances_match_jax(dtype):
    """``psum_reduce``, ``pmaximum``, ``pminimum``, ``pany``, ``pall`` and
    the distances over own values (the padding lanes never count)."""
    v, v_ref, _, _ = build(dtype)
    w, w_ref, _, _ = build(dtype)
    rng = np.random.default_rng(9)
    shift = rng.standard_normal(v.own.shape).astype(dtype)
    w = pv.PVector(w.own + torch.from_numpy(shift) * (w.own != 0), w.ghost, w.layout, w.backend)
    w_ref = jax_pvector.PVector(np.asarray(w.own), w_ref.ghost, w_ref.layout, w_ref.backend)
    # a negative maximum and a positive minimum, so that a padding zero
    # would show
    neg = pv.PVector(-v.own.abs() - 1, v.ghost, v.layout, v.backend)
    neg_ref = jax_pvector.PVector(np.asarray(neg.own), v_ref.ghost, v_ref.layout, v_ref.backend)
    for x, x_ref in ((v, v_ref), (neg, neg_ref)):
        for name in ("psum_reduce", "pmaximum", "pminimum"):
            got = float(getattr(pv, name)(x))
            want = float(getattr(jax_pvector, name)(x_ref))
            np.testing.assert_allclose(got, want, rtol=RTOL[dtype])
        for name in ("pany", "pall"):
            assert getattr(pv, name)(x) == bool(getattr(jax_pvector, name)(x_ref))
    assert float(pv.pmaximum(neg)) < 0 and float(pv.pminimum(pv.PVector(
        v.own.abs() + 1, v.ghost, v.layout, v.backend))) > 0
    assert pv.pall(neg) and not pv.pany(pv.PVector(v.own * 0, v.ghost, v.layout, v.backend))
    for name in ("peuclidean", "psqeuclidean", "pcityblock", "pchebyshev"):
        got = float(getattr(pv, name)(v, w))
        want = float(getattr(jax_pvector, name)(v_ref, w_ref))
        np.testing.assert_allclose(got, want, rtol=RTOL[dtype], err_msg=name)
    got = float(pv.pdistance(v, w, lambda a, b: (a - b) ** 4, "sum", lambda s: s ** 0.25))
    want = float(jax_pvector.pdistance(v_ref, w_ref, _fourth, "sum", lambda s: s ** 0.25))
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype])
    for red in ("max", "min"):
        got = float(pv.pdistance(neg, v, lambda a, b: a - b, red))
        want = float(jax_pvector.pdistance(neg_ref, v_ref, _diff, red))
        np.testing.assert_allclose(got, want, rtol=RTOL[dtype])
    with pytest.raises(ValueError):
        pv.pdistance(v, w, _diff, "mean")


def _fourth(a, b):
    return (a - b) ** 4


def _diff(a, b):
    return a - b
