"""The port's utilities against the JAX reference's (``partitionedarrays_tpu/
utils``): ``PTimer`` (its fields, statistics and both report formats, on the
same recorded times; its fence), the checkpoint files (the reference's keys
and arrays, a round trip of a vector and of a matrix, onto another
partition's backend), and the profiling helpers over ``torch.profiler`` on
the CPU."""
import importlib
import json

import numpy as np
import pytest
import torch

from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.parallel import p_range as jp

from partitionedarrays_tpu_torch import compat
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.gallery import laplacian_fem
from partitionedarrays_tpu_torch.parallel.partition import PRange, uniform_partition
from partitionedarrays_tpu_torch.psparse import psparse, spmv, to_global_scipy
from partitionedarrays_tpu_torch.pvector import collect, pvector_from_own
from partitionedarrays_tpu_torch.utils import checkpoint, profiling, ptimer

jptimer = importlib.import_module("partitionedarrays_tpu.utils.ptimer")
jcheckpoint = importlib.import_module("partitionedarrays_tpu.utils.checkpoint")
jpsparse = importlib.import_module("partitionedarrays_tpu.psparse")
jpvector = importlib.import_module("partitionedarrays_tpu.pvector")
jgallery = importlib.import_module("partitionedarrays_tpu.models.gallery")

torch.set_num_threads(1)

TIMES = {"setup": [0.5, 0.25], "solve": [1.5e-3, 2.5e-3, 1e-3], "refill": [7.0]}


def _timers():
    t, j = ptimer.PTimer(device="cpu"), jptimer.PTimer()
    for timer in (t, j):
        timer.data = {k: list(v) for k, v in TIMES.items()}
    return t, j


def test_ptimer_reports_the_reference_s_fields():
    t, j = _timers()
    assert t.statistics() == j.statistics()
    assert set(t.statistics()["solve"]) == {"min", "max", "avg", "calls"}
    assert t.gather_statistics() == j.gather_statistics()
    assert list(t.gather_statistics()) == sorted(TIMES)
    assert repr(t) == repr(j)


def test_ptimer_print_main_matches_the_reference(capsys):
    t, j = _timers()
    t.print_main()
    mine = capsys.readouterr().out
    j.print_main()
    assert mine == capsys.readouterr().out
    assert mine.splitlines()[0].split() == ["section", "min", "(s)", "avg", "(s)", "max", "(s)"]


def test_ptimer_times_sections_and_fences():
    """tic/toc (and the compat functions) record every call; ``toc``
    returns the section's seconds; a CPU timer's fence is a no-op; a
    multi-process backend has no statistics yet (ROADMAP item 15)."""
    t = ptimer.PTimer(barrier_at_tic=True, device="cpu")
    for _ in range(3):
        compat.tic(t, "a")
        x = torch.randn(64, 64) @ torch.randn(64, 64)
        assert compat.toc(t, "a") >= 0.0
    t.tic("b")
    dt = t.toc("b")
    s = compat.statistics(t)
    assert s["a"]["calls"] == 3 and s["b"]["calls"] == 1 and s["b"]["max"] == dt
    assert float(x.abs().sum()) > 0
    with pytest.raises(KeyError):
        t.toc("never opened")

    class Multi:
        is_multiprocess = True

    with pytest.raises(NotImplementedError, match="item 15"):
        t.gather_statistics(Multi())
    ptimer.barrier("cpu")
    assert ptimer.current_time() <= ptimer.current_time()


def test_ptimer_defaults_to_the_card():
    t = ptimer.PTimer()
    assert t.device == torch.device("cuda")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    t.tic("a")
    with pytest.raises(AssertionError, match="CUDA"):
        t.toc("a")


def _vector_pair(tmp_path):
    """The same ghosted vector in both packages, saved by each."""
    pr_t = PRange(uniform_partition(4, 20, ghost=1))
    pr_j = jp.PRange(jp.uniform_partition(4, 20, ghost=1))
    vals = [li.own_to_global.astype(np.float64) * 1.5 for li in pr_t.parts]
    v = pvector_from_own(vals, pr_t, SerialBackend(4), dtype=np.float64, device="cpu")
    w = jpvector.pvector_from_own(vals, pr_j, JaxSerialBackend(4), dtype=np.float64)
    checkpoint.save_pvector(tmp_path / "v.pt", v)
    jcheckpoint.save_pvector(str(tmp_path / "v.npz"), w)
    return v, tmp_path / "v.pt", tmp_path / "v.npz"


def _same_files(pt, npz):
    mine = torch.load(pt, weights_only=True)
    ref = np.load(npz)
    assert sorted(mine) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(mine[k].numpy(), ref[k])
        assert mine[k].numpy().dtype == ref[k].dtype, k


def test_checkpoint_vector_holds_the_reference_s_arrays(tmp_path):
    v, pt, npz = _vector_pair(tmp_path)
    _same_files(pt, npz)
    w = checkpoint.load_pvector(pt, SerialBackend(4), device="cpu")
    np.testing.assert_array_equal(collect(w), collect(v))
    assert w.dtype == torch.float64 and w.own.device.type == "cpu"
    assert [li.ghost_to_global.tolist() for li in w.layout.pr.parts] == [
        li.ghost_to_global.tolist() for li in v.layout.pr.parts]
    assert checkpoint.load_pvector(pt, SerialBackend(4), dtype=np.float32,
                                   device="cpu").dtype == torch.float32


def test_checkpoint_matrix_holds_the_reference_s_arrays(tmp_path):
    """The Q1 FEM Laplacian from disassembled triplets on (2,2) parts:
    the saved arrays equal the reference's file's, and the loaded matrix
    equals the saved one and multiplies alike."""
    I, J, V, rows, cols = laplacian_fem((6, 6), (2, 2))
    A = psparse(I, J, V, rows, cols, SerialBackend(4), device="cpu")
    jI, jJ, jV, jrows, jcols = jgallery.laplacian_fem((6, 6), (2, 2))
    B = jpsparse.psparse(jI, jJ, jV, jp.PRange(jrows), jp.PRange(jcols), JaxSerialBackend(4))
    checkpoint.save_psparse(tmp_path / "A.pt", A)
    jcheckpoint.save_psparse(str(tmp_path / "A.npz"), B)
    _same_files(tmp_path / "A.pt", tmp_path / "A.npz")
    L = checkpoint.load_psparse(tmp_path / "A.pt", SerialBackend(4), device="cpu")
    assert (to_global_scipy(L) != to_global_scipy(A)).nnz == 0
    x = pvector_from_own([li.own_to_global * 0.5 for li in A.col_prange.parts], A.col_prange,
                         A.backend, dtype=np.float64, device="cpu")
    y = pvector_from_own([li.own_to_global * 0.5 for li in L.col_prange.parts], L.col_prange,
                         L.backend, dtype=np.float64, device="cpu")
    np.testing.assert_allclose(collect(spmv(L, y)), collect(spmv(A, x)), rtol=1e-14)


def test_checkpoint_loads_default_to_the_card(tmp_path):
    _, pt, _ = _vector_pair(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(AssertionError, match="CUDA"):
        checkpoint.load_pvector(pt, SerialBackend(4))


def test_profiling_trace_and_annotate_on_the_cpu(tmp_path):
    """``trace`` writes a Chrome trace holding the ``annotate`` regions;
    ``device_memory_stats`` of the CPU is None."""
    with profiling.trace(tmp_path, device="cpu") as prof:
        with profiling.annotate("pat_region"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "pat_region" for e in events)
    assert any(e.key == "pat_region" for e in prof.key_averages())
    assert profiling.device_memory_stats("cpu") is None
    assert profiling.DEFAULT_TRACE_DIR.parts[-2:] == ("build", "torch_trace")
