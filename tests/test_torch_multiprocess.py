"""The port's multi-process tier on the CPU: the counterpart of
``tests/test_multihost.py``.  Separate OS processes join a gloo group
through ``with_multihost`` (``tests/torch_multiprocess_driver.py``); each
holds only its own parts and checks its shards against scipy and against
the port's single-process run of the same problem (the same iteration
counts, x within 1e-9 relative in float64).  This process holds that
single-process run to the JAX package's ``SerialBackend`` run of the same
P.  An injected failure on one rank must end every rank nonzero, and none
may hang.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.gallery import laplacian_fem as jax_laplacian_fem
from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem as jax_build_hpcg
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.psparse import psparse as jax_psparse
from partitionedarrays_tpu.psparse import spmv as jax_spmv
from partitionedarrays_tpu.pvector import collect as jax_collect
from partitionedarrays_tpu.pvector import pones as jax_pones
from partitionedarrays_tpu.pvector import pvector_from_own as jax_pvector_from_own
from partitionedarrays_tpu.solvers.amg import AMGParams as JaxAMGParams
from partitionedarrays_tpu.solvers.amg import AMGPreconditioner as JaxAMGPreconditioner
from partitionedarrays_tpu.solvers.krylov import cg as jax_cg
from partitionedarrays_tpu.solvers.smoothers import GaussSeidel as JaxGaussSeidel

from partitionedarrays_tpu_torch.backends import MeshBackend, SerialBackend, stack_parts, with_mesh
from partitionedarrays_tpu_torch.models.gallery import laplacian_fem
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.parallel.host_exchange import (allgather_part_arrays,
                                                                exchange_part_messages)
from partitionedarrays_tpu_torch.parallel.partition import PRange
from partitionedarrays_tpu_torch.psparse import psparse, psparse_local, spmv, to_global_scipy
from partitionedarrays_tpu_torch.pvector import collect, pdot, pones, pvector_from_own
from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
from partitionedarrays_tpu_torch.solvers.krylov import cg
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

jax_config.use_pallas = False

DRIVER = os.path.join(os.path.dirname(__file__), "torch_multiprocess_driver.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 60  # seconds a rank may take

# the two-process run: every mode in one group of 2 ranks holding 4 parts
TWO = dict(P=4, n=6, parts="1,1,4", fem_nodes="65,65", amg_nodes="17,17", hpcg_n=4,
           hpcg_parts="1,1,4", hpcg_levels=2, hpcg_iterations=5)
# the four-process run: 8 parts on a (4, 2) grid, edge and corner neighbours
FOUR = dict(P=8, n=4, parts="2,2,2", fem_nodes="31,31", fem_grid="4,2", amg_nodes="17,17",
            amg_grid="4,2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Group:
    """The driver started in ``nproc`` processes; ``result()`` waits for
    them and returns (exit codes, outputs, parsed results)."""

    def __init__(self, nproc: int, modes: str, **kw):
        env = dict(os.environ)
        env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
        port = _free_port()
        args = [f"{k}={v}" for k, v in kw.items()]
        self.procs = [subprocess.Popen([sys.executable, DRIVER, str(r), str(nproc), str(port),
                                        modes, *args], env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                      for r in range(nproc)]
        self.start = time.monotonic()
        self._result = None

    def result(self):
        if self._result is None:
            codes, outs, results = [], [], []
            for p in self.procs:
                try:
                    out, _ = p.communicate(
                        timeout=max(LIMIT - (time.monotonic() - self.start), 1))
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                    out += "\n<TIMEOUT>"
                codes.append(p.returncode)
                outs.append(out)
                lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
                results.append(json.loads(lines[-1][len("RESULT "):]) if lines else None)
            self._result = (codes, outs, results)
        return self._result


def _ok(group: _Group):
    codes, outs, results = group.result()
    for c, o in zip(codes, outs):
        assert c == 0, f"a rank failed:\n{o[-3000:]}"
    return results


@pytest.fixture(scope="module")
def groups():
    """Every group starts at once and runs while this process computes the
    serial and JAX runs."""
    gs = {"two": _Group(2, "cg,fem,gsslot,amg,hpcg", **TWO),
          "four": _Group(4, "cg,fem,amg", **FOUR),
          "fail": _Group(2, "fail", P=2, timeout=30)}
    yield gs
    for g in gs.values():
        g.result()


@pytest.fixture(scope="module")
def two(groups):
    return _ok(groups["two"])


@pytest.fixture(scope="module")
def four(groups):
    return _ok(groups["four"])


def _port_cg(n, parts):
    A, b = build_hpcg_problem((n, n, n), parts, SerialBackend(int(np.prod(parts))),
                              dtype=np.float64, device="cpu")
    x, info = cg(A, b, M=GaussSeidel(A, 1, "symmetric"), rtol=1e-8, maxiter=500)
    return info.iterations, collect(x)


def _jax_cg(n, parts):
    A, b = jax_build_hpcg((n, n, n), parts, JaxSerialBackend(int(np.prod(parts))),
                          dtype=np.float64)
    x, info = jax_cg(A, b, M=JaxGaussSeidel(A, 1, "symmetric"), rtol=1e-8, maxiter=500)
    return int(info.iterations), np.asarray(jax_collect(x))


@pytest.mark.parametrize("run", ["two", "four"])
def test_multiprocess_cg_matches_serial_and_jax(run, request, groups):
    """The reference driver's main mode: the 27-point problem built per
    process, GS-preconditioned CG with cross-process halo exchanges and
    all-reduced dots; every rank's iterations and shards equal the serial
    run's, which equals the JAX package's."""
    cfg = TWO if run == "two" else FOUR
    parts = tuple(int(v) for v in cfg["parts"].split(","))
    iters, x = _port_cg(cfg["n"], parts)
    iters_j, x_j = _jax_cg(cfg["n"], parts)
    assert iters == iters_j
    np.testing.assert_allclose(x, x_j, rtol=0, atol=1e-10 * np.abs(x_j).max())
    results = request.getfixturevalue(run)
    assert sorted(p for r in results for p in r["parts"]) == list(range(cfg["P"]))
    for r in results:
        assert r["cg"]["iterations"] == iters
        assert r["cg"]["x_vs_serial"] <= 1e-9 and r["cg"]["x_vs_scipy"] <= 1e-6
        assert {"dia_spmv", "gs_sweeps"} <= set(r["cg"]["kernels_vs_plain"])


@pytest.mark.parametrize("run", ["two", "four"])
def test_multiprocess_fem_local_construction(run, request, groups):
    """Each process makes its parts' triplets only; the off-owner ones
    cross processes in padded rounds, whose bytes stay O(surface) (under
    10% of the local triplet bytes at 65^2 nodes); A 1 and ``pvector_local``
    equal the serial build's, which equals the JAX package's."""
    cfg = TWO if run == "two" else FOUR
    nodes = tuple(int(v) for v in cfg["fem_nodes"].split(","))
    grid = tuple(int(v) for v in cfg.get("fem_grid", f"{cfg['P']},1").split(","))
    I, J, V, rows, cols = laplacian_fem(nodes, grid, dtype=np.float32)
    A = psparse(I, J, V, PRange(rows), PRange(cols), SerialBackend(cfg["P"]), device="cpu")
    y = collect(spmv(A, pones(A.col_prange, A.backend, dtype=np.float32, device="cpu")))
    Ij, Jj, Vj, rj, cj = jax_laplacian_fem(nodes, grid, dtype=np.float32)
    Aj = jax_psparse(Ij, Jj, Vj, JaxPRange(rj), JaxPRange(cj), JaxSerialBackend(cfg["P"]))
    y_j = np.asarray(jax_collect(jax_spmv(Aj, jax_pones(Aj.col_prange, Aj.backend,
                                                        dtype=np.float32))))
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-6)
    results = request.getfixturevalue(run)
    for r in results:
        fem = r["fem"]
        assert fem["cross_msgs"] > 0 and fem["rounds"] >= 1
        assert fem["Ax_vs_serial"] <= 1e-6 and fem["Ax_vs_scipy"] <= 1e-5
        assert fem["b_vs_Ax"] <= 1e-6
        if min(nodes) >= 65:
            assert fem["wire_frac"] < 0.10
    if run == "four":
        # edge and corner neighbours: the ranks' messages differ in size
        assert len({r["fem"]["wire_bytes"] for r in results}) > 1


def test_multiprocess_wave_tile_gs_agreed_dims(two):
    """An operator without a DIA band takes the wave tile GS on every
    process with the same wave count and cluster width (agreed), although
    one process's parts have no off-tile coupling; each part's sweep is
    scipy's triangular solve in its wave-major order and the serial
    sweep."""
    WB = {(r["gsslot"]["W"], r["gsslot"]["B"]) for r in two}
    assert len(WB) == 1 and next(iter(WB))[1] > 1
    for r in two:
        assert r["gsslot"]["z_vs_scipy"] <= 1e-12 and r["gsslot"]["z_vs_serial"] <= 1e-12


def _jax_amg_iterations(nodes, grid):
    I, J, V, rows, cols = jax_laplacian_fem(nodes, grid, dtype=np.float64)
    P = int(np.prod(grid))
    A = jax_psparse(I, J, V, JaxPRange(rows), JaxPRange(cols), JaxSerialBackend(P))
    M = JaxAMGPreconditioner(A, JaxAMGParams(coarse_size=12, max_levels=3, epsilon=0.02))
    n = A.shape[0]
    xg = np.random.default_rng(0).standard_normal(n)
    G = sp.csr_matrix((np.concatenate(V), (np.concatenate(I), np.concatenate(J))), shape=(n, n))
    pr = A.row_prange
    b = jax_pvector_from_own([(G @ xg)[li.own_to_global] for li in pr.partition()], pr,
                             A.backend, dtype=np.float64)
    _, info = jax_cg(A, b, M=M, rtol=1e-8, maxiter=200)
    return int(info.iterations), [lev.A.shape[0] for lev in M.levels]


def _port_amg_iterations(nodes, grid):
    I, J, V, rows, cols = laplacian_fem(nodes, grid, dtype=np.float64)
    P = int(np.prod(grid))
    A = psparse(I, J, V, PRange(rows), PRange(cols), SerialBackend(P), device="cpu")
    M = AMGPreconditioner(A, AMGParams(coarse_size=12, max_levels=3, epsilon=0.02))
    n = A.shape[0]
    xg = np.random.default_rng(0).standard_normal(n)
    G = sp.csr_matrix((np.concatenate(V), (np.concatenate(I), np.concatenate(J))), shape=(n, n))
    pr = A.row_prange
    b = pvector_from_own([(G @ xg)[li.own_to_global] for li in pr.parts], pr, A.backend,
                         device="cpu")
    _, info = cg(A, b, M=M, rtol=1e-8, maxiter=200)
    return info.iterations, [lev.A.shape[0] for lev in M.levels]


@pytest.mark.parametrize("run", ["two", "four"])
def test_multiprocess_amg_setup_and_update(run, request, groups):
    """The per-process AMG: aggregation and the Galerkin products on each
    process's parts (the products' rows and the refill routes cross
    processes), AMG-CG, one ``update`` for 2 A that reuses the aggregates
    and refills through the routes, and the CG after it: the hierarchy and
    iterations of the serial run, which are the JAX package's, and x
    within 1e-9 of the serial x."""
    cfg = TWO if run == "two" else FOUR
    nodes = tuple(int(v) for v in cfg["amg_nodes"].split(","))
    grid = tuple(int(v) for v in cfg.get("amg_grid", f"{cfg['P']},1").split(","))
    iters, levels = _port_amg_iterations(nodes, grid)
    assert (iters, levels) == _jax_amg_iterations(nodes, grid)
    results = request.getfixturevalue(run)
    for r in results:
        amg = r["amg"]
        assert amg["iterations"] == iters and amg["levels"] == levels
        assert amg["iterations_update"] == iters  # 2 A x = b: the same Krylov space
        for key in ("x_vs_serial", "x_update_vs_serial", "spmm_into_vs_serial"):
            assert amg[key] <= 1e-9, key
        assert amg["x_vs_exact"] <= 1e-5 and amg["x_update_vs_exact"] <= 1e-5


def test_multiprocess_hpcg_benchmark_mpi(two):
    """``hpcg_benchmark_mpi`` over two processes: the serial benchmark's
    residual history."""
    for r in two:
        assert r["hpcg"]["relres_vs_serial"] <= 1e-9 and r["hpcg"]["nrow"] == 4 ** 3 * 4


def test_multiprocess_failure_propagates(groups):
    """An exception on rank 1 ends every rank nonzero within the limit, none
    hangs (the reference's ``with_mpi`` -> ``MPI.Abort``)."""
    codes, outs, _ = groups["fail"].result()
    assert codes[1] != 0, "the failing rank must exit nonzero"
    assert codes[0] != 0, "the healthy rank must be torn down:\n" + outs[0][-2000:]
    assert not any("<TIMEOUT>" in o for o in outs), "a rank hung"
    assert "injected failure on rank 1" in outs[1]


def test_mesh_backend_in_one_process_is_the_serial_backend():
    """Without a process group a mesh backend holds every part: the same
    solve as the serial backend, bit for bit, and the host exchanges pass
    their messages through."""
    runs = []
    for bk in (SerialBackend(4), with_mesh(lambda b: b, 4)):
        assert bk.local_parts() == [0, 1, 2, 3] and not bk.is_multiprocess
        A, b = build_hpcg_problem((4, 4, 4), (1, 2, 2), bk, dtype=np.float64, device="cpu")
        x, info = cg(A, b, M=GaussSeidel(A, 1, "symmetric"), rtol=1e-8)
        runs.append((info.iterations, collect(x), float(pdot(x, x))))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2]
    bk = MeshBackend(2)
    assert bk.rank_of(1) == 0 and bk.part_slice == slice(0, 2)
    msgs = {(0, 1): (np.arange(3),), (1, 0): (np.ones(2),)}
    stats = {}
    assert exchange_part_messages(bk, 2, msgs, (np.float64,), stats=stats) == msgs
    assert stats == dict(wire_bytes=0, wire_entries=0, n_rounds=0, cross_msgs=0)
    got = allgather_part_arrays(bk, 3, {0: np.arange(2), 2: np.arange(1)}, np.int64)
    assert [g.tolist() for g in got] == [[0, 1], [], [0]]
    assert stack_parts([np.ones(2), np.ones(3)]).shape == (2, 3)


def test_psparse_local_in_one_process_equals_psparse():
    """``psparse_local`` with every part local is the COO constructor: the
    same blocks, bit for bit, the wire untouched, and the matrix complete
    (the host setup operations take it)."""
    I, J, V, rows, cols = laplacian_fem((9, 9), (2, 2), dtype=np.float64)
    bk = SerialBackend(4)
    A = psparse(I, J, V, PRange(rows), PRange(cols), bk, device="cpu")
    B = psparse_local(I, J, V, PRange(rows), PRange(cols), bk, device="cpu")
    assert bk._last_local_build_stats["wire_bytes"] == 0
    assert (to_global_scipy(B) != to_global_scipy(A)).nnz == 0
    for ba, bb in zip(A.blocks, B.blocks):
        for k in ("oo", "oh"):
            assert (ba[k] != bb[k]).nnz == 0 and ba[k].shape == bb[k].shape
    with pytest.raises(ValueError, match="missing"):
        psparse_local([None] + I[1:], J, V, PRange(rows), PRange(cols), bk, device="cpu")


def test_setup_reusing_aggregates_is_live():
    """``AMGPreconditioner._setup(A, reuse_aggregates=True)`` is a new setup
    on the last aggregates (the reference's ``update`` promises it for
    per-process matrices but never takes it: its ``reuse_ok`` is always
    True, ROADMAP Queue 3): the same aggregate arrays, the hierarchy and CG
    of a fresh setup of the new matrix, and ``update`` gives them too."""
    I, J, V, rows, cols = laplacian_fem((17, 17), (4, 1), dtype=np.float64)
    bk = SerialBackend(4)
    A = psparse(I, J, V, PRange(rows), PRange(cols), bk, device="cpu")
    A2 = psparse(I, J, [1.5 * v for v in V], PRange(rows), PRange(cols), bk, device="cpu")
    params = AMGParams(coarse_size=12, max_levels=3, epsilon=0.02)
    b = pones(A.row_prange, bk, dtype=np.float64, device="cpu")
    runs = []
    for how in ("resetup", "update", "fresh"):
        M = AMGPreconditioner(A if how != "fresh" else A2, params)
        aggs = [e[0] for e in M._aggs]
        if how == "resetup":
            M._setup(A2, reuse_aggregates=True)
            assert all(a is e[0] for a, e in zip(aggs, M._aggs))
        elif how == "update":
            M.update(A2)
        x, info = cg(A2, b, M=M, rtol=1e-10)
        runs.append(([lev.A.shape[0] for lev in M.levels], info.iterations, collect(x)))
    assert runs[0][:2] == runs[1][:2] == runs[2][:2]
    for _, _, x in runs[1:]:
        np.testing.assert_allclose(x, runs[0][2], rtol=0, atol=1e-12 * np.abs(x).max())
