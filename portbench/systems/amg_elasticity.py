"""The elasticity AMG-CG configuration on the port.

Set-up loads the port's kernels and its host setup library, assembles
``models/gallery.py::linear_elasticity_fem`` through ``psparse``
(``assembly_s``), builds ``AMGPreconditioner`` with the rigid
body modes as near-nullspace (``amg_setup_s``), and puts the seed's pool
of right-hand sides into the port's layout.  A unit is one solve,
``solvers/krylov.py::cg`` from a zero guess to ``rtol``, timed from its
call to its return with the device synchronised at both ends.  A solve
whose final residual is above ``rtol`` times its right-hand side's norm
(``maxiter`` reached) has failed.
"""
from __future__ import annotations

import numpy as np
import torch

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.gallery import (
    linear_elasticity_fem, node_coordinates_unit_cube, nullspace_linear_elasticity)
from partitionedarrays_tpu_torch.psparse import psparse
from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
from partitionedarrays_tpu_torch.solvers.krylov import cg
from portbench import generator, kernels
from portbench.layout import DTYPES, from_pvector, to_pvector


class System:
    def __init__(self, config, mix, seed, device, clock):
        self.np_dtype, self.dtype = DTYPES[config["dtype"]]
        self.device = device
        nodes = tuple(int(v) for v in config["nodes_per_dir"])
        parts = tuple(int(v) for v in config["parts_per_dir"])
        self.rtol = float(config["rtol"])
        self.maxiter = int(config["maxiter"])
        backend = SerialBackend(int(np.prod(parts)))
        kernels.load(clock, device, native=True)
        with clock("assembly_s"):
            I, J, V, rows, cols = linear_elasticity_fem(
                nodes, parts, E=config["E"], nu=config["nu"], dtype=self.np_dtype)
            self.A = psparse(I, J, V, rows, cols, backend, device=device)
            self.A.device()
        coords, _ = node_coordinates_unit_cube(nodes, parts)
        nullspace = nullspace_linear_elasticity(coords, self.A.row_prange)
        with clock("amg_setup_s"):
            self.M = AMGPreconditioner(self.A, AMGParams(**config["amg"]), nullspace=nullspace)
        self.rhs = generator.rhs_pool(mix, self.A.shape[0], seed, device)
        self.b = [to_pvector(v, self.A, self.dtype) for v in self.rhs]
        self.tol = [self.rtol * float(torch.linalg.vector_norm(b.own.double())) for b in self.b]
        self.iterations, self.converged, self.last_x = {}, {}, {}
        with clock("warm_solve_s"):
            self.unit(0)

    def unit(self, i: int):
        k = i % len(self.b)
        x, info = cg(self.A, self.b[k], M=self.M, rtol=self.rtol, maxiter=self.maxiter)
        residual = float(info.residual)
        self.iterations[i] = int(info.iterations)
        # the solver's own test, on its norm of b, with room for that norm's
        # rounding against this one
        self.converged[i] = bool(np.isfinite(residual) and residual <= self.tol[k] * (1 + 1e-6))
        self.last_x[k] = (i, x)
        return None

    def snapshot(self, units) -> dict:
        """The last solve of each right-hand side in the window (``units``),
        x in global order (float64), and the types of every level's
        operator and stored smoother values."""
        first = units[0]
        stored = [str(lev.A.dtype) for lev in self.M.levels]
        stored += [str(lev.smoother.colored.vals_d.dtype) for lev in self.M.levels
                   if getattr(lev.smoother, "colored", None)]
        return {"x": {k: from_pvector(x, self.A) for k, (i, x) in self.last_x.items()
                      if i >= first}, "stored_dtypes": stored}

    def account(self, units) -> int:
        return sum(not self.converged[i] for i in units)

    def facts(self, units) -> dict:
        levels = []
        for l, lev in enumerate(self.M.levels[:-1]):  # the coarsest is solved directly
            levels.append({
                "rows": int(lev.A.shape[0]), "nnz": int(lev.A.nnz()),
                # the fine operator is a stencil of the structured mesh; the
                # aggregated levels are general sparse
                "banded": l == 0,
                # the configuration's type, not the program's (as in the HPCG cell)
                "value_bytes": self.dtype.itemsize, "vector_bytes": self.dtype.itemsize,
                "applications": [(True, 2), (False, 2)],
            })
        return {
            "iterations": {i: self.iterations[i] for i in units},
            "vcycles": {i: self.iterations[i] + 1 for i in units},
            "levels": levels,
            "vector_bytes": self.dtype.itemsize,
        }

    def reference_inputs(self) -> dict:
        return {"rhs": self.rhs}

    def release(self) -> None:
        self.A = self.M = self.b = self.last_x = None
