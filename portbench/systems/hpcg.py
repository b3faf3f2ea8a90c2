"""The HPCG configuration on the port.

Set-up loads the port's kernels, builds ``HPCGMGPreconditioner`` (the
27-point operator of ``ops/stencil.py::stencil_psparse`` and the colored
symmetric Gauss-Seidel on every level) and puts the seed's right-hand side
into the port's layout.  A unit is one set: ``iterations_per_set`` PCG
iterations from a zero guess through ``hpcg_cg_flat``, the CG that
``models/hpcg/driver.py::cg_route`` picks for one part (the only layout
the reference judges).  A set whose residual history leaves the first
set's (HPCG's ``chain_consistent`` rule, rtol 1e-4) has failed.
"""
from __future__ import annotations

import numpy as np

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat
from partitionedarrays_tpu_torch.models.hpcg.driver import cg_route
from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
from portbench import generator, kernels
from portbench.hpcg_flops import flops, stencil27_nnz
from portbench.layout import DTYPES, from_pvector, to_pvector

CHAIN_RTOL = 1e-4


class System:
    def __init__(self, config, mix, seed, device, clock):
        self.np_dtype, self.dtype = DTYPES[config["dtype"]]
        self.device = device
        self.local = tuple(int(v) for v in config["local_grid"])
        self.parts = tuple(int(v) for v in config["parts_per_dir"])
        self.n_levels = int(config["levels"])
        self.iterations = int(config["iterations_per_set"])
        backend = SerialBackend(int(np.prod(self.parts)))
        kernels.load(clock, device)
        with clock("mg_build_s"):
            self.mg = HPCGMGPreconditioner(self.local, self.parts, backend, n_levels=self.n_levels,
                                           dtype=self.np_dtype, device=device)
        if cg_route(self.mg) != "flat":
            raise ValueError(f"the HPCG cell runs one part on hpcg_cg_flat; parts "
                             f"{self.parts} take the route {cg_route(self.mg)!r}")
        A = self.mg.A
        self.rhs = generator.rhs_pool(mix, A.shape[0], seed, device)
        self.b = [to_pvector(v, A, self.dtype) for v in self.rhs]
        self.norms = {}
        self.last = None
        with clock("warm_set_s"):
            self.unit(0)

    def unit(self, i: int) -> None:
        x, self.norms[i] = hpcg_cg_flat(self.mg, self.b[i % len(self.b)],
                                        iterations=self.iterations)
        self.last = (i, x)

    def snapshot(self, units) -> dict:
        """The last set of the window (``units``): its x (global order,
        float64), its residual history, its right-hand side's index, and
        the types the operators and smoothers store their values in."""
        i, x = self.last
        return {"x": from_pvector(x, self.mg.A), "norms": self.norms[i].double().cpu(),
                "rhs_index": i % len(self.b), "stored_dtypes": self.stored_dtypes()}

    def stored_dtypes(self) -> list:
        """The types of every level's operator and stored smoother values."""
        mg = self.mg
        out = [str(A.dtype) for A in mg.As]
        out += [str(g.colored.vals_d.dtype) for g in mg.gss if getattr(g, "colored", None)]
        return out

    def account(self, units) -> int:
        """Sets whose history is not finite or leaves that of the first set
        on the same right-hand side."""
        pool = len(self.b)
        first = {}
        for i in sorted(self.norms):
            if i % pool not in first:
                first[i % pool] = self.norms[i].double().cpu().numpy()
        failed = 0
        for i in units:
            h = self.norms[i].double().cpu().numpy()
            ok = np.isfinite(h).all() and np.isclose(h, first[i % pool], rtol=CHAIN_RTOL,
                                                     atol=0).all()
            failed += int(not ok)
        return failed

    def facts(self, units) -> dict:
        shapes = [tuple(p * (n >> l) for p, n in zip(self.parts, self.local))
                  for l in range(self.n_levels)]  # finest first
        nnz = [stencil27_nnz(s) for s in shapes]
        # the configuration's type, not the program's: a program that stores
        # narrower values is held to the work of the stated precision
        value_bytes = vector_bytes = self.dtype.itemsize
        levels = []
        for l, s in enumerate(shapes):
            coarsest = l == self.n_levels - 1
            levels.append({
                "rows": int(np.prod(s)), "nnz": nnz[l], "banded": True,
                "value_bytes": value_bytes, "vector_bytes": vector_bytes,
                # a zero-guess symmetric sweep before the coarser level, one
                # after it; the coarsest level smooths only
                "applications": [(True, 2)] if coarsest else [(True, 2), (False, 2)],
            })
        return {
            "flops_per_unit": flops(int(np.prod(shapes[0])), nnz[0], nnz[::-1], self.iterations,
                                    1)["total"],
            "vcycles": {i: self.iterations + 1 for i in units},
            "levels": levels,
            "vector_bytes": vector_bytes,
        }

    def reference_inputs(self) -> dict:
        return {"rhs": self.rhs}

    def release(self) -> None:
        self.mg = self.b = self.norms = self.last = None
