"""The HPCG configuration on a grid of parts, on the port.

Set-up loads the port's kernels, builds ``HPCGMGPreconditioner`` on
``parts_per_dir`` parts of ``local_grid`` each, all on the card in one
``SerialBackend``, and puts the seed's right-hand side into the port's
layout.  A unit is one set: ``iterations_per_set`` PCG iterations from a
zero guess through ``hpcg_cg_flat_g``, the CG that
``models/hpcg/driver.py::cg_route`` picks with ghost columns (the ghosted
V-cycle's hybrid Gauss-Seidel, the ghost exchanges and K5); any other route
is refused.  The snapshot, the failed sets (HPCG's ``chain_consistent``),
the stored types and the right-hand sides are the one-part system's;
``facts`` adds each level's own-ghost block from the geometry
(``work_parts.py``, for K5's roofline).  Set-up prints the exchanges and
their bytes of its warm set.
"""
from __future__ import annotations

import sys

import numpy as np

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat_g
from partitionedarrays_tpu_torch.models.hpcg.driver import cg_route
from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
from partitionedarrays_tpu_torch.utils import profiling
from portbench import generator, kernels
from portbench.layout import DTYPES, to_pvector
from portbench.systems import hpcg
from portbench.work_parts import own_ghost


class System(hpcg.System):
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
        if cg_route(self.mg) != "flat_g":
            raise ValueError(f"the HPCG parts cell runs hpcg_cg_flat_g; parts {self.parts} "
                             f"take the route {cg_route(self.mg)!r}")
        A = self.mg.A
        self.rhs = generator.rhs_pool(mix, A.shape[0], seed, device)
        self.b = [to_pvector(v, A, self.dtype) for v in self.rhs]
        self.norms = {}
        self.last = None
        before = dict(profiling.COUNTS)
        with clock("warm_set_s"):
            self.unit(0)
        grew = {k: v - before.get(k, 0) for k, v in profiling.COUNTS.items()
                if k.startswith("exchange") and v != before.get(k, 0)}
        print(f"exchanges of the warm set: {grew}", file=sys.stderr)

    def unit(self, i: int) -> None:
        x, self.norms[i] = hpcg_cg_flat_g(self.mg, self.b[i % len(self.b)],
                                          iterations=self.iterations)
        self.last = (i, x)

    def facts(self, units) -> dict:
        out = super().facts(units)
        # by the ``level`` of the ``ghost`` spans: 0 the coarsest
        out["ghost_levels"] = {
            l: dict(own_ghost([n >> (self.n_levels - 1 - l) for n in self.local], self.parts),
                    value_bytes=self.dtype.itemsize, vector_bytes=self.dtype.itemsize)
            for l in range(self.n_levels)}
        return out
