"""HPCG on the PyTorch port: 27-point problem, geometric MG, CG, the
three-phase driver and the rating report."""
from .cg import hpcg_cg, hpcg_cg_flat
from .driver import hpcg_benchmark
from .mg import HPCGMGPreconditioner
from .opt3d import compute_optimal_shape_xyz
from .problem import STENCIL_27PT, build_hpcg_problem
from .report import HPCGReport
