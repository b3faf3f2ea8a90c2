"""The PyTorch port never loads JAX.

A fresh interpreter imports the port, builds a small HPCG problem and runs
a short MG-preconditioned CG solve on the CPU; afterwards ``jax`` must not
be among the loaded modules.
"""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat
from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
mg = HPCGMGPreconditioner((8, 8, 8), (1, 1, 1), SerialBackend(1), n_levels=2)
_, norms = hpcg_cg_flat(mg, mg.b, iterations=5)
assert float(norms[-1] / norms[0]) < 1e-3, norms
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("JAX_MODULES", loaded)
sys.exit(1 if loaded else 0)
"""


def test_port_does_not_load_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout
