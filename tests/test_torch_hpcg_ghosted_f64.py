"""The ghosted HPCG V-cycle and CG histories of the PyTorch port against the
JAX reference at (2,2,2) parts, in float64 (the cases and their tolerances:
``torch_hpcg_ghosted_cases.py``; test_torch_hpcg_ghosted_f32.py runs them in
the other dtype)."""
import numpy as np
import pytest
import torch

import torch_hpcg_ghosted_cases as cases

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def solved():
    return cases.solve(np.float64)


def test_vcycle_returns_pvector_matching_jax(solved):
    cases.check_vcycle(solved)


def test_cg_flat_g_history_matches_jax(solved):
    cases.check_cg_flat_g_history(solved)


def test_cg_generic_history_matches_jax(solved):
    cases.check_cg_generic_history(solved)
