"""The HPCG V-cycle and CG histories of the PyTorch port against the JAX
reference, in float32 (the cases and their tolerances: ``torch_hpcg_cases.py``;
test_torch_hpcg_cg_f64.py runs them in the other dtype)."""
import numpy as np
import pytest
import torch

import torch_hpcg_cases as cases

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def solved():
    return cases.solve(np.float32)


def test_apply_flat_matches_jax(solved):
    cases.check_apply_flat(solved)


def test_cg_flat_history_matches_jax(solved):
    cases.check_cg_flat_history(solved)


def test_cg_generic_history_matches_jax(solved):
    cases.check_cg_generic_history(solved)


def test_cg_solution_solves_the_system(solved):
    cases.check_cg_solution_solves_the_system(solved)
