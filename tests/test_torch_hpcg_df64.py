"""The df64 HPCG of the PyTorch port against the JAX reference on one part
at 16^3 (cases and tolerances in ``tests/torch_hpcg_df64_cases.py``)."""
import pytest
import torch

import torch_hpcg_df64_cases as cases

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def solved():
    return cases.solve((16, 16, 16), (1, 1, 1))


def test_cg_df64_with_mg_matches_jax(solved):
    cases.check_cg_df64_with_mg(solved)


def test_cg_df64_identity_keeps_both_words(solved):
    cases.check_cg_df64_identity_keeps_both_words(solved)


def test_benchmark_df64_matches_jax(solved):
    cases.check_benchmark_df64(solved)
