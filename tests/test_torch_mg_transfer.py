"""The HPCG V-cycle's core-to-core level transfers (``ops/mg_transfer.py``)
on the CPU, where the wrappers take the plain versions: ``restrict_core``
against ``_restrict`` + ``make_bd`` and ``prolong_add_core_`` against
``_prolong`` + ``flat_add_std`` (``tests/torch_mg_transfer_cases.py``), bit
for bit, on the level pairs 32^3 -> 16^3 and 16^3 -> 8^3 of one part and of
(2,2,2) parts in float64 and float32, random padding slots included; a
50-iteration ``hpcg_cg_flat`` set against the same set with the cycle's
transfers through standard order; and the wrappers' refusals."""
from functools import lru_cache, partial

import pytest
import torch

import torch_ghost_core_cases as ghost_cases
import torch_mg_transfer_cases as cases
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat
from partitionedarrays_tpu_torch.ops.mg_transfer import prolong_add_core_, restrict_core
from partitionedarrays_tpu_torch.parallel.exchange_plan import core_slot

PARTS = [(1, 1, 1), (2, 2, 2)]
LEVELS = [2, 1]  # the fine level of the pairs 32^3 -> 16^3 and 16^3 -> 8^3


@lru_cache(maxsize=None)
def _mg(parts, dtype):
    return ghost_cases.build_mg(32, parts, dtype, levels=3)


def _padding(gs):
    """The core slots of level ``gs`` that hold no own point."""
    col = gs.colored
    live = torch.zeros(col.m * col.Lq, dtype=torch.bool)
    live[core_slot(torch.arange(col.R), (col.m, col.Lq))] = True
    return ~live


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("dtype", ghost_cases.DTYPES)
@pytest.mark.parametrize("parts", PARTS)
def test_restrict_core_equals_std_composition(parts, dtype, level):
    mg = _mg(parts, dtype)
    fine, coarse = mg.gss[level], mg.gss[level - 1]
    rd = cases.random_core(fine, 30 + level, dtype)
    rd_before = rd.clone()
    got = restrict_core(rd, mg.level_shapes[level], (coarse.colored.m, coarse.colored.Lq))
    assert torch.equal(got, cases.std_restrict(mg, level, rd))
    assert torch.equal(rd, rd_before)
    pad = _padding(coarse)
    assert pad.any() and not got.reshape(got.shape[0], -1)[:, pad].any()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("dtype", ghost_cases.DTYPES)
@pytest.mark.parametrize("parts", PARTS)
def test_prolong_add_core_equals_std_composition(parts, dtype, level):
    mg = _mg(parts, dtype)
    fine, coarse = mg.gss[level], mg.gss[level - 1]
    xflat = cases.random_core(fine, 40 + level, dtype)
    xc = cases.random_core(coarse, 50 + level, dtype)
    want = cases.std_prolong_add(mg, level, xflat, xc)
    got = xflat.clone()
    out = prolong_add_core_(got, xc, mg.level_shapes[level])
    assert out is got  # in place
    assert torch.equal(got, want)
    # the odd points and the padding keep their values; the even points moved
    moved = (got != xflat).reshape(-1)
    assert moved.any() and int(moved.sum()) <= xc.shape[0] * coarse.colored.R


@pytest.mark.parametrize("dtype", ghost_cases.DTYPES)
@pytest.mark.parametrize("parts, n", [((1, 1, 1), 32), ((2, 2, 2), 16)])
def test_cg_equals_std_transfers(parts, n, dtype, monkeypatch):
    mg = ghost_cases.build_mg(n, parts, dtype, levels=4)
    b = ghost_cases.random_rhs(mg, 9)
    x, norms = hpcg_cg_flat(mg, b, iterations=50)
    monkeypatch.setattr(mg, "_vcycle", partial(cases.std_vcycle, mg))
    x_want, n_want = hpcg_cg_flat(mg, b, iterations=50)
    assert torch.equal(norms, n_want)
    assert torch.equal(x.own, x_want.own)
    assert float(norms[-1] / norms[0]) < 1e-3  # it converges


def test_wrappers_refuse_what_they_do_not_take():
    mg = _mg((1, 1, 1), torch.float64)
    fine, coarse = mg.gss[2].colored, mg.gss[1].colored
    rd = torch.zeros(1, fine.m, fine.Lq, dtype=torch.float64)
    xc = torch.zeros(1, coarse.m, coarse.Lq, dtype=torch.float64)
    box = mg.level_shapes[2]
    with pytest.raises(ValueError, match="not even"):
        restrict_core(rd, (31, 32, 32), (coarse.m, coarse.Lq))
    with pytest.raises(ValueError, match="box"):
        restrict_core(rd, (64, 64, 64), (coarse.m, coarse.Lq))
    with pytest.raises(ValueError, match="core"):
        restrict_core(rd[0], box, (coarse.m, coarse.Lq))
    with pytest.raises(TypeError, match="float32"):
        prolong_add_core_(rd, xc.float(), box)
    with pytest.raises(ValueError, match="cores"):
        prolong_add_core_(rd, xc.expand(2, -1, -1), box)
    with pytest.raises(ValueError, match="no kernel"):
        prolong_add_core_(rd.to("meta"), xc.to("meta"), box)
