"""The HPCG V-cycle's level transfer kernels (``csrc/mg_transfer.cu``) on the
card:

- ``restrict_core`` and ``prolong_add_core_`` bit for bit their plain
  versions run on the same CUDA tensors, and the standard-order composition
  (``tests/torch_mg_transfer_cases.py``), at 64^3 -> 32^3 on one part and at
  (2,2,2) x 32^3 -> 16^3, float32 and float64, random padding slots
  included: the coarse core's padding comes out zero, and the prolongation
  leaves every slot but the even points' as it was;
- one ``apply_flat`` launches each kernel ``n_levels - 1`` times
  (``launches.mg_restrict_core``, ``launches.mg_prolong_core``);
- a 50-iteration ``hpcg_cg_flat`` set on the card with the plain versions
  made to raise (a CUDA tensor never reaches them), bit for bit the same set
  with the cycle's transfers through standard order.

Every test is marked ``gpu`` and skips without a CUDA card (decided in the
fixture).  This module imports torch and the port only (no JAX):

    python -m pytest --noconftest -p no:randomly tests/test_torch_mg_transfer_gpu.py -q
"""
from functools import partial

import pytest
import torch

import torch_ghost_core_cases as ghost_cases
import torch_mg_transfer_cases as cases
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat
from partitionedarrays_tpu_torch.ops import mg_transfer
from partitionedarrays_tpu_torch.ops.mg_transfer import (
    prolong_add_core_, prolong_add_core_plain_, restrict_core, restrict_core_plain,
)
from partitionedarrays_tpu_torch.parallel.exchange_plan import core_slot
from partitionedarrays_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

# (local box, parts): the fine level of each pair, with its coarse level below
PAIRS = [(64, (1, 1, 1)), (32, (2, 2, 2))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _live(gs, device):
    """True at the core slots of level ``gs`` that hold an own point."""
    col = gs.colored
    live = torch.zeros(col.m * col.Lq, dtype=torch.bool, device=device)
    live[core_slot(torch.arange(col.R, device=device), (col.m, col.Lq))] = True
    return live


@pytest.mark.parametrize("dtype", ghost_cases.DTYPES)
@pytest.mark.parametrize("n, parts", PAIRS)
def test_restrict_core_kernel_equals_plain(cuda, n, parts, dtype):
    mg = ghost_cases.build_mg(n, parts, dtype, device=cuda, levels=2)
    fine, coarse = mg.gss[1], mg.gss[0]
    rd = cases.random_core(fine, 3, dtype, cuda)
    core = (coarse.colored.m, coarse.colored.Lq)
    before = profiling.launches("mg_restrict_core")
    got = restrict_core(rd, mg.level_shapes[1], core)
    assert profiling.launches("mg_restrict_core") == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, restrict_core_plain(rd, mg.level_shapes[1], core))
    assert torch.equal(got, cases.std_restrict(mg, 1, rd))
    assert not got.reshape(got.shape[0], -1)[:, ~_live(coarse, cuda)].any()


@pytest.mark.parametrize("dtype", ghost_cases.DTYPES)
@pytest.mark.parametrize("n, parts", PAIRS)
def test_prolong_add_core_kernel_equals_plain(cuda, n, parts, dtype):
    mg = ghost_cases.build_mg(n, parts, dtype, device=cuda, levels=2)
    fine, coarse = mg.gss[1], mg.gss[0]
    xflat = cases.random_core(fine, 4, dtype, cuda)
    xc = cases.random_core(coarse, 5, dtype, cuda)
    got = xflat.clone()
    before = profiling.launches("mg_prolong_core")
    assert prolong_add_core_(got, xc, mg.level_shapes[1]) is got
    assert profiling.launches("mg_prolong_core") == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, prolong_add_core_plain_(xflat.clone(), xc, mg.level_shapes[1]))
    assert torch.equal(got, cases.std_prolong_add(mg, 1, xflat, xc))
    # the even points moved, every other slot (odd points, padding) kept its bits
    P = xflat.shape[0]
    even = torch.zeros(P, fine.colored.m * fine.colored.Lq, dtype=torch.bool, device=cuda)
    even[:, mg_transfer._slots(mg.level_shapes[1], (fine.colored.m, fine.colored.Lq),
                               (coarse.colored.m, coarse.colored.Lq), cuda)[1]] = True
    flat, flat0 = got.view(P, -1), xflat.view(P, -1)
    assert torch.equal(flat[~even], flat0[~even])
    assert bool((flat[even] != flat0[even]).any())


@pytest.mark.parametrize("n, parts", [(32, (1, 1, 1)), (16, (2, 2, 2))])
def test_apply_flat_launches_each_transfer_per_level_pair(cuda, n, parts):
    mg = ghost_cases.build_mg(n, parts, torch.float64, device=cuda, levels=4)
    bd = mg.gss[-1].make_bd(ghost_cases.random_rhs(mg, 6))
    mg.apply_flat(bd)  # warm
    profiling.reset_counts()
    mg.apply_flat(bd)
    assert profiling.launches("mg_restrict_core") == mg.n_levels - 1
    assert profiling.launches("mg_prolong_core") == mg.n_levels - 1


@pytest.mark.parametrize("dtype", ghost_cases.DTYPES)
@pytest.mark.parametrize("n, parts", [(32, (1, 1, 1)), (16, (2, 2, 2))])
def test_set_on_the_card_never_takes_the_plain_transfers(cuda, n, parts, dtype, monkeypatch):
    mg = ghost_cases.build_mg(n, parts, dtype, device=cuda, levels=4)
    b = ghost_cases.random_rhs(mg, 7)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain transfer")

    with monkeypatch.context() as patch:
        patch.setattr(mg_transfer, "restrict_core_plain", refuse)
        patch.setattr(mg_transfer, "prolong_add_core_plain_", refuse)
        x, norms = hpcg_cg_flat(mg, b, iterations=50)
    monkeypatch.setattr(mg, "_vcycle", partial(cases.std_vcycle, mg))
    x_want, n_want = hpcg_cg_flat(mg, b, iterations=50)
    torch.cuda.synchronize()
    assert torch.equal(norms, n_want)
    assert torch.equal(x.own, x_want.own)
    assert float(norms[-1] / norms[0]) < 1e-4
