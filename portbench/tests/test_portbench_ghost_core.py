"""``ghost_core_pct.hpcg_parts`` on synthetic spans (the program's spans
replaced): the share of the ``ghost`` spans tagged ``layout="core"``, None
without spans or without the tag."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_portbench_spans import KERNELS, _read, _span  # noqa: E402

CELL = "hpcg.parts8x128"


def _set(*layouts):
    """One set whose ghost couplings carry ``layouts`` (None: no tag, as a
    program before the core coupling records them), each with its
    exchange."""
    recorded = [_span("hpcg.cg", 100, 900)]
    for k, layout in enumerate(layouts):
        a = 110 + 10 * k
        attrs = {"level": 1} if layout is None else {"level": 1, "layout": layout}
        recorded.append(_span("ghost", a, a + 8, parent=0, **attrs))
        recorded.append(_span("exchange", a + 1, a + 3, parent=len(recorded) - 1,
                              combine="set"))
    return recorded


@pytest.mark.parametrize("layouts, want", [
    (("core",) * 7 + ("std",), 87.5),  # as a set of hpcg.parts8x128: 356 of 407 a set
    (("core",) * 3, 100.0),
    (("std",) * 2, 0.0),
    ((), None),
    ((None,) * 4, None),
], ids=["cell_share", "all_core", "all_std", "no_spans", "untagged"])
def test_ghost_core_pct(tmp_path, monkeypatch, layouts, want):
    recorded = _set(*layouts) if layouts else None
    got, _ = _read(tmp_path, monkeypatch, CELL, KERNELS, recorded,
                   ("ghost_core_pct.hpcg_parts",))
    assert got["ghost_core_pct.hpcg_parts"] == want
