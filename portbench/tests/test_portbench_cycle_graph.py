"""``cycle_graph_pct.amg`` on synthetic spans (the program's spans
replaced): the share of the tagged level-0 ``amg.cycle`` spans replayed
from the captured CUDA graph, None without spans or without tags."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_portbench_spans import KERNELS, _read, _span  # noqa: E402


def _cycles(*tags):
    """One solve whose level-0 cycles carry ``tags`` (None: no tag, as a
    program without the graph records them), each with a level-1 child."""
    recorded = [_span("cg", 100, 900)]
    for k, tag in enumerate(tags):
        a = 150 + 100 * k
        attrs = {"level": 0} if tag is None else {"level": 0, "graph": tag}
        recorded.append(_span("amg.cycle", a, a + 50, parent=0, **attrs))
        recorded.append(_span("amg.cycle", a + 10, a + 20, parent=len(recorded) - 1, level=1))
    return recorded


@pytest.mark.parametrize("tags, want", [
    (("replay",) * 4, 100.0),
    (("eager", "capture", "replay", "replay"), 50.0),
    (("eager",) * 3, 0.0),
    ((), None),
    ((None, None), None),
], ids=["all_replayed", "half", "none_replayed", "no_spans", "untagged"])
def test_cycle_graph_pct(tmp_path, monkeypatch, tags, want):
    recorded = _cycles(*tags) if tags else None
    got, _ = _read(tmp_path, monkeypatch, "amg_elasticity.40", KERNELS, recorded,
                   ("cycle_graph_pct.amg",))
    assert got["cycle_graph_pct.amg"] == want
