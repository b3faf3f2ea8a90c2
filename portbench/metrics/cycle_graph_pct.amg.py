"""The share of the traced solves' V-cycles replayed from the port's
captured CUDA graph: of the level-0 ``amg.cycle`` spans that
``AMGPreconditioner.__call__`` tagged with ``graph`` ("eager", "capture"
or "replay"), those tagged "replay", in %.  None where the program
recorded no such span (a program without the graph tags none)."""
from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None:
        return None
    tags = [st.span[i].attrs["graph"] for i in st.named("amg.cycle")
            if st.span[i].attrs.get("level") == 0 and "graph" in st.span[i].attrs]
    if not tags:
        return None
    return 100.0 * tags.count("replay") / len(tags)
