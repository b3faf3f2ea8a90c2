"""The share of the traced sets' ghost couplings run in the core layout:
of the ``ghost`` spans that ``solvers/smoothers.py::GaussSeidel`` tagged with
``layout`` ("core": ``ghost_couple_core``, x gathered from and the product
added into the de-interleaved core; "std": ``ghost_contrib``, standard
order), those tagged "core", in %.  None where the program recorded no such
span (a program without the tag tags none)."""
from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None:
        return None
    tags = [st.span[i].attrs["layout"] for i in st.named("ghost")
            if "layout" in st.span[i].attrs]
    if not tags:
        return None
    return 100.0 * tags.count("core") / len(tags)
