#!/usr/bin/env python3
"""Time K4 (``ax_core``) of two checkouts of the port on one card, in
turns, or of design variants of one checkout.

    python3 scripts/k4_ab.py BEFORE_DIR AFTER_DIR [--out FILE]
    python3 scripts/k4_ab.py --variants TREE_DIR [--out FILE]

Each directory holds a checkout of the repository (e.g. a ``git archive``
of the parent commit unpacked under ``build/``).  Every timing runs in a
process of its own, which builds its checkout's kernels (``_build.build``)
and times K4 on every level of the one-part 128^3 HPCG hierarchy (4
levels) for every (values, vectors) pair: float32, float64, bfloat16
values under float32 and float64 vectors, float32 values under float64
vectors.  Values: the level's operator scaled by a random factor in
[0.5, 1) per entry, from a fixed seed, stored in the values' dtype; x
random from the same seed.  Per row, under the wrapper's own plan: the
mean of CUDA events around 50 calls back to back (``ms``; at the coarse
levels that is the host's rate of calls, not the kernel's), the kernel's
device time per call from torch.profiler over 20 calls back to back
(``device_ms``: operands hot in the L2 where they fit, as on the path
after the smoother), the mean of CUDA events around single calls with the
L2 flushed before each (``ms_flushed``), and the bound (values once, x
once, out once, at 3.35 TB/s).

A/B: the checkouts run in the order BEFORE, AFTER, AFTER, BEFORE, so that
a drift of the card's clock falls on both alike; prints a line per
process, the card's name and power limit, and AFTER against BEFORE (each
the mean of its two processes).

``--variants``: copies of TREE's package under ``TREE/build/k4_variants/``,
each with one edit of ``VARIANTS`` applied to its CUDA sources, and the
unedited tree; each is timed under every lane count (``device_ms`` and
``ms_flushed`` per lane count).  Two variants are diagnostics whose
results are wrong by design: they drop the x gather or the value stream to
show what each costs.  ``--out`` writes every row to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
LOCAL = (128, 128, 128)
LEVELS = 4
PAIRS = (
    ("float32", "float32"), ("bfloat16", "float32"),
    ("float64", "float64"), ("bfloat16", "float64"), ("float32", "float64"),
)
LANES = (1, 2, 4, 8, 16)
_X_LOADS = """    const int j = d < n_off ? taps[d] + i : -VEC;
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      xv[k][v] = (unsigned)(j + v) < (unsigned)n ? x[j + v] : T(0);"""
# name: (source file under csrc/, text, replacement)
VARIANTS = {
    # 8 taps of a lane in flight, as K2's and K3's single lanes
    "chunk8": ("gs_dia.cu", "constexpr int kAxChunk = 4;", "constexpr int kAxChunk = 8;"),
    # x by two aligned vector loads and a shift per tap instead of VEC
    # loads by element
    "x_vector": ("dia_rows.cuh", _X_LOADS, """    T lo[VEC], hi[VEC];
    int r = 0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) lo[v] = hi[v] = T(0);
    if (d < n_off) {
      const int j = taps[d] + i;
      r = j & (VEC - 1);
      const int a = j - r;
      if ((unsigned)a < (unsigned)n) load_rw(x + a, lo);
      if (r && (unsigned)(a + VEC) < (unsigned)n) load_rw(x + a + VEC, hi);
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      T o = lo[v];
#pragma unroll
      for (int s = 1; s < VEC; ++s) o = r == s ? (v + s < VEC ? lo[(v + s) % VEC] : hi[(v + s) % VEC]) : o;
      xv[k][v] = o;
    }"""),
    # diagnostic: every tap reads x at the thread's own rows (no gather)
    "no_x_gather": ("dia_rows.cuh", "? x[j + v] : T(0);", "? x[i + v] : T(0);"),
    # diagnostic: every tap reads the values of tap 0 (no value stream)
    "no_value_stream": ("dia_rows.cuh", "      load_ro(vals + d * ld + i, vv[k]);",
                        "      load_ro(vals + i, vv[k]);"),
}


def _events_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _flushed_ms(fn, reps: int) -> float:
    import torch

    scratch = torch.ones(128 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        scratch.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def _device_ms(fn, reps: int):
    """Device time of one ``fn()`` from torch.profiler: the kernels' total
    over ``reps`` calls, divided by the calls (None if the profiler kept no
    device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        if events:
            return sum(e.self_device_time_total / e.count for e in events) / 1e3
    return None


def worker(tree: str, lanes: bool) -> None:
    """Time K4 of the checkout at ``tree`` (run in its own process)."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch import _build
    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
    from partitionedarrays_tpu_torch.ops import gs_dia_kernels as k

    assert k.__file__.startswith(os.path.abspath(tree)), k.__file__
    _build.library()
    if lanes:
        from partitionedarrays_tpu_torch.ops.dia_rows import AxPlan
    dev = torch.device("cuda", 0)
    rows = []
    for vectors in ("float32", "float64"):
        mg = HPCGMGPreconditioner(LOCAL, (1, 1, 1), SerialBackend(1), n_levels=LEVELS,
                                  dtype=getattr(np, vectors), device=dev)
        for l, gs in enumerate(reversed(mg.gss)):
            col = gs.colored
            P, m, n_off, Lq = col.vals_d.shape
            g = torch.Generator().manual_seed(100 + l)
            dtype = getattr(torch, vectors)
            scale = 0.5 + 0.5 * torch.rand(col.vals_d.shape, generator=g, dtype=dtype)
            x = torch.randn(P, m, Lq, generator=g, dtype=dtype).to(dev)
            base = col.vals_d * scale.to(dev)
            for values, vec in PAIRS:
                if vec != vectors:
                    continue
                vals = base.to(getattr(torch, values))
                nbytes = vals.numel() * vals.element_size() + 2 * x.numel() * x.element_size()
                row = {"level": l, "n": LOCAL[0] >> l, "values": values, "vectors": vectors,
                       "m": m, "n_off": n_off, "Lq": Lq, "bytes": nbytes,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
                fn = lambda: k.ax_core(vals, x, col.taps)  # noqa: E731
                row.update(ms=_events_ms(fn, 50), device_ms=_device_ms(fn, 20),
                           ms_flushed=_flushed_ms(fn, 20))
                if lanes:
                    fns = {G: lambda G=G: k.ax_core(vals, x, col.taps, _plan=AxPlan(G))
                           for G in LANES}
                    row["lanes_device_ms"] = {G: _device_ms(f, 20) for G, f in fns.items()}
                    row["lanes_ms_flushed"] = {G: _flushed_ms(f, 20) for G, f in fns.items()}
                rows.append(row)
        del mg
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "library": _build.library_path().name, "rows": rows}),
          flush=True)


def _run(tree: str, lanes: bool) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", tree] + (
        ["--lanes"] if lanes else [])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _variant_trees(tree: str) -> dict:
    """The unedited tree and one copy of its package per edit of
    ``VARIANTS`` (an edit that does not apply raises)."""
    trees = {"as_is": tree}
    root = os.path.join(tree, "build", "k4_variants")
    shutil.rmtree(root, ignore_errors=True)
    for name, (fname, old, new) in VARIANTS.items():
        dst = os.path.join(root, name)
        shutil.copytree(os.path.join(tree, "partitionedarrays_tpu_torch"),
                        os.path.join(dst, "partitionedarrays_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(dst, "partitionedarrays_tpu_torch", "csrc", fname)
        with open(path) as f:
            src = f.read()
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: the text to replace is not once in {fname}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
        trees[name] = dst
    return trees


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--variants", metavar="TREE_DIR")
    ap.add_argument("--out")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--lanes", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.lanes)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k4_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.variants:
        trees = _variant_trees(args.variants)
        # build every variant at once (one nvcc per source each) before timing
        builds = [subprocess.Popen([sys.executable, "-c", "from partitionedarrays_tpu_torch "
                                    "import _build; _build.build()"], cwd=t)
                  for t in trees.values()]
        if any(p.wait() for p in builds):
            raise RuntimeError("a variant did not build")
        runs = {name: _run(t, lanes=True) for name, t in trees.items()}
        card = _card()
        print(card)
        for name, run in runs.items():
            print(json.dumps({"variant": name, "rows": [
                {k: r[k] for k in ("n", "values", "vectors", "bound_ms", "lanes_device_ms")}
                for r in run["rows"]]}))
        out = {"card": card, "variants": runs}
    else:
        if len(args.trees) != 2:
            ap.error("give BEFORE_DIR and AFTER_DIR, or --variants TREE_DIR")
        before, after = args.trees
        runs = [_run(t, lanes=False) for t in (before, after, after, before)]
        card = _card()
        print(card)
        summary = []
        for i, row in enumerate(runs[0]["rows"]):
            entry = {k: row[k] for k in ("n", "values", "vectors", "bound_ms")}
            for key in ("ms", "device_ms", "ms_flushed"):
                got = [runs[j]["rows"][i][key] for j in range(4)]
                if None in got:  # the profiler kept no event
                    entry[key] = None
                    continue
                b, a = (got[0] + got[3]) / 2, (got[1] + got[2]) / 2
                entry[key] = {"before": b, "after": a, "after_over_before": a / b,
                              "after_share_of_bound": row["bound_ms"] / a}
            summary.append(entry)
        print(json.dumps({"card": card, "summary": summary}))
        out = {"card": card, "runs": runs, "summary": summary}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
