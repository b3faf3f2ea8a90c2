#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``configs/<config>.json``), a traffic mix
(``traffic/<mix>.json``, read by ``generator.py``) and its chips.  The
configuration's ``kind`` names the driver of the port
(``systems/<kind>.py``) and the plain reference that judges it
(``reference/<kind>.py``); each end-to-end metric is read by
``e2e/<metric>.py`` and each per-layer metric by ``metrics/<metric>.py``.
So a new cell, configuration, mix or metric is a new file and an entry in
``BENCHMARK.json``, never an edit here.

A run: set-up (imports, the port's kernels loaded, or built in a
checkout's first run, the port's set-up, the right-hand sides drawn from
the seed on the card, one warm unit), then a closed loop of units for
``--seconds``, one unit at a time, each waited for (``setup_s`` ends where
the loop starts), with ``--trace 1`` a profiler trace of a few more units,
then the peak memory, the port's state freed, and the reference's
judgement of what the window produced.  The last line of standard output
is the result; the last lines of standard error are the numbers compared,
each beside its limit.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

PB = Path(__file__).resolve().parent
ROOT = PB.parent
BUILD = ROOT / "build"
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own kernels build into build/torch_kernels and build/torch_native)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BUILD / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))


def cache_bytecode() -> None:
    """Keep the compiled bytecode of every module a run imports (torch's
    too) in ``build/pycache/``: where the environment forbids writing it
    beside the sources, each run would compile torch's Python anew, some
    seconds of every set-up."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(BUILD / "pycache")


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root: portbench and the port
    cache_bytecode()

from portbench import tracing  # noqa: E402

# the JAX side of the repository: no module of these may be loaded
FOREIGN = ("jax", "jaxlib", "flax", "partitionedarrays_tpu")


def load_module(path: Path):
    """The Python file ``path`` as a module (metric files carry dots)."""
    name = "portbench_" + "_".join(path.relative_to(PB).with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def foreign_modules() -> list:
    """Loaded modules of the JAX side, compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def make_sync(device):
    import torch

    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


class HostClock:
    """Named host seconds of set-up steps, the device synchronised at both
    ends of each."""

    def __init__(self, sync):
        self.sync = sync
        self.times = {}
        self.notes = {}

    @contextmanager
    def __call__(self, name: str):
        self.sync()
        t = time.perf_counter()
        yield
        self.sync()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t


def run_window(system, first: int, seconds: float, sync):
    """Units ``first``, ``first + 1``, ... one after another, each waited
    for, until ``seconds`` have passed at a unit's end.  Returns (units, the
    window's start on the host clock, its seconds, each unit's seconds from
    its call to its end)."""
    sync()
    t0 = time.perf_counter()
    latencies, i = [], first
    while True:
        t_call = time.perf_counter()
        system.unit(i)
        sync()
        t_end = time.perf_counter()
        latencies.append(t_end - t_call)
        i += 1
        if t_end - t0 >= seconds:
            break
    return list(range(first, i)), t0, t_end - t0, latencies


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"


def copy_bandwidth_gbs(device, nbytes: int = 2**30, reps: int = 10) -> float:
    """A STREAM-style copy of ``nbytes`` on the card: bytes read and written
    per second, in GB/s."""
    import torch

    src = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(src)
    end.record()
    end.synchronize()
    return 2 * nbytes * reps / (start.elapsed_time(end) / 1e3) / 1e9


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` (``kind``) or ``per_layer`` metrics this cell
    reports: those that list it, and those without a list whose end-to-end
    metric it reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]


def run_cell(bench: dict, cell: dict, config: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device, t_start: float, log=sys.stderr):
    """One run of ``cell`` on ``device``.  Returns (result, lines of the
    numbers compared)."""
    import torch

    sync = make_sync(device)
    cuda = device.type == "cuda"
    clock = HostClock(sync)
    clock.times["start_s"] = time.perf_counter() - t_start  # Python, torch
    t = time.perf_counter()
    if cuda:
        torch.empty(0, device=device)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    clock.times["cuda_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    System = load_module(PB / "systems" / f"{config['kind']}.py").System
    clock.times["port_import_s"] = time.perf_counter() - t
    system = System(config, mix, seed, device, clock)
    units, t_window, window_s, latencies = run_window(system, 1, seconds, sync)
    setup_s = t_window - t_start  # process start to the first timed unit
    outputs = system.snapshot(units)
    traced, traced_units = None, []
    if trace:
        nxt = units[-1] + 1
        n_trace = int(mix.get("trace_units", 3))

        def run_units():  # as the window runs them: each waited for
            for j in range(nxt, nxt + n_trace):
                system.unit(j)
                sync()
            return list(range(nxt, nxt + n_trace))

        traced, traced_units = tracing.profile_units(
            run_units, BUILD / "portbench" / f"trace_{cell['name']}.json", sync,
            attempts=3 if cuda else 1)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    if cuda:
        print(f"card: {torch.cuda.get_device_name(device)} x {torch.cuda.device_count()}; "
              f"nvidia-smi name,clocks.sm,power.draw,power.limit,temperature.gpu: "
              f"{nvidia_smi()}", file=log)
    print(f"memory: max_memory_allocated {peak} bytes", file=log)
    failed = system.account(units)
    facts = system.facts(units + traced_units)
    run = SimpleNamespace(
        cell=cell["name"], config=config, mix=mix, seconds=seconds, setup_s=setup_s,
        window_s=window_s, units=units, latencies=latencies, host_times=dict(clock.times),
        trace=traced, traced_units=traced_units, facts=facts)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell["name"], kind):
        sub = "metrics" if trace else "e2e"
        reader = load_module(PB / sub / f"{m['name']}.py")
        value = reader.read(run) if trace else reader.value(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    inputs = system.reference_inputs()
    system.release()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reference = load_module(PB / "reference" / f"{config['kind']}.py")
    numbers = reference.compare(config, mix, inputs, outputs, device)
    del inputs, outputs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        print(f"copy bandwidth: {copy_bandwidth_gbs(device):.1f} GB/s", file=log)
    print(f"setup: {setup_s:.3f} s; host steps {json.dumps(clock.times)}", file=log)
    print(f"kernels: {clock.notes.get('kernels', 'none')}, "
          f"kernels_s {clock.times.get('kernels_s', 0.0):.3f} s of setup_s", file=log)
    half = len(latencies) // 2
    print(f"window: {len(units)} units in {window_s:.4f} s; failed {failed}; unit seconds "
          f"median {statistics.median(latencies):.6f}, max {max(latencies):.6f}, mean of the "
          f"first half {statistics.fmean(latencies[:half or 1]):.6f}, of the second "
          f"{statistics.fmean(latencies[half:]):.6f}", file=log)
    if "iterations" in facts:
        its = [facts["iterations"][i] for i in units]
        print(f"iterations: mean {statistics.fmean(its):.4f}, min {min(its)}, max {max(its)}",
              file=log)
    checks = {}
    correct = failed == 0
    for name, value in numbers.items():
        limit = config["limits"][name]
        checks[name] = {"value": value, "limit": limit}
        correct = correct and math.isfinite(value) and value <= limit
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": int(cell.get("chips", 1)), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(units), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace and traced is not None:
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    lines = [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    lines.append(f"check failed_units: {failed} limit 0")
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / config_entry["file"])
    mix = load_json(PB / "traffic" / f"{cell['traffic']}.json")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found {found}", file=sys.stderr)
        return 3
    result, lines = run_cell(bench, cell, config, mix, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0), T_PROCESS)
    foreign = foreign_modules()
    if foreign:
        print(f"modules of the JAX side are loaded: {foreign}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    sys.stderr.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
