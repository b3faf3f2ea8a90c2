"""Time the kernel build of two checkouts of the port, in turns, on one
machine:

    python3 scripts/build_ab.py BEFORE AFTER [--rounds 2]

BEFORE and AFTER are directories that each hold a ``partitionedarrays_tpu_torch``
package (unpack the parent commit with ``git archive`` under the git-ignored
``build/``).  Each round builds BEFORE, AFTER, AFTER, BEFORE from nothing:
the built library is removed first, and ``_build.build()`` runs in a fresh
interpreter in the checkout (one ``nvcc -c`` per ``csrc/*.cu``, all at
once, and one link).  Prints one JSON line: each checkout's build seconds
in order, the number of sources, and the card's name and power limit.
The machine's other work moves a build by seconds, so compare the two only
within one call.
"""
import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

BUILD = """
import time
from partitionedarrays_tpu_torch import _build
lib = _build.library_path()
for f in lib.parent.glob(lib.stem + "*"):
    f.unlink()
t0 = time.perf_counter()
_build.build()
print(time.perf_counter() - t0)
"""


def build_seconds(checkout: Path) -> float:
    proc = subprocess.run([sys.executable, "-c", BUILD], cwd=checkout, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"build in {checkout} failed:\n{proc.stdout}{proc.stderr}")
    return float(proc.stdout.split()[-1])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("before", type=Path)
    parser.add_argument("after", type=Path)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    out = {"before": [], "after": []}
    for _ in range(args.rounds):
        for name in ("before", "after", "after", "before"):
            out[name].append(build_seconds(getattr(args, name).resolve()))
    for name in ("before", "after"):
        out[f"{name}_sources"] = len(list(
            (getattr(args, name) / "partitionedarrays_tpu_torch" / "csrc").glob("*.cu")))
    smi = shutil.which("nvidia-smi")
    out["card"] = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() if smi else None
    print(json.dumps(out))


if __name__ == "__main__":
    main()
