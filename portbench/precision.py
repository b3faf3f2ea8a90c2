"""The precision a configuration states, held against the types the
program stores its operators and smoother values in.  Plain Python: the
references use it and import nothing of the program."""
from __future__ import annotations

from typing import Iterable

BITS = {"float64": 64, "float32": 32, "bfloat16": 16, "float16": 16}


def bits_short(stated: str, stored: Iterable[str]) -> float:
    """How many bits the narrowest stored type (``torch.float32`` or
    ``float32``) lacks against the stated one; 0 where none is narrower."""
    widths = [BITS[str(d).removeprefix("torch.")] for d in stored]
    return float(max(0, BITS[stated] - min(widths, default=BITS[stated])))
