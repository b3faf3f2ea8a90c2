"""Numerical settings of the port.

The JAX reference pins ``Precision.HIGHEST`` on its matrix products because
the default reduced-precision passes gave about 2e-3 relative error
(``partitionedarrays_tpu/ops/slot_spmv.py:304-310``).  On the H100 the same
loss comes from TF32, which keeps about three decimal digits: PyTorch leaves
it off for matmuls by default but on for cuDNN convolutions.  Both switches
are set off here, when the package is imported, so that every float32
product of the port runs in full float32 and agrees with the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_FLOAT_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype for a numpy dtype, a dtype name or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    dt = np.dtype(dtype)
    if dt not in _FLOAT_DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r}: float32 or float64")
    return dt


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for a numpy dtype, a dtype name or a torch dtype."""
    return _FLOAT_DTYPES[numpy_dtype(dtype)]


_VALUE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}


def values_dtype(dtype) -> Optional[torch.dtype]:
    """The storage dtype of a smoother's values, as a torch dtype: None, a
    torch dtype, a numpy dtype or scalar type, or a name ("bfloat16",
    "float32", "float64").  A bfloat16 of another package (JAX's, numpy's
    through ``ml_dtypes``) is read by its name, so ``ml_dtypes`` is never
    imported."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    elif isinstance(dtype, np.dtype):
        name = dtype.name
    elif isinstance(dtype, str):
        name = dtype
    else:  # a scalar type: np.float32, jnp.bfloat16
        name = getattr(dtype, "__name__", None)
    if name not in _VALUE_DTYPES:
        raise TypeError(f"unsupported values dtype {dtype!r}: bfloat16, float32 or float64")
    return _VALUE_DTYPES[name]
