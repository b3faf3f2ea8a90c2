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
