"""Jagged (ragged) arrays: a vector of vectors stored as one flat ``data``
buffer and offsets ``ptrs``.

Copied from ``partitionedarrays_tpu/ops/jagged.py`` (the reference's
JaggedArray, src/jagged_array.jl:107-122, ``length_to_ptrs!`` :11,
``rewind_ptrs!`` :26, ``jagged_array`` :195), with one addition: ``data``
may be a torch tensor as well as a numpy array (``ptrs`` stay a host int64
array), so that the gathered payloads of ``parallel/primitives.py`` stay on
the device they came from.  A host buffer format for setup-time metadata;
the per-iteration exchanges run on padded tensors
(``parallel/exchange_plan.py``).

All indices are 0-based.
"""
from __future__ import annotations

import numpy as np
import torch


def length_to_ptrs(lengths) -> np.ndarray:
    """Offsets from per-item lengths: ``ptrs[i] = sum(lengths[:i])``, of size
    ``len(lengths) + 1`` (reference ``length_to_ptrs!``, 0-based)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    ptrs = np.zeros(lengths.shape[0] + 1, dtype=np.int64)
    np.cumsum(lengths, out=ptrs[1:])
    return ptrs


def ptrs_to_lengths(ptrs) -> np.ndarray:
    return np.diff(np.asarray(ptrs))


def _concat(items):
    """One flat buffer of ``items`` (numpy arrays or torch tensors)."""
    if items and isinstance(items[0], torch.Tensor):
        return torch.cat([x.reshape(-1) for x in items])
    arrays = [np.asarray(x).ravel() for x in items]
    if not arrays:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(arrays)


class JaggedArray:
    """A list of variable-length vectors in one flat buffer; ``a[i]`` is a
    view of ``data[ptrs[i]:ptrs[i+1]]``."""

    __slots__ = ("data", "ptrs")

    def __init__(self, data, ptrs):
        self.data = data if isinstance(data, torch.Tensor) else np.asarray(data)
        self.ptrs = np.asarray(ptrs, dtype=np.int64)

    @classmethod
    def from_lists(cls, lists) -> "JaggedArray":
        lists = list(lists)
        return cls(_concat(lists), length_to_ptrs([len(x) for x in lists]))

    @classmethod
    def empty(cls, lengths, dtype) -> "JaggedArray":
        ptrs = length_to_ptrs(lengths)
        return cls(np.zeros(ptrs[-1], dtype=dtype), ptrs)

    def __len__(self) -> int:
        return self.ptrs.shape[0] - 1

    def __getitem__(self, i):
        return self.data[self.ptrs[i]: self.ptrs[i + 1]]

    def __setitem__(self, i, value):
        self.data[self.ptrs[i]: self.ptrs[i + 1]] = value

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def lengths(self) -> np.ndarray:
        return ptrs_to_lengths(self.ptrs)

    def copy(self) -> "JaggedArray":
        data = self.data.clone() if isinstance(self.data, torch.Tensor) else self.data.copy()
        return JaggedArray(data, self.ptrs.copy())

    def __eq__(self, other):
        if not isinstance(other, JaggedArray):
            return NotImplemented
        if not np.array_equal(self.ptrs, other.ptrs):
            return False
        if isinstance(self.data, torch.Tensor) or isinstance(other.data, torch.Tensor):
            return torch.equal(torch.as_tensor(self.data).cpu(), torch.as_tensor(other.data).cpu())
        return np.array_equal(self.data, other.data)

    def __repr__(self):
        inner = ", ".join(repr(x.tolist()) for x in self)
        return f"JaggedArray([{inner}])"


def rewind_ptrs(ptrs) -> np.ndarray:
    """Offsets shifted back after a fill pass (reference ``rewind_ptrs!``)."""
    ptrs = np.asarray(ptrs)
    out = np.empty_like(ptrs)
    out[1:] = ptrs[:-1]
    out[0] = 0
    return out


def jagged_array(data, ptrs) -> JaggedArray:
    """The reference's constructor name (src/jagged_array.jl:195)."""
    return JaggedArray(data, ptrs)


# the reference's generic-container variant is the same type here
GenericJaggedArray = JaggedArray
