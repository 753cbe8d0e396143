"""Containers: CSR-style jagged arrays.

Counterpart of ``fenris_tpu/containers.py`` (numpy, host side).  Parity:
the ``fenris-nested-vec`` crate (``NestedVec``: flat data +
offset arrays, lib.rs:8-14) — the storage idiom for connectivity lists,
per-element quadrature groups and disjoint subsets.  Here it doubles as
the host-side staging format before padding ragged data into the dense
tables the device wants.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

__all__ = ["NestedArray"]


@dataclass
class NestedArray:
    """A jagged array stored as flat ``data`` + ``offsets`` (len + 1)."""

    data: np.ndarray
    offsets: np.ndarray

    @staticmethod
    def empty(dtype=np.int64) -> "NestedArray":
        return NestedArray(np.empty(0, dtype=dtype), np.zeros(1, dtype=np.int64))

    @staticmethod
    def from_lists(lists: Sequence[Sequence], dtype=None) -> "NestedArray":
        lengths = np.fromiter((len(x) for x in lists), dtype=np.int64, count=len(lists))
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        if len(lists):
            data = np.concatenate([np.asarray(x, dtype=dtype) for x in lists if len(x)])
        else:
            data = np.empty(0, dtype=dtype or np.int64)
        if data.size == 0 and dtype is not None:
            data = data.astype(dtype)
        return NestedArray(data, offsets)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self.data[self.offsets[i] : self.offsets[i + 1]]

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def append(self, row: Sequence) -> "NestedArray":
        row = np.asarray(row, dtype=self.data.dtype if self.data.size else None)
        return NestedArray(
            np.concatenate([self.data, row]),
            np.concatenate([self.offsets, [self.offsets[-1] + len(row)]]),
        )

    def to_padded(self, fill=-1):
        """Dense ``[rows, max_len]`` table (the device-friendly form)."""
        n = len(self)
        L = int(self.lengths().max()) if n else 0
        out = np.full((n, L), fill, dtype=self.data.dtype)
        lens = self.lengths()
        mask = np.arange(L)[None, :] < lens[:, None]
        out[mask] = self.data
        return out
