"""Memory-mapped indexed dataset: variable-length 1-D rows on disk.

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/indexed_dataset.py``,
in the same on-disk format, so that a file either package writes the other
reads, and both write the same bytes: ``<prefix>.bin`` holds the rows back
to back; ``<prefix>.idx`` is the magic ``DSTPUIDX1`` followed by a numpy
archive of the dtype code and the row offsets (int64, N+1 entries, in
elements). numpy only; no torch.
"""

from __future__ import annotations

import os

import numpy as np

_MAGIC = b"DSTPUIDX1"

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64,
           6: np.float32, 7: np.float64, 8: np.uint16, 9: np.uint32,
           10: np.uint64}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def find_fit_int_dtype(min_value, max_value):
    """The smallest numpy integer type that holds [min_value, max_value]."""
    candidates = (np.uint8, np.uint16, np.uint32, np.uint64) if min_value >= 0 else \
        (np.int8, np.int16, np.int32, np.int64)
    for dt in candidates:
        info = np.iinfo(dt)
        if info.min <= min_value and max_value <= info.max:
            return dt
    raise ValueError(f"no int dtype fits [{min_value}, {max_value}]")


class MMapIndexedDatasetBuilder:
    """Append rows with ``add_item``; ``finalize`` writes the index."""

    def __init__(self, path_prefix: str, dtype=np.int32):
        self.path_prefix = path_prefix
        self.dtype = np.dtype(dtype)
        if self.dtype not in _CODES:
            raise ValueError(f"unsupported dtype {dtype}")
        os.makedirs(os.path.dirname(os.path.abspath(path_prefix)) or ".", exist_ok=True)
        self._bin = open(path_prefix + ".bin", "wb")
        self._offsets = [0]

    def add_item(self, row) -> None:
        arr = np.ascontiguousarray(np.asarray(row).reshape(-1), dtype=self.dtype)
        self._bin.write(arr.tobytes())
        self._offsets.append(self._offsets[-1] + arr.size)

    def merge_file_(self, other_prefix: str) -> None:
        """Append the rows of another finalized dataset of the same type."""
        other = MMapIndexedDataset(other_prefix)
        if other.dtype != self.dtype:
            raise ValueError(f"dtype mismatch: {other.dtype} vs {self.dtype}")
        for i in range(len(other)):
            self.add_item(other[i])

    def finalize(self) -> None:
        self._bin.close()
        with open(self.path_prefix + ".idx", "wb") as f:
            f.write(_MAGIC)
            np.savez(f, dtype_code=np.int64(_CODES[self.dtype]),
                     offsets=np.asarray(self._offsets, dtype=np.int64))


def create_mmap_dataset_builder(path_prefix: str, dtype=np.int32):
    return MMapIndexedDatasetBuilder(path_prefix, dtype)


def close_mmap_dataset_builder(builder: MMapIndexedDatasetBuilder, _path=None):
    builder.finalize()


class MMapIndexedDataset:
    """Random-access reader of a finalized dataset; rows are numpy arrays."""

    def __init__(self, path_prefix: str, skip_warmup: bool = True):
        self.path_prefix = path_prefix
        with open(path_prefix + ".idx", "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{path_prefix}.idx: bad magic {magic!r}")
            npz = np.load(f)
            self.dtype = np.dtype(_DTYPES[int(npz["dtype_code"])])
            self._offsets = npz["offsets"]
        if os.path.getsize(path_prefix + ".bin") == 0:
            # np.memmap refuses an empty file
            self._data = np.zeros(0, dtype=self.dtype)
        else:
            self._data = np.memmap(path_prefix + ".bin", dtype=self.dtype, mode="r")

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        return np.asarray(self._data[self._offsets[i]:self._offsets[i + 1]])

    def row_sizes(self) -> np.ndarray:
        return np.diff(self._offsets)
