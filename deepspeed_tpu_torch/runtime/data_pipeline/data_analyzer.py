"""Offline per-sample metric analysis into curriculum index files.

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/data_analyzer.py``
(the reference's ``DataAnalyzer``), writing the same files, byte for byte:
a map step computes each metric over every sample (sharded by sample range
across workers), a reduce step merges the workers' outputs and buckets the
samples by value. Per metric, under ``<save>/<metric>/``:

  <metric>_sample_to_metric     row i = [metric value of sample i]
  <metric>_index_to_metric      row k = [k-th distinct value, ascending]
  <metric>_index_to_sample      row k = the samples with that value

which the curriculum sampler reads. numpy only.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.runtime.data_pipeline.indexed_dataset import (
    MMapIndexedDataset, MMapIndexedDatasetBuilder, find_fit_int_dtype)
from deepspeed_tpu_torch.utils.logging import logger


def _metric_dir(save_path: str, name: str) -> str:
    d = os.path.join(save_path, name)
    os.makedirs(d, exist_ok=True)
    return d


def _write_rows(prefix: str, rows, dtype) -> None:
    b = MMapIndexedDatasetBuilder(prefix, dtype=dtype)
    for r in rows:
        b.add_item(r)
    b.finalize()


class DataAnalyzer:
    """Map/reduce analysis. ``metric_functions`` map a sample to a
    non-negative int; ``num_workers`` / ``worker_id`` shard the map step
    into contiguous sample ranges, and ``run_reduce`` merges them."""

    def __init__(self, dataset, metric_names: Sequence[str],
                 metric_functions: Sequence[Callable], save_path: str,
                 num_workers: int = 1, worker_id: int = 0,
                 metric_types: Optional[Sequence[str]] = None):
        if len(metric_names) != len(metric_functions):
            raise ValueError("one metric function per metric name")
        self.dataset = dataset
        self.metric_names = list(metric_names)
        self.metric_functions = list(metric_functions)
        self.metric_types = list(metric_types or
                                 ["single_value_per_sample"] * len(metric_names))
        for t in self.metric_types:
            if t != "single_value_per_sample":
                raise NotImplementedError(
                    f"metric_type {t!r}: only single_value_per_sample is built (the "
                    "reference's accumulate_value reduces to a running total the "
                    "curriculum never samples from)")
        self.save_path = save_path
        self.num_workers = int(num_workers)
        self.worker_id = int(worker_id)

    def _my_range(self):
        n = len(self.dataset)
        per = (n + self.num_workers - 1) // self.num_workers
        lo = min(n, self.worker_id * per)
        return lo, min(n, lo + per)

    def run_map(self) -> None:
        lo, hi = self._my_range()
        values = {m: np.zeros(hi - lo, dtype=np.int64) for m in self.metric_names}
        for i in range(lo, hi):
            sample = self.dataset[i]
            for m, fn in zip(self.metric_names, self.metric_functions):
                values[m][i - lo] = int(fn(sample))
        for m in self.metric_names:
            d = _metric_dir(self.save_path, m)
            _write_rows(os.path.join(d, f"worker{self.worker_id}_sample_to_metric"),
                        ([v] for v in values[m]), np.int64)
        logger.info(f"DataAnalyzer map: worker {self.worker_id} analyzed samples "
                    f"[{lo}, {hi}) for {self.metric_names}")

    def run_reduce(self) -> None:
        n = len(self.dataset)
        for m in self.metric_names:
            d = _metric_dir(self.save_path, m)
            vals = []
            for w in range(self.num_workers):
                ds = MMapIndexedDataset(os.path.join(d, f"worker{w}_sample_to_metric"))
                vals.append(np.concatenate([ds[i] for i in range(len(ds))])
                            if len(ds) else np.zeros(0, np.int64))
            values = np.concatenate(vals)
            if values.size != n:
                raise ValueError(f"{values.size} metric values for {n} samples")
            _write_rows(os.path.join(d, f"{m}_sample_to_metric"), ([v] for v in values),
                        np.int64)
            # one stable argsort gives the ascending distinct values and each
            # value's samples
            order = np.argsort(values, kind="stable")
            sorted_vals = values[order]
            distinct, starts = np.unique(sorted_vals, return_index=True)
            bounds = np.append(starts, sorted_vals.size)
            idx_dtype = find_fit_int_dtype(0, max(1, n - 1))
            _write_rows(os.path.join(d, f"{m}_index_to_metric"), ([v] for v in distinct),
                        np.int64)
            _write_rows(os.path.join(d, f"{m}_index_to_sample"),
                        (np.sort(order[bounds[k]:bounds[k + 1]]).astype(idx_dtype)
                         for k in range(distinct.size)), idx_dtype)
            logger.info(f"DataAnalyzer reduce: metric {m}: {distinct.size} distinct values "
                        f"over {n} samples → {d}")

    def run(self) -> None:
        """One process: map, then reduce."""
        self.run_map()
        self.run_reduce()


def metric_paths(save_path: str, metric: str) -> Dict[str, str]:
    d = os.path.join(save_path, metric)
    return {
        "sample_path": os.path.join(d, f"{metric}_index_to_sample"),
        "metric_path": os.path.join(d, f"{metric}_index_to_metric"),
        "sample_to_metric_path": os.path.join(d, f"{metric}_sample_to_metric"),
    }
