"""Metric-based curriculum sampler: the order in which samples are admitted.

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/data_sampler.py`` (the
reference's ``DeepSpeedDataSampler``), drawing the same numpy random stream,
so both packages admit and yield the same index batches. Per-metric
schedulers admit the samples whose analyzed value is within the current
difficulty (value based: value <= difficulty; percentile based: the easiest
d% in bucket order); newly admitted samples are shuffled into the draw
order. It yields global-batch index arrays; each process's share is the
data loader's job. The state holds the rng state and the admitted order,
so a resume costs O(admitted), not a replay.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.runtime.data_pipeline.indexed_dataset import MMapIndexedDataset
from deepspeed_tpu_torch.utils.logging import logger

VALUE_BASED = "value"
PERCENTILE_BASED = "percentile"
SINGLE_CLUSTER = "single_cluster"
SCHEDULE_BASED = "schedule_based"


class _MetricState:
    def __init__(self, name: str, cfg: Dict):
        self.name = name
        self.difficulty_type = cfg.get("difficulty_type", VALUE_BASED)
        if self.difficulty_type not in (VALUE_BASED, PERCENTILE_BASED):
            raise ValueError(f"difficulty_type {self.difficulty_type!r}")
        self.clustering_type = cfg.get("clustering_type", SCHEDULE_BASED)
        self.scheduler = CurriculumScheduler(cfg)
        if self.clustering_type == SINGLE_CLUSTER:
            self.index_to_sample = self.index_to_metric = None
        else:
            self.index_to_sample = MMapIndexedDataset(cfg["index_to_sample_path"])
            self.index_to_metric = MMapIndexedDataset(cfg["index_to_metric_path"])

    def admitted(self, difficulty: int, total: int) -> np.ndarray:
        """The samples admitted at ``difficulty``, in ascending metric order."""
        if self.clustering_type == SINGLE_CLUSTER:
            return np.arange(total, dtype=np.int64)
        rows = len(self.index_to_sample)
        if self.difficulty_type == VALUE_BASED:
            take = [self.index_to_sample[k] for k in range(rows)
                    if int(self.index_to_metric[k][0]) <= difficulty]
        else:
            n_admit = int(np.ceil(total * difficulty / 100.0))
            take, count = [], 0
            for k in range(rows):
                row = self.index_to_sample[k]
                if count + len(row) <= n_admit:
                    take.append(row)
                    count += len(row)
                else:
                    take.append(row[:max(0, n_admit - count)])
                    break
        return np.concatenate(take).astype(np.int64) if take else np.zeros(0, np.int64)


class DeepSpeedDataSampler:
    """Iterator of global-batch sample-index arrays under a metric curriculum."""

    def __init__(self, data_efficiency_config: Dict, one_epoch_total_samples: int,
                 global_batch_size: int, drop_last: bool = True):
        self.total_samples = int(one_epoch_total_samples)
        self.global_batch_size = int(global_batch_size)
        self.drop_last = drop_last
        cfg = data_efficiency_config
        self.num_epochs = int(cfg.get("data_sampling", {}).get("num_epochs", 1))
        self.np_rng = np.random.default_rng(int(cfg.get("seed", 1234)))
        cl = cfg.get("data_sampling", {}).get("curriculum_learning", {})
        self.curriculum_enabled = bool(cl.get("enabled"))
        self.metrics: List[_MetricState] = []
        if self.curriculum_enabled:
            for name, mcfg in cl.get("curriculum_metrics", {}).items():
                self.metrics.append(_MetricState(name, dict(mcfg)))
        self.curriculum_step = 0
        self.consumed_samples = 0
        self._admitted = np.zeros(0, np.int64)   # the draw order
        self._pos = 0
        self._in_order = set()
        self._last_difficulties = None   # skips the index scan while unchanged

    def __len__(self) -> int:
        return self.total_samples * self.num_epochs

    # ------------------------------------------------------------- curriculum
    def _current_admitted(self, diffs) -> np.ndarray:
        sets = None
        for m, d in zip(self.metrics, diffs):
            adm = m.admitted(d, self.total_samples)
            sets = adm if sets is None else np.intersect1d(sets, adm, assume_unique=False)
        if sets is None:
            sets = np.arange(self.total_samples, dtype=np.int64)
        return sets

    def _advance_curriculum(self) -> None:
        self.curriculum_step += 1
        # the index scan reads the whole index: run it only when a metric's
        # difficulty moved, and never once everything is admitted
        if len(self._in_order) >= self.total_samples:
            for m in self.metrics:
                m.scheduler.update_difficulty(self.curriculum_step)
            return
        diffs = tuple(m.scheduler.update_difficulty(self.curriculum_step)
                      for m in self.metrics)
        if diffs == self._last_difficulties and self._admitted.size:
            return
        self._last_difficulties = diffs
        adm = self._current_admitted(diffs)
        fresh = np.asarray([s for s in adm if int(s) not in self._in_order], dtype=np.int64)
        if fresh.size:
            self.np_rng.shuffle(fresh)
            self._admitted = np.concatenate([self._admitted, fresh])
            self._in_order.update(int(s) for s in fresh)

    # --------------------------------------------------------------- iterator
    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if self.consumed_samples >= len(self):
            raise StopIteration
        self._advance_curriculum()
        if self._admitted.size == 0:
            raise RuntimeError("curriculum admitted zero samples at minimum difficulty; "
                               "lower min_difficulty")
        batch = []
        need = self.global_batch_size
        while need > 0:
            if self._pos >= self._admitted.size:
                # a pass over the admitted set: reshuffle and wrap
                order = self._admitted.copy()
                self.np_rng.shuffle(order)
                self._admitted = order
                self._pos = 0
            take = min(need, self._admitted.size - self._pos)
            batch.append(self._admitted[self._pos:self._pos + take])
            self._pos += take
            need -= take
        self.consumed_samples += self.global_batch_size
        return np.concatenate(batch)

    # ------------------------------------------------------------------ state
    def state_dict(self) -> Dict:
        """The rng state, the admitted draw order (``admitted``, int64; the
        checkpoint engine writes it beside client_state.json as
        ``data_sampler_admitted.npy``), the position and the counters.
        ``total_samples`` and ``global_batch_size`` ride along so a resume
        against another dataset or batch is refused."""
        return {
            "curriculum_step": self.curriculum_step,
            "consumed_samples": self.consumed_samples,
            "position": self._pos,
            "admitted_size": int(self._admitted.size),
            "total_samples": self.total_samples,
            "global_batch_size": self.global_batch_size,
            "rng_state": self.np_rng.bit_generator.state,
            "last_difficulties": (list(self._last_difficulties)
                                  if self._last_difficulties is not None else None),
            # the schedule is a pure function of the step: a restore that
            # lands on other difficulties means its config changed
            "difficulties": [m.scheduler.get_current_difficulty() for m in self.metrics],
            "admitted": self._admitted.copy(),
        }

    def load_state_dict(self, sd: Dict) -> None:
        """Restore from the rng state and the admitted order when present,
        else replay the index stream for a counter-only state. A custom
        schedule must be installed before."""
        if self.consumed_samples:
            raise RuntimeError("load_state_dict needs a freshly constructed sampler")
        if "total_samples" in sd and int(sd["total_samples"]) != self.total_samples:
            raise ValueError(
                f"sampler checkpoint was taken over a dataset of {sd['total_samples']} "
                f"samples but this sampler wraps {self.total_samples} — refusing to resume "
                "the curriculum against a different dataset (is an eval loader being "
                "built with route='train'?)")
        if "global_batch_size" in sd and int(sd["global_batch_size"]) != self.global_batch_size:
            raise ValueError(
                f"sampler checkpoint was taken at global_batch_size={sd['global_batch_size']} "
                f"but this sampler runs at {self.global_batch_size} — consumed-sample and "
                "curriculum accounting would silently diverge")
        if sd.get("rng_state") is not None and sd.get("admitted") is not None:
            adm = np.asarray(sd["admitted"], dtype=np.int64)
            if adm.size != int(sd.get("admitted_size", adm.size)):
                raise ValueError("sampler state corrupt: admitted array size "
                                 f"{adm.size} != recorded {sd['admitted_size']}")
            self.np_rng.bit_generator.state = sd["rng_state"]
            self._admitted = adm
            self._in_order = {int(s) for s in adm}
            self._pos = int(sd["position"])
            self.curriculum_step = int(sd["curriculum_step"])
            self.consumed_samples = int(sd["consumed_samples"])
            ld = sd.get("last_difficulties")
            self._last_difficulties = tuple(ld) if ld is not None else None
            for m in self.metrics:
                m.scheduler.update_difficulty(self.curriculum_step)
            saved = sd.get("difficulties")
            if saved is not None:
                now = [m.scheduler.get_current_difficulty() for m in self.metrics]
                if list(saved) != now:
                    raise ValueError(
                        f"sampler restore diverged: per-metric difficulties at step "
                        f"{self.curriculum_step} are {now} but the checkpoint recorded "
                        f"{list(saved)} — the curriculum schedule config changed since "
                        "the checkpoint")
        else:
            target = int(sd["consumed_samples"])
            if target % self.global_batch_size:
                raise ValueError(f"consumed_samples {target} not a multiple of "
                                 f"global_batch_size {self.global_batch_size}")
            for _ in range(target // self.global_batch_size):
                next(self)
            if self.curriculum_step != int(sd["curriculum_step"]):
                raise ValueError(
                    f"sampler replay diverged (curriculum_step {self.curriculum_step} != "
                    f"{sd['curriculum_step']}): the curriculum schedule config changed "
                    "since the checkpoint")
            if "position" in sd and self._pos != int(sd["position"]):
                raise ValueError(
                    f"sampler replay diverged (position {self._pos} != {sd['position']}): "
                    "the dataset/index files or curriculum config changed since the "
                    "checkpoint")
        logger.info(f"DeepSpeedDataSampler resumed at curriculum step "
                    f"{self.curriculum_step}, {self.consumed_samples} consumed")
