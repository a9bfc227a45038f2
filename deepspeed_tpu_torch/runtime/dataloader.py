"""Data loading: the engine's resumable batch iterator.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py`` (the reference's
``deepspeed/runtime/dataloader.py``): ``DeepSpeedDataLoader`` batches any
indexable dataset (a list, a numpy array, an ``MMapIndexedDataset``, a
torch ``Dataset``) into numpy batches on the host, in an epoch order that
depends only on (seed, epoch), and ``RepeatingLoader`` restarts it at the
end of each pass. The position is kept in sample units, so a checkpoint
resumes it exactly, also under another batch size (``repartition``). Each
process of a ``torch.distributed`` world takes every world-th sample of the
global batch; the world is one process on one card.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger


def _rank_and_world():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class RepeatingLoader:
    """Wrap an iterable so that it restarts on StopIteration."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    def state_dict(self):
        if hasattr(self.loader, "state_dict"):
            return self.loader.state_dict()
        return None

    def load_state_dict(self, sd, repartition=False):
        if hasattr(self.loader, "load_state_dict"):
            try:
                self.loader.load_state_dict(sd, repartition=repartition)
            except TypeError:
                # a wrapped loader without the repartition argument
                self.loader.load_state_dict(sd)
            # the live iterator holds the old position
            self.data_iter = iter(self.loader)


def _default_collate(samples):
    """Stack a list of samples (dicts, tuples or arrays) into one numpy batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: _default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_default_collate([s[i] for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Batches an indexable dataset; each process yields its share of every
    global batch (the samples whose place in it is ``rank`` modulo the
    world). With a ``data_sampler`` the sampler's index batches give the
    order instead, and the sampler keeps the position."""

    def __init__(self, dataset, batch_size: int, collate_fn: Optional[Callable] = None,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 num_local_io_workers: int = 0, data_sampler=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.data_sampler = data_sampler
        # samples consumed in the current pass, advanced before each yield:
        # a state taken after batch b records b * batch_size
        self._batch_idx = 0
        self._sample_idx = 0
        self._resume_sample_idx: Optional[int] = None
        if data_sampler is not None:
            self.len = len(data_sampler) // self.batch_size
        else:
            self.len = len(dataset) // self.batch_size if drop_last else \
                -(-len(dataset) // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self._batch_idx = 0
        self._sample_idx = 0
        self._resume_sample_idx = None

    def __len__(self):
        return self.len

    # ------------------------------------------------- resumable position
    def state_dict(self) -> dict:
        """The position in the pass and the facts the order derives from."""
        return {
            "epoch": self.epoch,
            "batch_idx": self._batch_idx,
            "sample_idx": self._sample_idx,
            "batch_size": self.batch_size,
            "seed": self.seed,
            "shuffle": self.shuffle,
            "drop_last": self.drop_last,
            "dataset_size": len(self.dataset),
            "sampler_driven": self.data_sampler is not None,
        }

    def load_state_dict(self, sd: dict, repartition: bool = False):
        """Resume from a captured position. Raises ValueError when the batch
        size, seed, shuffle, drop_last, dataset size or sampler mode changed,
        since the old position would then repeat or skip samples.
        ``repartition=True`` forgives a changed batch size: the order depends
        on (seed, epoch) only, so the position converts to sample units and
        the pass continues at the first sample not yet consumed."""
        cap_bs = int(sd.get("batch_size", self.batch_size))
        for key, mine in (("batch_size", self.batch_size),
                          ("seed", self.seed), ("shuffle", self.shuffle),
                          ("drop_last", self.drop_last),
                          ("dataset_size", len(self.dataset)),
                          ("sampler_driven", self.data_sampler is not None)):
            theirs = sd.get(key, mine)
            if theirs != mine:
                if key == "batch_size" and repartition:
                    continue
                raise ValueError(
                    f"dataloader state mismatch: {key} was {theirs!r} at "
                    f"capture but is {mine!r} now — the sample order would "
                    "not reproduce"
                    + (" (only batch_size is repartitionable)" if repartition else ""))
        if self.data_sampler is not None:
            return      # the sampler's own state carries the position
        epoch = int(sd.get("epoch", 0))
        s = int(sd.get("sample_idx", int(sd.get("batch_idx", 0)) * cap_bs))
        n = len(self.dataset)
        # a position at or past what a full pass consumes under the capture
        # geometry was taken exactly at an epoch boundary
        usable_cap = (n // cap_bs) * cap_bs if self.drop_last else n
        if s >= usable_cap:
            epoch, s = epoch + 1, 0
        self.epoch = epoch
        self._sample_idx = s
        self._batch_idx = -(-s // self.batch_size)
        self._resume_sample_idx = s
        if repartition and cap_bs != self.batch_size and self.drop_last:
            # drop_last ends a pass at a full batch of the new size, which
            # can leave up to batch_size - 1 tail samples of this epoch
            end_new = s + ((n - s) // self.batch_size) * self.batch_size
            if end_new < usable_cap:
                logger.warning(
                    f"dataloader repartition: drop_last leaves {usable_cap - end_new} "
                    f"tail sample(s) of epoch {epoch} unconsumed under the new "
                    f"batch_size={self.batch_size} (the captured batch_size={cap_bs} "
                    "would have trained them) — skipped this epoch, never repeated")

    def _epoch_order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        return order

    def __iter__(self):
        rank, world = _rank_and_world()
        if self.data_sampler is not None:
            for idx in self.data_sampler:
                if world > 1:
                    idx = idx[rank::world]
                yield self.collate_fn([self.dataset[int(i)] for i in idx])
            return
        s = self._resume_sample_idx if self._resume_sample_idx is not None else 0
        self._resume_sample_idx = None
        epoch = self.epoch
        order = self._epoch_order()
        while s < len(order):
            if self._resume_sample_idx is not None:
                # load_state_dict was called while this generator is live:
                # continue from the restored position
                s = self._resume_sample_idx
                self._resume_sample_idx = None
                if self.epoch != epoch:
                    epoch = self.epoch
                    order = self._epoch_order()
                continue
            idx = order[s:s + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                break
            s += len(idx)
            if world > 1:
                idx = idx[rank::world]
            self._sample_idx = s
            self._batch_idx = -(-s // self.batch_size)
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
        # a completed pass moves to the next epoch's order, so a state taken
        # at the boundary resumes at the next epoch's first batch
        self.epoch = epoch + 1
        self._batch_idx = 0
        self._sample_idx = 0
