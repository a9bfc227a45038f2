"""Experiment monitoring: TensorBoard, W&B and CSV event fan-out.

Counterpart of ``deepspeed_tpu/monitor/monitor.py``. Events are
``(tag, value, step)`` tuples; :class:`MonitorMaster` hands them to the
writers its ds_config blocks (``tensorboard``, ``wandb``, ``csv_monitor``)
enable, on process 0 of ``torch.distributed`` only. The TensorBoard writer
is ``torch.utils.tensorboard.SummaryWriter`` and the W&B one the ``wandb``
package, each imported only when its block is enabled; when the library is
absent the writer warns and disables itself, and the run goes on.
"""

from __future__ import annotations

import csv
import os
from typing import List, Tuple

from deepspeed_tpu_torch.utils.logging import logger


def _process_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Monitor:
    """A writer. ``write_events(event_list, flush=True)`` is its one method;
    ``flush`` False batches writes for a caller that flushes later."""

    def __init__(self, config):
        self.monitor_config = config

    def write_events(self, event_list: List[Tuple], flush: bool = True):
        raise NotImplementedError


class TensorBoardMonitor(Monitor):
    """Scalars into ``<output_path or ./runs>/<job_name>`` through
    ``SummaryWriter``."""

    def __init__(self, config):
        super().__init__(config)
        self.enabled = config.enabled and _process_rank() == 0
        self.summary_writer = None
        if self.enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter

                path = os.path.join(config.output_path or "./runs", config.job_name)
                self.summary_writer = SummaryWriter(log_dir=path)
            except (ImportError, OSError) as e:
                logger.warning(f"TensorBoard writer unavailable: {e}")
                self.enabled = False

    def write_events(self, event_list, flush=True):
        if self.summary_writer is None:
            return
        for event in event_list:
            self.summary_writer.add_scalar(*event)
        if flush:
            self.summary_writer.flush()


class WandbMonitor(Monitor):
    """``wandb.log({tag: value}, step=step)`` after one ``wandb.init`` with
    the block's project, group and team."""

    def __init__(self, config):
        super().__init__(config)
        self.enabled = config.enabled and _process_rank() == 0
        if self.enabled:
            try:
                import wandb

                wandb.init(project=config.project, group=config.group, entity=config.team)
                self._wandb = wandb
            except Exception as e:  # noqa: BLE001 - absent, or its init failed: train on
                logger.warning(f"wandb unavailable: {e}")
                self.enabled = False

    def write_events(self, event_list, flush=True):
        # wandb uploads on its own schedule: flush is taken and ignored
        if not self.enabled:
            return
        for tag, value, step in event_list:
            self._wandb.log({tag: value}, step=int(step))


class csvMonitor(Monitor):
    """One CSV file per tag, ``<output_path or ./csv_logs>/<job_name>/<tag
    with / as _>.csv``, with a ``step,<tag>`` header written once. Handles
    are opened at a tag's first event and kept, so a scalar a step costs a
    write, not an open and a close; a file that already exists (a resumed
    run) is appended to without a second header."""

    def __init__(self, config):
        super().__init__(config)
        self.enabled = config.enabled and _process_rank() == 0
        self.filenames = {}          # the files this writer has opened (its tags)
        self._files = {}             # file name -> (handle, csv.writer)
        if self.enabled:
            self.log_dir = os.path.join(config.output_path or "./csv_logs", config.job_name)
            os.makedirs(self.log_dir, exist_ok=True)

    def _writer(self, tag: str):
        fname = os.path.join(self.log_dir, tag.replace("/", "_") + ".csv")
        cached = self._files.get(fname)
        if cached is None:
            new = fname not in self.filenames and not os.path.exists(fname)
            self.filenames[fname] = True
            f = open(fname, "a", newline="")
            w = csv.writer(f)
            if new:
                w.writerow(["step", tag])
            self._files[fname] = cached = (f, w)
        return cached

    def write_events(self, event_list, flush=True):
        if not self.enabled:
            return
        touched = []
        for tag, value, step in event_list:
            f, w = self._writer(tag)
            w.writerow([int(step), float(value)])
            touched.append(f)
        if flush:
            for f in touched:
                f.flush()

    def close(self):
        for f, _ in self._files.values():
            try:
                f.close()
            except OSError as e:
                logger.warning(f"csv monitor: closing {f.name} failed: {e}")
        self._files = {}

    def __del__(self):
        self.close()


class MonitorMaster(Monitor):
    """The three writers of a ds_config's monitor blocks; ``enabled`` when
    any of them is. Writes on process 0 only."""

    def __init__(self, monitor_config):
        super().__init__(monitor_config)
        self.tb_monitor = TensorBoardMonitor(monitor_config.tensorboard)
        self.wandb_monitor = WandbMonitor(monitor_config.wandb)
        self.csv_monitor = csvMonitor(monitor_config.csv_monitor)
        self.enabled = (self.tb_monitor.enabled or self.wandb_monitor.enabled
                        or self.csv_monitor.enabled)

    def write_events(self, event_list, flush=True):
        if _process_rank() != 0 or not self.enabled:
            return
        for writer in (self.tb_monitor, self.wandb_monitor, self.csv_monitor):
            if writer.enabled:
                writer.write_events(event_list, flush=flush)
