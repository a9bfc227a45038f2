"""GoodputMeter: the engine's goodput meter (the ``goodput`` ds_config block).

Counterpart of ``deepspeed_tpu/goodput/recorder.py``. Imported only when
the block is present. The meter keeps no clock of its own: it classifies
the spans the telemetry tracer already records.

* Each step: the newest complete step's ledger (the current step's
  ``train_batch`` span is still open when the engine's post-step hook runs,
  so the series lag one step) as the ``goodput/*`` series
  ``python -m deepspeed_tpu_torch.goodput.top`` shows.
* :meth:`GoodputMeter.attribution`: the per-step ledgers of a timed window
  folded into one dict.
* What fills ``compile`` on CUDA. torch has no counterpart of the
  ``jax.monitoring`` compile listener; the port's counterparts of JAX's
  trace, lower and compile phases are the ``nvcc`` build of a kernel
  library and its load (``ops/op_builder.py``) and the capture of a CUDA
  graph (``inference/engine.py`` ``DecodeLoop.capture``: the decode,
  serving and hybrid loops). :func:`install_compile_listener` arms
  ``op_builder``'s process-wide flag once, and it stays armed, as the JAX
  listener stays registered; while it is armed those sites stamp a
  ``cat="compile"`` span, ``phase`` ``nvcc``, ``load`` or
  ``cuda_graph_capture``, on the live tracer, fetched per event.
* MFU: the flops profiler's count of one train batch (the count the
  engine gives its throughput timer, ``flops_profiler`` block) over the
  card's published peak for the training type times the world, over the
  step's wall time; none before the profiled step, and none on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch import telemetry as _telemetry
from deepspeed_tpu_torch.goodput.ledger import (goodput_fraction, step_ledgers, sum_buckets,
                                                top_badput)
from deepspeed_tpu_torch.goodput.taxonomy import BUCKETS, is_span
from deepspeed_tpu_torch.utils.logging import logger


def install_compile_listener() -> bool:
    """Arm ``op_builder``'s compile-span flag (process-wide, and it
    stays armed: a later engine without the block feeds spans to whatever
    tracer is live, the no-op one when telemetry is off)."""
    from deepspeed_tpu_torch.ops import op_builder

    op_builder.arm_compile_spans()
    return True


class GoodputMeter:
    def __init__(self, cfg, engine=None):
        self.cfg = cfg
        self.engine = engine
        self._buf: List[dict] = []      # recent span events, pruned per step
        self._idx = 0                   # consumed prefix of tracer.events
        self._last_step = -1
        self._peak: Optional[float] = None        # peak flops/s x world, cached
        self._totals = {b: 0.0 for b in BUCKETS}
        if cfg.compile_spans:
            install_compile_listener()

    # -------------------------------------------------------------- per step
    def on_step(self, step: int) -> None:
        """The engine's post-step hook: classify the steps completed since
        the last call and export their ledgers as ``goodput/*`` series.
        Only the events appended since the last call are scanned, and the
        buffer is pruned past each reported step, so a call costs one
        step's spans however long the run."""
        session = _telemetry.get_session()
        if session is None:
            return
        events = getattr(session.tracer, "events", None)
        if events is None:
            return
        if len(events) < self._idx:     # new tracer (session replaced)
            self._idx, self._buf, self._last_step = 0, [], -1
        new = events[self._idx:]
        self._idx = len(events)
        self._buf.extend(ev for ev in new if is_span(ev))
        if not self._buf:
            return
        fresh = [l for l in step_ledgers(self._buf)
                 if l["step"] > self._last_step]
        for led in fresh:
            self._export(session.registry, led)
        if fresh:
            self._last_step = fresh[-1]["step"]
            cutoff = fresh[-1]["start_us"] + fresh[-1]["wall_us"]
            self._buf = [ev for ev in self._buf
                         if ev["ts"] + ev["dur"] > cutoff]

    def _export(self, reg, led: Dict[str, Any]) -> None:
        wall_s = led["wall_us"] / 1e6
        buckets = led["buckets"]
        if led["wall_us"] > 0:
            # the partition sums exactly by construction: past the
            # tolerance the ledger's arithmetic broke, and a silently
            # wrong time ledger is worse than none
            err = abs(sum(buckets.values()) - led["wall_us"]) / led["wall_us"]
            if err > self.cfg.tolerance:
                reg.counter("goodput/closure_violations").inc()
                logger.warning(
                    f"goodput: step {led['step']} ledger buckets sum to "
                    f"{err:.1%} off its wall window (tolerance "
                    f"{self.cfg.tolerance:.0%})")
        reg.gauge("goodput/step").set(led["step"])
        reg.gauge("goodput/step_wall_s").set(wall_s)
        reg.histogram("goodput/step_wall_seconds").observe(wall_s)
        for b in BUCKETS:
            frac = buckets.get(b, 0.0) / led["wall_us"] if led["wall_us"] else 0.0
            reg.gauge("goodput/fraction", labels={"bucket": b}).set(frac)
            self._totals[b] += buckets.get(b, 0.0)
        gf = goodput_fraction(buckets)
        if gf is not None:
            reg.gauge("goodput/goodput_fraction").set(gf)
        job_gf = goodput_fraction(self._totals)
        if job_gf is not None:
            reg.gauge("goodput/job_goodput_fraction").set(job_gf)
        tb = top_badput(buckets)
        if tb is not None and led["wall_us"]:
            reg.gauge("goodput/top_badput_fraction").set(tb[1] / led["wall_us"])
        mfu = self._mfu(wall_s)
        if mfu is not None:
            reg.gauge("goodput/mfu").set(mfu)

    def _mfu(self, step_wall_s: float) -> Optional[float]:
        """MFU of one step: the flops profiler's count of the rank's share
        of the batch times the world, over the card's peak for the training
        type times the world, over the step's wall seconds. None before
        the count exists and on the CPU (no published peak)."""
        engine = self.engine
        if step_wall_s <= 0 or engine is None:
            return None
        flops = engine.tput_timer.flops_per_batch
        if not flops:
            return None
        if self._peak is None:
            self._peak = 0.0
            if engine.device.type == "cuda":
                from deepspeed_tpu_torch.accelerator import get_accelerator

                self._peak = get_accelerator().peak_flops(engine.train_dtype) \
                    * engine.dp_world_size
        if not self._peak:
            return None
        return float(flops) * engine.dp_world_size / self._peak / step_wall_s

    # ----------------------------------------------------------- attribution
    def attribution(self, events: Optional[List[dict]] = None,
                    timed_steps: Optional[int] = None) -> Dict[str, Any]:
        """The goodput of a timed window (the last ``timed_steps`` complete
        steps of ``events``, the live tracer's by default): its per-step
        ledgers, the summed buckets, the window's goodput fraction and its
        top badput bucket. Each step's buckets sum to its measured window
        exactly."""
        if events is None:
            session = _telemetry.get_session()
            events = list(getattr(session.tracer, "events", []) or []) \
                if session is not None else []
        ledgers = step_ledgers(events)
        if timed_steps and timed_steps > 0:
            ledgers = ledgers[-timed_steps:]
        if not ledgers:
            return {}
        total = sum_buckets([l["buckets"] for l in ledgers])
        out: Dict[str, Any] = {
            "per_step": [
                {"step": l["step"],
                 "wall_us": round(l["wall_us"], 1),
                 "buckets_us": {b: round(v, 1)
                                for b, v in l["buckets"].items() if v > 0}}
                for l in ledgers],
            "buckets_us": {b: round(v, 1) for b, v in total.items() if v > 0},
        }
        gf = goodput_fraction(total)
        if gf is not None:
            out["goodput_fraction"] = round(gf, 4)
        tb = top_badput(total)
        if tb is not None:
            out["top_badput"] = tb[0]
        return out
