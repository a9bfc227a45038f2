"""Collective micro-benchmark: the ``ds_bench`` tool.

Counterpart of ``deepspeed_tpu/comm/benchmark.py`` (the reference's
``bin/ds_bench``): each collective of ``deepspeed_tpu_torch.comm`` over the
process group, payloads growing ×4 from ``--min-bytes`` to ``--max-bytes``,
reported as latency, algorithm bandwidth and the NCCL-convention bus
bandwidth (all_reduce ×2(n-1)/n, all_gather, reduce_scatter and
all_to_all ×(n-1)/n). A message's ``bytes`` is its payload over the whole
group, as the JAX tool counts it: each rank holds ``bytes / n`` of it (the
input of an all_reduce, reduce_scatter or all_to_all, the contribution to
an all_gather). On the card each size is timed with CUDA events over
``trials`` calls after ``warmups``; on the CPU (gloo) with the host clock.
Run under the launcher, one process per GPU, with the repository on
``PYTHONPATH``:

    python -m deepspeed_tpu_torch.launcher.runner deepspeed_tpu_torch/comm/benchmark.py --op all
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Tuple

import torch

OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")


def _bus_factor(op: str, n: int) -> float:
    if n <= 1:
        return 1.0
    if op == "all_reduce":
        return 2.0 * (n - 1) / n
    return (n - 1) / n


def message_sizes(min_bytes: int, max_bytes: int, itemsize: int,
                  world: int) -> List[Tuple[int, int]]:
    """(elements each rank holds, bytes over the group) of each message:
    from ``min_bytes`` ×4 up to ``max_bytes``, rounded down to whole
    elements per rank, at least one."""
    out = []
    size = min_bytes
    while size <= max_bytes:
        per_rank = max(1, size // itemsize // world)
        out.append((per_rank, per_rank * world * itemsize))
        size *= 4
    return out


def run_sweep(op: str = "all_reduce", min_bytes: int = 1 << 10, max_bytes: int = 1 << 26,
              trials: int = 5, warmups: int = 2, dtype=torch.bfloat16, device=None):
    """One row per message size: op, bytes, latency_us, algbw_gbps,
    busbw_gbps. Joins the process group first when none is initialized
    (NCCL on the card; gloo for ``device="cpu"``)."""
    from deepspeed_tpu_torch.accelerator import resolve_device
    from deepspeed_tpu_torch.comm import comm as dist

    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; choices {sorted(OPS)}")
    if not dist.is_initialized():
        dist.init_distributed(verbose=False, device=device)
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    itemsize = torch.tensor([], dtype=dtype).element_size()

    ops: Dict[str, Callable] = {
        "all_reduce": lambda x: dist.all_reduce(x),
        "all_gather": lambda x: dist.all_gather_into_tensor(x.new_empty(world * x.numel()), x),
        "reduce_scatter": lambda x: dist.reduce_scatter(x),
        "all_to_all": lambda x: dist.all_to_all_single(torch.empty_like(x), x),
    }
    fn = ops[op]

    def timed(x) -> float:
        for _ in range(warmups):
            fn(x)
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(trials):
                fn(x)
            return (time.perf_counter() - t0) / trials
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(trials):
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / trials

    results = []
    for per_rank, nbytes in message_sizes(min_bytes, max_bytes, itemsize, world):
        dt = timed(torch.zeros(per_rank, dtype=dtype, device=dev))
        algbw = nbytes / dt / 1e9
        results.append(dict(op=op, bytes=nbytes, latency_us=dt * 1e6, algbw_gbps=algbw,
                            busbw_gbps=algbw * _bus_factor(op, world)))
    return results


def main(args=None):
    p = argparse.ArgumentParser(description="deepspeed_tpu_torch collective benchmark")
    p.add_argument("--op", default="all_reduce", choices=list(OPS) + ["all"])
    p.add_argument("--min-bytes", type=int, default=1 << 10)
    p.add_argument("--max-bytes", type=int, default=1 << 26)
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="'cpu' runs over gloo on the host; default: the card (NCCL)")
    ns = p.parse_args(args)
    ops = list(OPS) if ns.op == "all" else [ns.op]
    print(f"{'op':<16}{'bytes':>12}{'lat(us)':>12}{'algbw GB/s':>12}{'busbw GB/s':>12}")
    for op in ops:
        for r in run_sweep(op, ns.min_bytes, ns.max_bytes, ns.trials, device=ns.device):
            print(f"{r['op']:<16}{r['bytes']:>12}{r['latency_us']:>12.1f}"
                  f"{r['algbw_gbps']:>12.2f}{r['busbw_gbps']:>12.2f}")
    return 0


if __name__ == "__main__":
    main()
