"""The training cell's step under each monitoring and profiling block.

Trains gpt2-760m (24 layers, 8 x 1024, bf16, ZeRO 1: ``chip_smoke.py``'s
``TRAIN_CONFIG``) once per row: with no block, with each of
``csv_monitor``, ``tensorboard``, ``telemetry``, ``profiling`` alone or in
the pairs the engine wires together, with all of them, and with none again;
two warm-up steps, then the median of nine. Prints one JSON line a row and
writes them all to ``chiprun_out/step_cost_by_block.json``. Needs one CUDA
card; run from the repository root: ``python tools/step_cost_by_block.py``.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time


def main() -> None:
    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.models.gpt2 import PRESETS, GPT2Model, synthetic_lm_batch
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.pallas import flash_attention as fa

    print(cs.nvidia_smi_line(), flush=True)
    op_builder.build_all((fa.KERNEL, fa.BWD_KERNEL))
    c = dataclasses.replace(PRESETS["gpt2-760m"], remat=False)
    tmp = tempfile.mkdtemp(prefix="step_cost_")
    blocks_by_row = {
        "none": {},
        "csv_monitor": {"csv_monitor": {"enabled": True, "output_path": tmp}},
        "tensorboard": {"tensorboard": {"enabled": True, "output_path": tmp}},
        "telemetry": {"telemetry": {"enabled": True, "output_dir": tmp + "/t1"}},
        "telemetry+monitor+csv": {"telemetry": {"enabled": True, "output_dir": tmp + "/t2",
                                                "monitor": True},
                                  "csv_monitor": {"enabled": True, "output_path": tmp + "/c2"}},
        "telemetry+profiling": {"telemetry": {"enabled": True, "output_dir": tmp + "/t3"},
                                "profiling": {"sample_interval": 1}},
        "profiling(no telemetry)": {"profiling": {"sample_interval": 1}},
        "all": {"csv_monitor": {"enabled": True, "output_path": tmp + "/c4"},
                "tensorboard": {"enabled": True, "output_path": tmp + "/tb4"},
                "telemetry": {"enabled": True, "output_dir": tmp + "/t4", "monitor": True},
                "profiling": {"sample_interval": 1}},
        "none again": {},
    }
    batch = synthetic_lm_batch(cs.TRAIN_BATCH, cs.TRAIN_SEQ, c.vocab_size, seed=cs.SEED,
                               device="cuda")
    out = {}
    try:
        for name, blocks in blocks_by_row.items():
            engine, *_ = deepspeed_tpu_torch.initialize(
                model=GPT2Model(c), config={**cs.TRAIN_CONFIG, **blocks})
            for _ in range(2):
                float(engine.train_batch(batch))
            ms = []
            for _ in range(9):
                t0 = time.perf_counter()
                float(engine.train_batch(batch))
                ms.append((time.perf_counter() - t0) * 1e3)
            telemetry.deconfigure()
            out[name] = {"median_ms": sorted(ms)[4], "each": ms}
            print(json.dumps({name: out[name]}), flush=True)
            del engine
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/step_cost_by_block.json", "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
