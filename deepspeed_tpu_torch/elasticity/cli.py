"""``python -m deepspeed_tpu_torch.elasticity.cli -c CONFIG [-w N]``: the
elastic batch schedule of a ds_config.

Counterpart of ``bin/ds_elastic``. Prints one JSON line: the final
``train_batch_size`` and the valid chip counts of the config's
``elasticity`` block (``compute_elastic_config``) and, with
``-w/--world-size``, the micro-batch that world runs and the world size.
"""

from __future__ import annotations

import argparse
import json
import sys

from deepspeed_tpu_torch.elasticity.elasticity import compute_elastic_config


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ds_elastic", description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", required=True, help="ds_config json path")
    p.add_argument("-w", "--world-size", type=int, default=0)
    ns = p.parse_args(argv)
    out = compute_elastic_config(ns.config, world_size=ns.world_size)
    if ns.world_size:
        batch, valid, micro = out
        print(json.dumps({"train_batch_size": batch, "valid_chip_counts": valid,
                          "micro_batch": micro, "world_size": ns.world_size}))
    else:
        batch, valid = out
        print(json.dumps({"train_batch_size": batch, "valid_chip_counts": valid}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
