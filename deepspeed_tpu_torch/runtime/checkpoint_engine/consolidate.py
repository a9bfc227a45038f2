"""Offline checkpoint consolidation: the ``zero_to_fp32.py`` analogue.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/consolidate.py``:
read a tag's flat state on the host, without an engine or a card, and
return the fp32 weights, preferring the fp32 masters (the authoritative
weights under bf16 or fp16 training) and else the compute-type params cast
up. The port's param names carry no ``/``, so the result is one level deep,
``{name: array}``, the model's own state-dict names. The HF exporters
(``arch=``) need ``module_inject`` and are a later slice.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


def resolve_tag(ckpt_dir: str, tag: Optional[str] = None) -> str:
    if tag is None:
        latest = os.path.join(os.path.abspath(ckpt_dir), "latest")
        if not os.path.isfile(latest):
            raise FileNotFoundError(f"no 'latest' file in {ckpt_dir}; pass an explicit tag")
        with open(latest) as f:
            tag = f.read().strip()
    path = os.path.join(os.path.abspath(ckpt_dir), tag)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint {path} not found")
    return tag


def consolidated_fp32_params(ckpt_dir: str, tag: Optional[str] = None) -> Dict[str, np.ndarray]:
    """A checkpoint's weights as fp32 numpy arrays on the host, nested by
    the ``/`` in their names: the ``master/`` entries when there is one for
    every param, else the ``params/`` entries cast up."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import read_state

    tag = resolve_tag(ckpt_dir, tag)
    flat = read_state(os.path.join(os.path.abspath(ckpt_dir), tag), ("params", "master"), "cpu")
    masters = {k[len("master/"):]: v for k, v in flat.items() if k.startswith("master/")}
    params = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    source = masters if masters and len(masters) == len(params) else params
    if source is params and masters:
        logger.warning(f"master tree has {len(masters)} leaves vs params {len(params)}; "
                       "consolidating compute-dtype params")
    tree: Dict = {}
    for key, val in source.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val.float().numpy()
    logger.info(f"consolidated {len(source)} fp32 tensors from {ckpt_dir}/{tag} "
                f"({'master' if source is masters else 'params'} tree)")
    return tree


def checkpoint_metadata(ckpt_dir: str, tag: Optional[str] = None) -> dict:
    tag = resolve_tag(ckpt_dir, tag)
    meta_path = os.path.join(os.path.abspath(ckpt_dir), tag, "client_state.json")
    if not os.path.isfile(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: v})
    return out


def consolidate_to_file(ckpt_dir: str, output: str, tag: Optional[str] = None,
                        arch: Optional[str] = None) -> str:
    """Consolidate and write an ``.npz`` (appended to ``output`` if missing)
    keyed by ``/``-joined names. Returns the path written."""
    if arch is not None:
        raise NotImplementedError(f"consolidate_to_file(arch={arch!r}): the HF exporters "
                                  "(module_inject) are a later slice of the port")
    sd = _flatten(consolidated_fp32_params(ckpt_dir, tag))
    if not output.endswith(".npz"):
        output += ".npz"
    np.savez(output, **sd)
    logger.info(f"wrote {len(sd)} tensors to {output}")
    return output
