"""Offline checkpoint consolidation: the ``zero_to_fp32.py`` analogue.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/consolidate.py``:
read a tag's flat state on the host, without an engine or a card, and
return the fp32 weights, preferring the fp32 masters (the authoritative
weights under bf16 or fp16 training) and else the compute-type params cast
up. The port's param names carry no ``/``, so the result is one level deep,
``{name: array}``, the model's own state-dict names. With ``arch`` the file
holds the HF layout of ``module_inject``'s exporters instead.

Run as ``python -m deepspeed_tpu_torch.runtime.checkpoint_engine.consolidate
<checkpoint_dir> <output.npz> [--tag TAG] [--arch gpt2|llama|opt|bloom]
[--n-head N]``, the counterpart of the JAX package's ``bin/ds_to_fp32``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

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


_ARCHS = ("gpt2", "llama", "opt", "bloom")


def consolidate_to_file(ckpt_dir: str, output: str, tag: Optional[str] = None,
                        arch: Optional[str] = None, n_head: Optional[int] = None) -> str:
    """Consolidate and write an ``.npz`` (appended to ``output`` if missing):
    keyed by the ``/``-joined names by default; with ``arch`` ("gpt2",
    "llama", "opt" or "bloom") in the HF state-dict layout of that
    architecture (``{k: torch.from_numpy(v) for k, v in np.load(f).items()}``
    reads it back into torch). "bloom" needs ``n_head`` for its
    head-interleaved qkv; "opt" writes GPT-2-layout keys, as the JAX
    package does. Returns the path written."""
    params = consolidated_fp32_params(ckpt_dir, tag)
    if arch is not None:
        from deepspeed_tpu_torch.module_inject import hf

        if arch not in _ARCHS:
            raise ValueError(f"no exporter for arch {arch!r} (have: {_ARCHS})")
        if arch == "bloom":
            if n_head is None:
                raise ValueError("arch='bloom' needs n_head for the head-interleaved qkv "
                                 "reorder")
            sd = hf.export_bloom(params, n_head=n_head)
        elif arch == "llama":
            sd = hf.export_llama(params)
        else:
            if arch == "opt":
                logger.warning("arch='opt': emitting GPT-2-layout keys (the in-tree OPT "
                               "runtime model is GPT-2-shaped); re-keying to OPT names is "
                               "not implemented")
            sd = hf.export_gpt2(params)
    else:
        sd = _flatten(params)
    if not output.endswith(".npz"):
        output += ".npz"
    np.savez(output, **sd)
    logger.info(f"wrote {len(sd)} tensors to {output}")
    return output


def main(argv: Optional[Sequence[str]] = None) -> None:
    """The command line: the JAX ``bin/ds_to_fp32``'s arguments and output,
    on the host only."""
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.runtime.checkpoint_engine.consolidate",
        description="Consolidate a deepspeed_tpu_torch checkpoint into one fp32 file "
                    "(the zero_to_fp32.py analogue).")
    ap.add_argument("checkpoint_dir")
    ap.add_argument("output")
    ap.add_argument("--tag", default=None, help="checkpoint tag (default: latest)")
    ap.add_argument("--arch", default=None,
                    help="emit HF-layout keys for this architecture (gpt2|llama|opt|bloom)")
    ap.add_argument("--n-head", type=int, default=None,
                    help="head count (required for --arch bloom)")
    args = ap.parse_args(argv)
    meta = checkpoint_metadata(args.checkpoint_dir, args.tag)
    if meta:
        print(f"checkpoint: step={meta.get('global_steps')} "
              f"zero_stage={meta.get('zero_stage')} dp={meta.get('dp_world_size')}")
    path = consolidate_to_file(args.checkpoint_dir, args.output, tag=args.tag,
                               arch=args.arch, n_head=args.n_head)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
