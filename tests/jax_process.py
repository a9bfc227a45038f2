"""Run JAX-package code in a fresh Python process and return its result.

A series the JAX package writes (telemetry spans, monitor events) can
depend on what ran before it in the same process: a JAX ``goodput`` test
installs a process-wide ``jax.monitoring`` compile listener
(``deepspeed_tpu/goodput/recorder.py``) that jax cannot be asked to forget
by the code that installed it, and from then on every compile adds a
``compile`` span to the live tracer. The port's tests that compare such
series build the JAX side here instead: a new interpreter, the JAX package
on the CPU with the 8 host devices of ``tests/conftest.py``, nothing else
imported.

``code`` reads its inputs from the dict ``INPUTS`` and the directory
``OUT`` (a path it may write arrays into) and sets ``RESULT``, which must
be JSON-serializable. ``load_tree(path)`` reads a params tree that
:func:`save_tree` wrote (the JAX layout: top-level leaves and the
layer-stacked ``blocks`` dict).
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """\
import json, os, sys
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \\
    " --xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
INPUTS = json.load(open(sys.argv[1]))
OUT = sys.argv[2]
RESULT = None


def load_tree(path):
    import numpy as np

    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *heads, leaf = key.split("/")
            for h in heads:
                node = node.setdefault(h, {})
            node[leaf] = z[key]
    return tree
"""
_EPILOGUE = """
json.dump(RESULT, open(os.path.join(OUT, "result.json"), "w"))
"""


def save_tree(state_dict, path: str) -> None:
    """A port model's state dict (``blocks.<n>.<key>`` per layer) as the JAX
    params layout, each ``blocks`` leaf stacked over the layers, in an npz
    of ``/``-joined keys."""
    flat, layers = {}, {}
    for name, t in state_dict.items():
        a = t.detach().float().numpy() if hasattr(t, "detach") else np.asarray(t)
        if name.startswith("blocks."):
            _, n, key = name.split(".")
            layers.setdefault(key, {})[int(n)] = a
        else:
            flat[name] = a
    for key, per in layers.items():
        flat[f"blocks/{key}"] = np.stack([per[n] for n in sorted(per)])
    np.savez(path, **flat)


class JaxRun:
    """``code`` started in a fresh process (see the module docstring); the
    caller works meanwhile and reads :meth:`result`."""

    def __init__(self, code: str, out_dir: str, **inputs):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        args = os.path.join(out_dir, "inputs.json")
        with open(args, "w") as f:
            json.dump(inputs, f)
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _PRELUDE + code + _EPILOGUE, args, out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)

    def result(self, timeout: float = 240):
        """The code's ``RESULT``; the process is killed if it outlives ``timeout``."""
        try:
            _, err = self._proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.communicate()
            raise
        assert self._proc.returncode == 0, err[-4000:]
        with open(os.path.join(self.out_dir, "result.json")) as f:
            return json.load(f)


def run_jax(code: str, out_dir: str, timeout: float = 240, **inputs):
    """``code`` in a fresh process → its ``RESULT``."""
    return JaxRun(code, out_dir, **inputs).result(timeout)
