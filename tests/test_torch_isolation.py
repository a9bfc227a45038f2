"""The port stands alone: no JAX, nothing of the JAX package.

``deepspeed_tpu_torch`` and chip_smoke.py must import neither ``jax`` nor
``deepspeed_tpu``, must not load or copy any file of ``deepspeed_tpu/``,
``tests/unit/`` or ``bin/`` by path, and must not hold a verbatim copy of one.
This keeps the JAX reference untouched as later slices land.
"""

import ast
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "deepspeed_tpu_torch"
PORT_SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
REFERENCE_DIRS = ("deepspeed_tpu", "tests/unit", "bin")
# calls that read, load, run or copy a file or module named by a string
PATH_CALLS = {"open", "Path", "join", "import_module", "__import__", "run_path",
              "run_module", "spec_from_file_location", "SourceFileLoader", "exec",
              "compile", "copy", "copyfile", "copy2", "copytree", "read_text",
              "read_bytes", "insert", "append", "CDLL", "load"}


def _is_reference_module(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "deepspeed_tpu")


def test_import_with_jax_blocked():
    code = f"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["deepspeed_tpu"] = None
import deepspeed_tpu_torch
names = [m.name for m in pkgutil.walk_packages(deepspeed_tpu_torch.__path__,
                                               "deepspeed_tpu_torch.")]
for n in names:
    importlib.import_module(n)
files = [getattr(m, "__file__", None) or "" for m in list(sys.modules.values()) if m]
print(json.dumps({{"modules": names, "files": files}}))
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "deepspeed_tpu_torch.inference.engine" in got["modules"]
    assert "deepspeed_tpu_torch.models.llama" in got["modules"]
    assert "deepspeed_tpu_torch.checkpoint.megatron_checkpoint" in got["modules"]
    assert "deepspeed_tpu_torch.checkpoint.meg_2d" in got["modules"]
    for new in ("runtime.activation_checkpointing.checkpointing",
                "runtime.data_pipeline.data_routing", "ops.quantizer"):
        assert f"deepspeed_tpu_torch.{new}" in got["modules"], new
    for ref in REFERENCE_DIRS:
        root = str(REPO / ref) + os.sep
        assert not [f for f in got["files"] if f.startswith(root)], ref


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _is_reference_module(a.name)]
        elif isinstance(node, ast.ImportFrom):
            bad = [node.module] if node.module and _is_reference_module(node.module) else []
        else:
            continue
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_file_used_by_path(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
        if name not in PATH_CALLS:
            continue
        for arg in ast.walk(node):
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                s = arg.value.replace("deepspeed_tpu_torch", "")
                assert not any(r in s for r in ("deepspeed_tpu", "tests/unit", "bin/")) \
                    and not _is_reference_module(s), f"{path.name}:{node.lineno}: {arg.value!r}"


def test_no_reference_file_copied_into_the_port():
    digest = lambda p: hashlib.sha256(p.read_bytes()).hexdigest()
    reference = {digest(p): p for d in REFERENCE_DIRS for p in (REPO / d).rglob("*")
                 if p.is_file() and p.stat().st_size > 64 and "__pycache__" not in p.parts}
    port = [p for p in PORT.rglob("*") if p.is_file() and "__pycache__" not in p.parts
            and "build" not in p.relative_to(PORT).parts]
    assert port
    copies = [(str(p), str(reference[digest(p)])) for p in port if digest(p) in reference]
    assert not copies
