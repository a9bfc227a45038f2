"""Build the port's CUDA kernels at first use.

Counterpart of ``deepspeed_tpu/ops/op_builder.py``. There, device kernels
are Pallas and XLA compiles them; here each kernel is a CUDA C++ source in
``deepspeed_tpu_torch/csrc/`` that ``nvcc`` compiles for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.

A library is named by a hash of its source and the compiler flags, so an
edited source rebuilds and an unchanged one is reused. Libraries go to
``deepspeed_tpu_torch/build/``. :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them; a failed build raises with
``nvcc``'s messages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's default
    place, else ``nvcc`` on ``PATH``."""
    candidates = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                               "bin", "nvcc"), shutil.which("nvcc")]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH; "
                       "the port's kernels are built from csrc/ at first use")


class CudaKernel:
    """One ``csrc/<name>.cu`` source, built into ``build/`` and bound with
    ctypes.

    ``functions`` maps each exported C function to its ctypes argument
    types; every one returns a ``cudaError_t`` as an int, and the source
    exports ``<name>_error_string``. ``entry_launches`` counts successful
    launches made through :meth:`launch`, per exported function, and
    ``launches`` is their sum — the wrapper's proof that a run went through
    the kernel.
    """

    def __init__(self, name: str, functions: Dict[str, Sequence]):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self.functions = dict(functions)
        self.entry_launches = dict.fromkeys(self.functions, 0)
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def launches(self) -> int:
        return sum(self.entry_launches.values())

    def reset_launches(self) -> None:
        self.entry_launches = dict.fromkeys(self.functions, 0)

    @property
    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}-{digest}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source unless its library is built;
        returns the process, or None when there is nothing to build."""
        if self.library_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library_path.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {self.source} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, self.library_path)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library_path))
            for fn, argtypes in self.functions.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args) -> None:
        """Call the C entry ``fn``; raise on a refused launch, else count it."""
        lib = self.load()
        rc = getattr(lib, fn)(*args)
        if rc != 0:
            msg = getattr(lib, f"{self.name}_error_string")(rc).decode()
            raise RuntimeError(f"{self.name}: {fn} failed with CUDA error {rc} ({msg})")
        self.entry_launches[fn] += 1


def build_all(kernels: Iterable[CudaKernel]) -> float:
    """Build every kernel's library in parallel (one nvcc each, all started
    together) and load them; returns the seconds taken."""
    kernels: List[CudaKernel] = list(kernels)
    t0 = time.perf_counter()
    procs = [kern.start_build() for kern in kernels]
    errors = []
    for kern, proc in zip(kernels, procs):
        try:
            kern.finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for kern in kernels:
        kern.load()
    return time.perf_counter() - t0
