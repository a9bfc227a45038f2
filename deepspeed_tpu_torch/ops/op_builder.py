"""Build the port's CUDA kernels at first use.

Counterpart of ``deepspeed_tpu/ops/op_builder.py``. There, device kernels
are Pallas and XLA compiles them; here each kernel is a CUDA C++ source in
``deepspeed_tpu_torch/csrc/`` that ``nvcc`` compiles for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.

A library is named by a hash of its source, every header in its source's
directory and the compiler flags, so an edited source or header rebuilds
and an unchanged one is reused. Libraries go to
``deepspeed_tpu_torch/build/``. :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them; a failed build raises with
``nvcc``'s messages.

Host libraries (:class:`HostLibrary`, the NVMe swap's ``csrc/aio/``) are
C++ for the CPU, built the same way with ``g++`` and loaded with ctypes.

Compile spans: once :func:`arm_compile_spans` has run (the goodput meter,
``goodput/recorder.py``), each ``nvcc`` build and each library load is
stamped as a ``cat="compile"`` span (``phase`` ``nvcc`` or ``load``) on the
live telemetry tracer, and :func:`stamp_compile` stamps other sites' (a
CUDA graph capture); unarmed, a site pays one flag check.

Launch counts: each wrapper counts its launches on its :class:`CudaKernel`.
A launch captured in a CUDA graph is counted at capture, where it does not
run; whoever captures the graph takes that count back and credits it per
replay with :func:`add_launches`, so the counts read what the device ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


_KERNELS: List["CudaKernel"] = []   # every CudaKernel made, for launch_counts
_COMPILE_SPANS = [False]            # armed by the goodput meter, never disarmed


def arm_compile_spans() -> None:
    """Stamp every later build, load and capture as a compile span."""
    _COMPILE_SPANS[0] = True


def stamp_compile(phase: str, seconds: float) -> None:
    """A ``cat="compile"`` span of ``seconds`` ending now on the live
    tracer (the no-op one when telemetry is off), when armed."""
    if not _COMPILE_SPANS[0]:
        return
    from deepspeed_tpu_torch import telemetry

    telemetry.get_tracer().complete("compile", seconds * 1e6, cat="compile", phase=phase)


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
        self.build_seconds: Optional[float] = None   # its nvcc's wall time, when built here
        self.load_seconds: Optional[float] = None    # its library's load time
        self._lib: Optional[ctypes.CDLL] = None
        _KERNELS.append(self)

    @property
    def launches(self) -> int:
        return sum(self.entry_launches.values())

    def reset_launches(self) -> None:
        self.entry_launches = dict.fromkeys(self.functions, 0)

    @property
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):   # any may be included
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        digest = h.hexdigest()[:16]
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
            t0 = time.perf_counter()
            proc = self.start_build()
            if proc is not None:
                self.finish_build(proc)
                self.build_seconds = time.perf_counter() - t0
                stamp_compile("nvcc", self.build_seconds)
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(self.library_path))
            for fn, argtypes in self.functions.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self.load_seconds = time.perf_counter() - t0
            stamp_compile("load", self.load_seconds)
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
    together) and load them; returns the seconds taken. Each kernel built
    here keeps its nvcc's wall time in ``build_seconds``."""
    kernels: List[CudaKernel] = list(kernels)
    t0 = time.perf_counter()
    procs = [kern.start_build() for kern in kernels]
    errors: List[str] = []

    def finish(kern: CudaKernel, proc) -> None:
        # a thread each: every nvcc's output pipe is drained while it runs
        try:
            kern.finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
        if proc is not None:
            kern.build_seconds = time.perf_counter() - t0
            stamp_compile("nvcc", kern.build_seconds)

    threads = [threading.Thread(target=finish, args=pair) for pair in zip(kernels, procs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    for kern in kernels:
        kern.load()
    return time.perf_counter() - t0


LaunchCounts = Dict[Tuple[CudaKernel, str], int]


def launch_counts() -> LaunchCounts:
    """Every kernel's launches so far, per (kernel, C entry)."""
    return {(kern, fn): n for kern in _KERNELS for fn, n in kern.entry_launches.items()}


def builders() -> Dict[str, object]:
    """The port's libraries by name, as the accelerator's op builders
    name them: each CUDA source's :class:`CudaKernel` and the aio
    :class:`HostLibrary` (``"async_io"``, the JAX registry's name)."""
    from deepspeed_tpu_torch.ops import aio
    from deepspeed_tpu_torch.ops.pallas import decode_attention, flash_attention  # noqa: F401

    return {**{kern.name: kern for kern in _KERNELS}, "async_io": aio.LIBRARY}


def add_launches(counts: Mapping[Tuple[CudaKernel, str], int]) -> None:
    """Add ``counts`` to the kernels' launch counts (a negative count takes
    launches back)."""
    for (kern, fn), n in counts.items():
        kern.entry_launches[fn] += n


class HostLibrary:
    """A C++ source for the host, ``csrc/<relative path>``, built with g++
    into ``build/<stem>-<hash>.so`` at first :meth:`load` and bound with
    ctypes. ``functions`` maps each C function to ``(restype, argtypes)``.
    A failed build raises with g++'s messages."""

    def __init__(self, relative: str, functions: Dict[str, Tuple[object, Sequence]]):
        self.source = CSRC_DIR / relative
        self.functions = dict(functions)
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    @property
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(GXX_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path = self.library_path
                if not path.exists():
                    BUILD_DIR.mkdir(parents=True, exist_ok=True)
                    tmp = path.with_suffix(f".{os.getpid()}.tmp")
                    out = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(self.source)],
                                         capture_output=True, text=True)
                    if out.returncode != 0:
                        tmp.unlink(missing_ok=True)
                        raise RuntimeError(f"g++ failed to build {self.source} (exit "
                                           f"{out.returncode}):\n{out.stdout}{out.stderr}")
                    os.replace(tmp, path)
                lib = ctypes.CDLL(str(path))
                for fn, (restype, argtypes) in self.functions.items():
                    f = getattr(lib, fn)
                    f.restype = restype
                    f.argtypes = list(argtypes)
                self._lib = lib
            return self._lib
