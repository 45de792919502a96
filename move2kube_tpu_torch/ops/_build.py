"""Build the port's CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface
(``build/torch_kernels/<name>-<digest>.so`` inside the package, beside
``csrc``; the digest covers the sources and flags, so an edit rebuilds and
an unchanged tree reuses its build). The compiler's output, which
``-Xptxas -v`` makes list each kernel's registers, shared memory and
spills, is kept beside the library as ``<name>-<digest>.log``. Nothing is
compiled when a module is imported:
the first launch builds, or :func:`build_all` builds every kernel at once,
one ``nvcc`` process per source, all started together.

A :class:`CudaKernel` also counts its launches: ``launches`` goes up by one
each time the kernel is launched, and nowhere else, so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

# C types of the kernels' exported arguments
# launches are counted from every thread that runs a pass (one engine per
# fleet replica, each on its own step thread): the count is exact
_COUNT_LOCK = threading.Lock()

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


class CudaKernel:
    """One ``csrc`` source, its built library, its C entry point and the
    count of its launches."""

    def __init__(self, name: str, symbol: str, argtypes: list) -> None:
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lib = None

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for src in [self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def _start_build(self):
        """Start ``nvcc`` on this source into a temporary file; returns
        ``(process, temporary path)``, or ``None`` when already built."""
        out = self.library_path()
        if out.is_file():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True), tmp

    def _finish_build(self, started) -> str:
        """Wait for :meth:`_start_build`'s process and move its library
        into place; returns the compiler's output (kept from the build
        when the library was already there)."""
        out = self.library_path()
        if started is None:
            return out.with_suffix(".log").read_text()
        proc, tmp = started
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed on {self.source} (exit {proc.returncode}):\n"
                f"{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        return log

    def _entry(self):
        if self._fn is None:
            self._finish_build(self._start_build())
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.m2kt_error_string.argtypes = [ctypes.c_int]
            lib.m2kt_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the given stream and
        returns ``cudaGetLastError()``); raise on a non-zero code."""
        rc = self._entry()(*args)
        if rc != 0:
            msg = self._lib.m2kt_error_string(rc).decode()
            raise RuntimeError(
                f"{self.name}: kernel launch failed with CUDA error {rc} "
                f"({msg})")
        with _COUNT_LOCK:
            self.launches += 1


def build_all(kernels) -> dict[str, str]:
    """Build every kernel in parallel (one ``nvcc`` each, all started
    together) and load them. Every compiler process is waited for before
    a failure is raised. Returns each kernel's compiler output."""
    started = [(k, k._start_build()) for k in kernels]
    logs, errors = {}, []
    for k, st in started:
        try:
            logs[k.name] = k._finish_build(st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k._entry()
    return logs
