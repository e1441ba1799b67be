"""Build and load the port's CUDA sources (``csrc/*.cu``) as plain-C shared
libraries.

Each source is compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/<content-hash>/<name>.so`` at first use (the hash covers the
source and the flags, so an edit rebuilds) and loaded with ``ctypes``.
Builds of different libraries may run at once (each from its own thread).
A subclass changes the compiler (``compile_command``) and the build
directory (``build_root``): the host frame loader is one
(``data/native_loader.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Sequence

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built from csrc/ at first use")


def check_launch(err: int, what: str):
    """Raise on the cudaError_t a launch function returned (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError_t {err}")


class CudaLibrary:
    """One ``csrc/<source>`` compiled to ``<name>.so``; ``bind(lib)`` sets the
    ctypes signatures once it is loaded."""

    build_root = _BUILD_ROOT
    base_flags = _BASE_FLAGS

    def __init__(self, source: str, name: str, bind: Callable,
                 extra_flags: Sequence[str] = ()):
        self.source = _CSRC / source
        self.name = name
        self.flags = self.base_flags + tuple(extra_flags)
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(self.flags).encode()).hexdigest()
        return self.build_root / digest[:16] / f"{self.name}.so"

    def compile_command(self, out: str, verbose: bool = False) -> list:
        return [_nvcc(), *self.flags, *(("-Xptxas", "-v") if verbose else ()),
                "-o", out, str(self.source)]

    def build(self, verbose: bool = False) -> Path:
        """Compile unless the content-hashed library exists; returns its
        path.  The output is written to a temporary file and renamed, so a
        build that fails or runs beside another leaves no partial library."""
        out = self.library_path()
        if out.is_file():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = self.compile_command(tmp, verbose)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{Path(cmd[0]).name} failed on "
                               f"{self.source.name} ({proc.returncode}):\n"
                               f"{proc.stderr}")
        if verbose and proc.stderr:
            print(proc.stderr, flush=True)
        os.replace(tmp, out)
        return out

    def load(self):
        """The bound library; built and loaded at the first call.  Once it
        is loaded, a call takes no lock (the launch path calls it)."""
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(str(self.build()))
                    self._bind(lib)
                    self._lib = lib
        return self._lib

