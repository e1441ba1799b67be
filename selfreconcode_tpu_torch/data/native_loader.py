"""The native frame loader (torch port of
``selfreconcode_tpu/data/native_loader.py``): a C++ thread pool that
decodes PNG and JPEG frames with libpng and libjpeg, one task per frame of
a batch (THREADS threads), bound with ctypes.  It keeps no frames: the
dataset caches what it returns.

The port builds its own copy of the source (``csrc/dataloader.cpp``) at
first use, with the host compiler (``$CXX``, else ``g++``), into
``build/native/<content-hash>/libsrloader.so``.  Where the toolchain is
missing (no compiler, or no ``png.h`` / ``jpeglib.h``), ``toolchain()``
says what is missing and the dataset decodes with cv2; a compile that
starts and fails raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..ops._cuda_build import CudaLibrary

THREADS = 4     # pool threads: JAX's default, above the largest batch (N=3)


def _cxx() -> Optional[str]:
    return shutil.which(os.environ.get("CXX") or "g++")


class HostLibrary(CudaLibrary):
    """A ``csrc/`` source built by the host C++ compiler."""

    build_root = Path(__file__).resolve().parents[2] / "build" / "native"
    base_flags = ("-O3", "-fPIC", "-std=c++17", "-shared")

    def compile_command(self, out: str, verbose: bool = False) -> list:
        return [_cxx(), *self.flags, "-o", out, str(self.source), "-lpng",
                "-ljpeg", "-lpthread"]


def _bind(lib):
    lib.sr_loader_create.restype = ctypes.c_void_p
    lib.sr_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.sr_loader_destroy.restype = None
    lib.sr_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.sr_loader_batch.restype = ctypes.c_int
    lib.sr_loader_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8)]


LIB = HostLibrary("dataloader.cpp", "libsrloader", _bind)


def toolchain() -> Optional[str]:
    """None when the loader can be built; else what is missing.  Checked
    even when the library exists: a library built on another machine
    needs libpng and libjpeg, which a machine without their headers
    lacks (~16 ms with g++)."""
    cxx = _cxx()
    if cxx is None:
        return f"no C++ compiler ({os.environ.get('CXX') or 'g++'})"
    proc = subprocess.run(
        [cxx, "-fsyntax-only", "-x", "c++", "-"], capture_output=True,
        text=True, input="#include <png.h>\n#include <jpeglib.h>\n")
    if proc.returncode != 0:
        return "no png.h / jpeglib.h (libpng and libjpeg headers)"
    return None


class NativeLoader:
    """Owns a native loader handle."""

    def __init__(self, lib, handle, n_frames, H, W, has_normals):
        self._lib = lib
        self._h = handle
        self.n_frames = n_frames
        self.H = H
        self.W = W
        self.has_normals = has_normals

    @classmethod
    def create(cls, img_paths: List[str], mask_paths: List[str],
               normal_paths: Optional[List[str]], H: int,
               W: int) -> "NativeLoader":
        """normal_paths: one per frame ("" for a frame without one), or
        None.  Builds the library at the first call."""
        lib = LIB.load()
        normals = "\n".join(normal_paths) if normal_paths else ""
        h = lib.sr_loader_create(
            "\n".join(img_paths).encode(), "\n".join(mask_paths).encode(),
            normals.encode(), len(img_paths), H, W, THREADS)
        if not h:
            raise ValueError("sr_loader_create refused the path lists (one "
                             "image, mask and normal path a frame)")
        return cls(lib, h, len(img_paths), H, W, bool(normal_paths))

    def batch(self, fids) -> dict:
        """uint8 arrays: img (B,H,W,3) BGR, mask (B,H,W) {0,1}, normal
        (B,H,W,3) RGB when every frame of the batch has one.  Every frame
        decodes anew (a repeated id decodes once per slot)."""
        fids = np.ascontiguousarray(np.asarray(fids, np.int32).reshape(-1))
        bs = len(fids)
        imgs = np.empty((bs, self.H, self.W, 3), np.uint8)
        masks = np.empty((bs, self.H, self.W), np.uint8)
        normals = (np.empty((bs, self.H, self.W, 3), np.uint8)
                   if self.has_normals else None)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = self._lib.sr_loader_batch(
            self._h, fids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), bs,
            imgs.ctypes.data_as(u8p), masks.ctypes.data_as(u8p),
            normals.ctypes.data_as(u8p) if normals is not None else
            ctypes.cast(None, u8p))
        if n < 0:
            raise IOError(f"native loader: a frame of {fids.tolist()} is out "
                          f"of range, unreadable or not {self.H}x{self.W}")
        out = {"img": imgs, "mask": masks}
        if normals is not None and n == bs:
            out["normal"] = normals
        return out

    def close(self):
        if self._h:
            self._lib.sr_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
