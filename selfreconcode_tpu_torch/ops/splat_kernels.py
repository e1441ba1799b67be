"""Splat soft-mask kernels: build, launch wrappers, plain versions, counters.

The two kernels in ``csrc/splat.cu`` replace the Pallas kernels
``splat_fwd_cells_idx`` and ``splat_bwd_cells_idx``
(``selfreconcode_tpu/ops/pallas_raster.py:231,287``).  They are compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/<content-hash>/libsrt_splat.so``
at first use and called through ``ctypes``.

Both kernels walk the binned entry list that ``ops/rasterize.py`` builds:

  entries   (M,) int32  sorted entry ids (entry mod n_pts = point id),
                        grouped by cell in ascending cell order
  cell_ids  (A,) int32  the active cells (every cell with an entry)
  starts    (A,) int32  first position of each active cell's run
  counts    (A,) int32  length of each active cell's run

Dispatch rule: a CPU tensor goes to the plain PyTorch version; a CUDA tensor
goes to the kernel or raises.  ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "splat.cu"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")


@dataclass
class LaunchCounts:
    """Kernel launches since the last reset (plain-version calls are not
    counted)."""
    splat_fwd_launches: int = 0
    splat_bwd_launches: int = 0

    def reset(self):
        self.splat_fwd_launches = 0
        self.splat_bwd_launches = 0


launches = LaunchCounts()

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the splat "
                       "kernels are built from csrc/splat.cu at first use")


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_ROOT / digest / "libsrt_splat.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/splat.cu unless the content-hashed library exists."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr, flush=True)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.srt_splat_fwd.argtypes = [p, p, i, p, p, p, p, i, i, i, i, f,
                                          p, p]
            lib.srt_splat_fwd.restype = ctypes.c_int
            lib.srt_splat_bwd.argtypes = [p, p, i, p, p, p, p, i, i, i, i, f,
                                          p, p, p]
            lib.srt_splat_bwd.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_inputs(col, row, entries, cell_ids, starts, counts, cs):
    dev = col.device
    for name, t, dt in (("col", col, torch.float32), ("row", row, torch.float32),
                        ("entries", entries, torch.int32),
                        ("cell_ids", cell_ids, torch.int32),
                        ("starts", starts, torch.int32),
                        ("counts", counts, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, col on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor, got "
                             f"shape {tuple(t.shape)}")
    if row.shape != col.shape:
        raise ValueError(f"row {tuple(row.shape)} != col {tuple(col.shape)}")
    if not (cell_ids.shape == starts.shape == counts.shape):
        raise ValueError("cell_ids, starts and counts must have one length")
    if not 1 <= cs <= 32:
        raise ValueError(f"cell size {cs} outside [1, 32] (cs*cs threads)")


def _check_cuda(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError_t {err}")


# ---------------------------------------------------------------------------
# Plain versions: vectorized over (entry, pixel-of-cell) pairs
# ---------------------------------------------------------------------------

def _pairs(col, row, entries, cell_ids, counts, cs, ncx):
    """(M, P) pixel coordinates and distances for every entry x cell pixel."""
    n_pts = col.shape[0]
    pid = entries.long() % n_pts
    cell = torch.repeat_interleave(cell_ids.long(), counts.long())
    k = torch.arange(cs * cs, device=col.device)
    px = (cell % ncx * cs)[:, None] + k % cs                  # (M, P)
    py = (cell // ncx * cs)[:, None] + k // cs
    dc = col[pid][:, None] - px.to(col.dtype)
    dr = row[pid][:, None] - py.to(col.dtype)
    return px, py, dc, dr


def splat_fwd_plain(col, row, entries, cell_ids, starts, counts, cs: int,
                    ncx: int, hp: int, wp: int, r2_inv: float):
    """Accumulated log1p(-clip(w)) image (hp, wp); zero outside active cells."""
    px, py, dc, dr = _pairs(col, row, entries, cell_ids, counts, cs, ncx)
    w = 1.0 - (dc * dc + dr * dr) * r2_inv
    lt = torch.log1p(-w.clamp(0.0, 1.0 - 1e-5))
    acc = torch.zeros(hp * wp, dtype=col.dtype, device=col.device)
    acc.index_add_(0, (py * wp + px).reshape(-1), lt.reshape(-1))
    return acc.reshape(hp, wp)


def splat_bwd_plain(col, row, entries, cell_ids, starts, counts, cot_img,
                    cs: int, ncx: int, r2_inv: float):
    """Per-entry (gcol, grow), (M, 2), in sorted-entry order."""
    wp = cot_img.shape[1]
    px, py, dc, dr = _pairs(col, row, entries, cell_ids, counts, cs, ncx)
    w = 1.0 - (dc * dc + dr * dr) * r2_inv
    act = (w > 0.0) & (w < 1.0 - 1e-5)
    cot = cot_img.reshape(-1)[py * wp + px]
    coef = torch.where(act, 2.0 * r2_inv / (1.0 - w.clamp(0.0, 1.0 - 1e-5)),
                       torch.zeros_like(w)) * cot
    return torch.stack([(coef * dc).sum(1), (coef * dr).sum(1)], dim=1)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def splat_fwd(col, row, entries, cell_ids, starts, counts, cs: int, ncx: int,
              hp: int, wp: int, r2_inv: float):
    """Forward accumulator image (hp, wp).  CPU -> plain version; CUDA ->
    the kernel (or an exception)."""
    _check_inputs(col, row, entries, cell_ids, starts, counts, cs)
    if col.device.type == "cpu":
        return splat_fwd_plain(col, row, entries, cell_ids, starts, counts,
                               cs, ncx, hp, wp, r2_inv)
    if col.device.type != "cuda":
        raise ValueError(f"splat_fwd: unsupported device {col.device}")
    lib = _load()
    acc = torch.zeros((hp, wp), dtype=torch.float32, device=col.device)
    err = lib.srt_splat_fwd(
        col.data_ptr(), row.data_ptr(), col.shape[0], entries.data_ptr(),
        cell_ids.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        cell_ids.shape[0], cs, ncx, wp, float(r2_inv), acc.data_ptr(),
        torch.cuda.current_stream(col.device).cuda_stream)
    _check_cuda(err, "splat_fwd")
    launches.splat_fwd_launches += 1
    return acc


def splat_bwd(col, row, entries, cell_ids, starts, counts, cot_img, cs: int,
              ncx: int, r2_inv: float):
    """Per-entry gradients (M, 2) in sorted-entry order.  CPU -> plain
    version; CUDA -> the kernel (or an exception)."""
    _check_inputs(col, row, entries, cell_ids, starts, counts, cs)
    if cot_img.device != col.device or cot_img.dtype != torch.float32 \
            or cot_img.dim() != 2 or not cot_img.is_contiguous():
        raise ValueError("cot_img must be a contiguous float32 (hp, wp) "
                         "tensor on col's device")
    if col.device.type == "cpu":
        return splat_bwd_plain(col, row, entries, cell_ids, starts, counts,
                               cot_img, cs, ncx, r2_inv)
    if col.device.type != "cuda":
        raise ValueError(f"splat_bwd: unsupported device {col.device}")
    lib = _load()
    g = torch.empty((entries.shape[0], 2), dtype=torch.float32,
                    device=col.device)
    err = lib.srt_splat_bwd(
        col.data_ptr(), row.data_ptr(), col.shape[0], entries.data_ptr(),
        cell_ids.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        cell_ids.shape[0], cs, ncx, cot_img.shape[1], float(r2_inv),
        cot_img.data_ptr(), g.data_ptr(),
        torch.cuda.current_stream(col.device).cuda_stream)
    _check_cuda(err, "splat_bwd")
    launches.splat_bwd_launches += 1
    return g
