"""Shared pieces of the benchmark's CPU tests: a cell cut to a size the CPU
holds (48 px frames, 8 frames, a 17x29x9 skinner volume, a 17x25x9 octree,
5 IGR iterations, 32-64 rays a frame) at the published widths."""
import os.path as osp
import sys

import pytest

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_RES = [[5, 7, 3], [9, 13, 5], [17, 25, 9]]


def tiny_cell(name: str):
    from benchmark.cell import load_cell
    c = load_cell(name)
    cf = c.config
    cf["frames"] = 8
    cf["skinner_res"] = [17, 29, 9]
    cf["initial_iters"] = 5
    cf["resolutions"] = {k: TINY_RES for k in ("coarse", "medium", "fine")}
    cf["conf"]["train"]["sample_pix_num"] = 32
    cf["conf"]["loss_fine"]["sample_pix_num"] = 64
    c.traffic.update(H=48, W=48)
    return c


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card)")
    return "cuda"
