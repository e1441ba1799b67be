"""What one launch of the mesh raster kernel needs, counted from the
algorithm's inputs (the deformed template's screen vertices, its faces and
the image size) and not from the port's bins: the yardstick of a raster
roofline.

For each face whose three vertices are in front of the camera and whose
box meets the image: the pixel centres inside its box (what an exact kernel
must test), the (face, pixel) pairs inside the face (by the rules of
``reference/raster.py``), and the pixels some face covers.  Bytes: each
such face read once, each covered pixel's depth, face and barycentrics
written once (the fill of the empty image is not the launch's).
"""
from __future__ import annotations

import torch

from .peaks import (BYTES_FRAGMENT, BYTES_TRI, OPS_FRAGMENT, OPS_TRI,
                    OPS_TRI_HIT, OPS_TRI_PAIR, least_seconds)
from .reference.raster import inside_pairs


@torch.no_grad()
def frame_work(screen: torch.Tensor, faces: torch.Tensor, H: int, W: int):
    """Counts for one frame: screen (V, 3) = (col, row, camera z) of the
    vertices, faces (F, 3)."""
    tri = screen[faces.long()]                                # (F, 3, 3)
    x, y = tri[:, :, 0], tri[:, :, 1]
    x0 = torch.ceil(x.amin(1)).clamp(0, W)
    x1 = torch.floor(x.amax(1)).clamp(-1, W - 1)
    y0 = torch.ceil(y.amin(1)).clamp(0, H)
    y1 = torch.floor(y.amax(1)).clamp(-1, H - 1)
    ok = ((tri[:, :, 2] > 0.0).all(1) & torch.isfinite(tri).all(2).all(1)
          & (x.amax(1) >= 0) & (x.amin(1) <= W - 1)
          & (y.amax(1) >= 0) & (y.amin(1) <= H - 1))
    box = ((x1 - x0 + 1).clamp_min(0) * (y1 - y0 + 1).clamp_min(0))[ok]
    _, pix = inside_pairs(screen, faces, H, W)
    return {"faces": int(ok.sum()), "box_pairs": int(box.sum()),
            "inside_pairs": int(pix.shape[0]),
            "covered_px": int(torch.unique(pix).shape[0])}


def least_time(work: dict) -> float:
    """The least seconds the card needs for one frame's raster launch."""
    ops = (OPS_TRI * work["faces"] + OPS_TRI_PAIR * work["box_pairs"]
           + OPS_TRI_HIT * work["inside_pairs"]
           + OPS_FRAGMENT * work["covered_px"])
    return least_seconds(ops, BYTES_TRI * work["faces"]
                         + BYTES_FRAGMENT * work["covered_px"])
