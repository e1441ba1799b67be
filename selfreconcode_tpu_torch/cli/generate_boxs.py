"""Person bounding-box generation (copy of the JAX package's
cli/generate_boxs.py; functional parity with the reference's
generate_boxs.py).

    python -m selfreconcode_tpu_torch.cli.generate_boxs --root <scene>

The reference runs lightweight-openpose over the images to get person rects
(generate_boxs.py:10-69) because it operates before masks exist.  In the
SelfRecon data layout masks ARE available (masks/ is required by the
dataset), so the rects are derived directly from the mask bounding box with
the same square-crop convention the PIFuHD normal step expects — no external
pose repo needed.  Output format matches: one `<img>_rect.txt` per image
with [x, y, w, h] int rows.
"""
from __future__ import annotations

import argparse
import os.path as osp
from glob import glob

import numpy as np


def rect_from_mask(mask: np.ndarray, pad: float = 0.1):
    """Square, padded [x, y, w, h] around the mask (JAX :20-32); the whole
    frame for an empty mask (:22-24)."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        h, w = mask.shape
        return np.array([0, 0, w, h], np.int32)
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    w = x1 - x0
    h = y1 - y0
    # square box around the person with padding (PIFuHD crop convention)
    size = int(max(w, h) * (1.0 + 2.0 * pad))
    cx, cy = (x0 + x1) // 2, (y0 + y1) // 2
    return np.array([cx - size // 2, cy - size // 2, size, size], np.int32)


def main(argv=None):
    parser = argparse.ArgumentParser(description="generate person rects")
    parser.add_argument("--root", required=True,
                        help="scene root containing imgs/ masks/")
    parser.add_argument("--pad", type=float, default=0.1)
    args = parser.parse_args(argv)

    import cv2

    # frames in numeric order, png and jpg (JAX :44-46)
    imgs = sorted(glob(osp.join(args.root, "imgs/*.png"))
                  + glob(osp.join(args.root, "imgs/*.jpg")),
                  key=lambda x: int(osp.basename(x).split(".")[0]))
    n = 0
    for img_n in imgs:
        stem = osp.basename(img_n).split(".")[0]
        mask_n = osp.join(args.root, "masks/%s.png" % stem)
        mask = (cv2.imread(mask_n) > 0).any(-1)
        rect = rect_from_mask(mask, args.pad)
        # one <img>_rect.txt per image, one int row (JAX :53-54)
        out = img_n.rsplit(".", 1)[0] + "_rect.txt"
        np.savetxt(out, rect[None], fmt="%d")
        n += 1
    print(f"wrote {n} rect files")


if __name__ == "__main__":
    main()
