"""Front-normal-map generation (copy of the JAX package's
cli/generate_normals.py; functional parity with the reference's
generate_normals.py).

    python -m selfreconcode_tpu_torch.cli.generate_normals --root <scene> \\
        --net netF.pt --device cuda

The reference runs PIFuHD's pretrained front normal network `netF` on
rect-cropped 512x512 patches and resamples predictions back to full
resolution (generate_normals.py:116-166).  The crop / resample / masking
pipeline is reproduced here; the normal predictor itself is pluggable:

  --net <path>  a TorchScript module mapping a (1,3,512,512) image in [-1,1]
                to (1,3,512,512) normals in [-1,1] — e.g. PIFuHD's netF
                exported with torch.jit.trace.  It runs on --device
                (default cuda; raises without CUDA, ``--device cpu`` runs it
                on the host as JAX's copy does).

Without --net this exits with instructions (the reference likewise requires
the external PIFuHD checkpoint).  Training runs fine without normals/ — the
normal loss is simply skipped, as in the reference when `normal` is absent
from the batch (model/network.py:621).  Needs the `*_rect.txt` files of
``generate_boxs``.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from glob import glob

import numpy as np


def crop_resample_predict(img, rect, predict, size=512):
    """Crop by rect (x,y,w,h), letterbox to size, predict, paste back
    (JAX :27-41)."""
    import cv2
    H, W = img.shape[:2]
    x, y, w, h = [int(v) for v in rect]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W), min(y + h, H)
    crop = np.zeros((h, w, 3), img.dtype)
    crop[y0 - y:y1 - y, x0 - x:x1 - x] = img[y0:y1, x0:x1]
    inp = cv2.resize(crop, (size, size), interpolation=cv2.INTER_LINEAR)
    pred = predict(inp)  # (size,size,3) in [-1,1]
    back = cv2.resize(pred, (w, h), interpolation=cv2.INTER_LINEAR)
    out = np.zeros((H, W, 3), np.float32)
    out[y0:y1, x0:x1] = back[y0 - y:y1 - y, x0 - x:x1 - x]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="generate normal maps")
    parser.add_argument("--root", required=True,
                        help="scene root containing imgs/ masks/ *_rect.txt")
    parser.add_argument("--net", default=None,
                        help="TorchScript normal net (e.g. PIFuHD netF)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the net (default cuda)")
    args = parser.parse_args(argv)

    # a missing net exits with JAX's instructions (JAX :52-56)
    if args.net is None or not osp.isfile(args.net):
        raise SystemExit(
            "generate_normals needs a pretrained front-normal network.\n"
            "Export PIFuHD's netF as TorchScript and pass --net <file>. "
            "Training works without normals/ (the normal loss is skipped).")

    import cv2
    import torch
    from .train import open_device

    device = open_device(args.device)
    net = torch.jit.load(args.net, map_location=device).eval()

    def predict(inp_img):
        # [0, 255] -> [-1, 1], CHW batch of one (JAX :63-69)
        t = torch.from_numpy(
            (inp_img.astype(np.float32) / 255.0 - 0.5) * 2.0
        ).permute(2, 0, 1)[None].to(device)
        with torch.no_grad():
            out = net(t)[0].permute(1, 2, 0).cpu().numpy()
        return out

    out_root = osp.join(args.root, "normals")
    os.makedirs(out_root, exist_ok=True)
    # frames in numeric order, png and jpg (JAX :73-75)
    imgs = sorted(glob(osp.join(args.root, "imgs/*.png"))
                  + glob(osp.join(args.root, "imgs/*.jpg")),
                  key=lambda x: int(osp.basename(x).split(".")[0]))
    for img_n in imgs:
        stem = osp.basename(img_n).split(".")[0]
        # the first rect of <img>_rect.txt (JAX :78-83)
        rect_n = img_n.rsplit(".", 1)[0] + "_rect.txt"
        rects = np.loadtxt(rect_n, dtype=np.int64)
        if rects.ndim == 1:
            rects = rects[None]
        img = cv2.imread(img_n)[:, :, ::-1]  # RGB
        normal = crop_resample_predict(img, rects[0], predict)
        # zero outside the mask (JAX :84-86)
        mask = (cv2.imread(osp.join(args.root, "masks/%s.png" % stem))
                > 0).any(-1)
        normal = normal * mask[..., None]
        # store RGB in [0,255] like the reference (dataset reads and flips;
        # JAX :87-89)
        out8 = np.clip((normal * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
        cv2.imwrite(osp.join(out_root, stem + ".png"), out8[:, :, ::-1])
    print(f"normals written for {len(imgs)} frames")


if __name__ == "__main__":
    main()
