"""Exact silhouette evaluation of an acceptance run (port of the
repository's ``tools/host_mask_eval.py``).

1. Re-derives the subject's true silhouette per frame with an exact numpy
   coverage fill (``coverage_fill``, the JAX tool's own): the clothed body
   (rebuilt from the subject's manifest and checked against gt_mesh.npz)
   posed by ``smpl_forward`` on --device into the frame, projected through
   the subject's camera -> <root>/masks_clean/.
2. Fills the trained template of rec/latest.pt (exact-size, so every face
   counts) the same way: deformed into each frame with the trained nets
   and bank at ratio 1, projected through the trained camera.  This is the
   checkpoint's template, not the infer CLI's fresh remesh, so the numbers
   are close to errors.txt's, not equal.
3. Writes reference-format errors against the exact masks ->
   <out>/errors_clean.txt (default <root>/<rec>), and prints maskE against
   both mask sets.

The training masks (masks/) come from the port's mesh kernel, which has no
capacity and drops no face.  The hole fraction (the share of the exact
silhouette missing from them) and the excess fraction (their pixels
outside it, over its area) are therefore an independent check of that
kernel against an exact fill, where the JAX tool measured its dropped
faces.

    python -m selfreconcode_tpu_torch.tools.host_mask_eval --root <subject> \\
        [--rec rec] [--frames -1] [--out DIR] [--masks-only] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import tempfile
import time

import numpy as np


def coverage_fill(xy: np.ndarray, faces: np.ndarray, H: int, W: int
                  ) -> np.ndarray:
    """Exact union coverage of projected triangles over pixel centres.

    xy: (V, 2) float (col, row) screen coordinates; inclusive edge test
    (>=), both windings accepted: a silhouette needs no depth or facing.
    """
    p = xy[faces]                                   # (F,3,2)
    mn = np.floor(p.min(1)).astype(np.int64)        # (F,2) col,row
    mx = np.ceil(p.max(1)).astype(np.int64)
    ext = (mx - mn).max(1)                          # (F,)
    on = ((mx[:, 0] >= 0) & (mn[:, 0] <= W - 1)
          & (mx[:, 1] >= 0) & (mn[:, 1] <= H - 1))
    mask = np.zeros(H * W, np.bool_)
    done = np.zeros(faces.shape[0], np.bool_)
    for w in (4, 8, 16, 32, 64, 128, 256):
        sel = on & ~done & (ext < w)
        done |= sel
        if not sel.any():
            continue
        (fsel,) = np.nonzero(sel)
        # bound the (S, w, w) working set (~7 float64 temporaries): chunk S
        step = max(1, int(3e7) // (w * w))
        for lo in range(0, fsel.size, step):
            fs = fsel[lo:lo + step]
            t = p[fs].astype(np.float32)            # (S,3,2)
            base = np.stack([np.clip(mn[fs, 0], 0, max(W - w, 0)),
                             np.clip(mn[fs, 1], 0, max(H - w, 0))], 1)
            d = np.arange(w)
            X = (base[:, 0, None, None] + d[None, None, :]).astype(np.float32)
            Y = (base[:, 1, None, None] + d[None, :, None]).astype(np.float32)
            ax, ay = t[:, 0, 0, None, None], t[:, 0, 1, None, None]
            bx, by = t[:, 1, 0, None, None], t[:, 1, 1, None, None]
            cx, cy = t[:, 2, 0, None, None], t[:, 2, 1, None, None]
            w0 = (cx - bx) * (Y - by) - (cy - by) * (X - bx)
            w1 = (ax - cx) * (Y - cy) - (ay - cy) * (X - cx)
            w2 = (bx - ax) * (Y - ay) - (by - ay) * (X - ax)
            area = ((bx - ax) * (cy - ay) - (by - ay) * (cx - ax))
            s = np.where(area >= 0, np.float32(1.0), np.float32(-1.0))
            inside = ((w0 * s >= 0) & (w1 * s >= 0) & (w2 * s >= 0)
                      & (np.abs(area) > 1e-12))
            Xi = np.broadcast_to(base[:, 0, None, None] + d[None, None, :],
                                 inside.shape)
            Yi = np.broadcast_to(base[:, 1, None, None] + d[None, :, None],
                                 inside.shape)
            ok = inside & (Xi >= 0) & (Xi < W) & (Yi >= 0) & (Yi < H)
            mask[(Yi[ok] * W + Xi[ok])] = True
        if done.all():
            break
    if not done[on].all():
        raise ValueError(f"triangle bbox exceeded 256px: {ext[on].max()}")
    return mask.reshape(H, W)


def iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = float((a & b).sum())
    union = float((a | b).sum())
    return inter / max(union, 1.0)


def screen_xy(cam, verts) -> np.ndarray:
    """(V, 2) screen (col, row) of verts through cam, on the host."""
    from ..render.camera import transform_points_screen
    return transform_points_screen(cam, verts)[:, :2].cpu().numpy()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=osp.join(tempfile.gettempdir(),
                                               "srtpu_accept"))
    ap.add_argument("--rec", default="rec")
    ap.add_argument("--frames", type=int, default=-1)
    ap.add_argument("--out", default=None,
                    help="dir for errors_clean.txt (default <root>/<rec>)")
    ap.add_argument("--masks-only", action="store_true",
                    help="only (re)generate masks_clean/ and the hole "
                         "fraction; no checkpoint needed")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Entry point; returns {frames, hole_fraction, excess_fraction} and,
    unless --masks-only, maskE_clean_{mean,max,min} and maskE_dirty_mean."""
    import cv2
    import torch
    from ..cli.train import open_device
    from ..models.smpl import smpl_forward
    from ..render.camera import make_camera
    from .acceptance_run import subject_body

    args = parse_args(argv)
    device = open_device(args.device)
    root = args.root
    out_dir = args.out or osp.join(root, args.rec)
    camz = np.load(osp.join(root, "camera.npz"))
    H, W = cv2.imread(osp.join(root, "masks/0.png"),
                      cv2.IMREAD_GRAYSCALE).shape
    rec = np.load(osp.join(root, "smpl_rec.npz"))
    poses, trans = rec["poses"], rec["trans"]
    shape = torch.as_tensor(rec["shape"], dtype=torch.float32,
                            device=device).reshape(1, -1)
    n_all = poses.shape[0]
    n_frames = n_all if args.frames < 0 else min(args.frames, n_all)
    clothed, faces_gt = subject_body(root)
    cam_gt = make_camera(np.array([camz["fx"], camz["fy"]], np.float32),
                         np.array([camz["cx"], camz["cy"]], np.float32),
                         camz["quat"], camz["T"], H, W, device=device)
    clean_dir = osp.join(root, "masks_clean")
    os.makedirs(clean_dir, exist_ok=True)

    def clean_mask(fid):
        """The exact GT silhouette of frame fid (cached in masks_clean/)."""
        cpath = osp.join(clean_dir, "%d.png" % fid)
        if osp.isfile(cpath):
            return cv2.imread(cpath, cv2.IMREAD_GRAYSCALE) > 0
        with torch.no_grad():
            v = smpl_forward(clothed, shape, torch.as_tensor(
                poses[fid], device=device).reshape(1, 24, 3))[0][0]
            v = v + torch.as_tensor(trans[fid], device=device)
        clean = coverage_fill(screen_xy(cam_gt, v), faces_gt, H, W)
        cv2.imwrite(cpath, clean.astype(np.uint8) * 255)
        return clean

    pred_mask = None if args.masks_only else trained_masks(root, args.rec,
                                                           device, H, W)
    es_clean = -1.0 * np.ones(n_all)
    es_dirty = -1.0 * np.ones(n_all)
    holes, excess = [], []
    t0 = time.perf_counter()
    for fid in range(n_frames):
        clean = clean_mask(fid)
        dirty = cv2.imread(osp.join(root, "masks/%d.png" % fid),
                           cv2.IMREAD_GRAYSCALE) > 0
        area = max(float(clean.sum()), 1.0)
        holes.append(float((clean & ~dirty).sum()) / area)
        excess.append(float((dirty & ~clean).sum()) / area)
        if pred_mask is not None:
            pred = pred_mask(fid)
            es_clean[fid] = 1.0 - iou(pred, clean)
            es_dirty[fid] = 1.0 - iou(pred, dirty)
        if fid % 20 == 0:
            print(f"frame {fid}/{n_frames} maskE_clean={es_clean[fid]:.4f} "
                  f"maskE_dirty={es_dirty[fid]:.4f} gt_holes={holes[-1]:.4f} "
                  f"({(time.perf_counter() - t0) / (fid + 1):.2f} s/frame)",
                  flush=True)
    out = {"frames": n_frames, "hole_fraction": float(np.mean(holes)),
           "excess_fraction": float(np.mean(excess))}
    print("training-mask hole fraction: mean %.5f (share of the exact "
          "silhouette missing from masks/); excess fraction: mean %.5f "
          "(masks/ pixels outside it, over its area)"
          % (out["hole_fraction"], out["excess_fraction"]), flush=True)
    if pred_mask is None:
        return out

    sel = es_clean >= 0
    os.makedirs(out_dir, exist_ok=True)
    with open(osp.join(out_dir, "errors_clean.txt"), "w") as ff:
        ff.write("maskE, mean: %f, max: %f, min: %f\n" % (
            es_clean[sel].mean(), es_clean[sel].max(), es_clean[sel].min()))
        ff.write("maskE:\n")
        ff.write("\n".join("%d: %f" % (i, e)
                           for i, e in enumerate(es_clean)))
    out.update(maskE_clean_mean=float(es_clean[sel].mean()),
               maskE_clean_max=float(es_clean[sel].max()),
               maskE_clean_min=float(es_clean[sel].min()),
               maskE_dirty_mean=float(es_dirty[sel].mean()))
    print("\n== exact evaluation over", int(sel.sum()), "frames ==")
    print("maskE vs exact gt : mean %.4f max %.4f min %.4f" % (
        out["maskE_clean_mean"], out["maskE_clean_max"],
        out["maskE_clean_min"]))
    print("maskE vs masks/   : mean %.4f (errors.txt cross-check)"
          % out["maskE_dirty_mean"], flush=True)
    return out


def trained_masks(root: str, rec: str, device, H: int, W: int):
    """fid -> the exact fill of rec/latest.pt's template deformed into
    frame fid (the trained nets and bank, ratio 1) and seen through the
    trained camera."""
    import torch
    from ..cli.train import RESOLUTIONS
    from ..config import parse_file
    from ..data.dataset import SceneDataset
    from ..engine.checkpoint import load_checkpoint
    from ..engine.trainer import Trainer
    from ..models.deformer import deformer_apply
    from ..models.synthetic_body import synthetic_body_model

    conf = parse_file(osp.join(root, rec, "config.conf"))
    ds = SceneDataset(root, {"deformer": conf.get_int("mlp_deformer.condlen"),
                             "renderer": conf.get_int("render_net.condlen")})
    tr = Trainer(ds, synthetic_body_model(), conf, RESOLUTIONS,
                 data_root=root, device=device)
    load_checkpoint(osp.join(root, rec, "latest.pt"), tr)
    tmp, bank, cam = tr.tmp, tr.bank, tr.camera()
    faces = tmp.faces.cpu().numpy()
    binds = torch.zeros(tmp.verts.shape[0], dtype=torch.long, device=device)

    def pred(fid):
        f = slice(fid, fid + 1)
        with torch.no_grad():
            dv, _ = deformer_apply(tr.nets.translator, tr.skinner, tmp.verts,
                                   binds, bank["dcond"][f], bank["poses"][f],
                                   bank["trans"][f], 1.0)
        return coverage_fill(screen_xy(cam, dv), faces, H, W)
    return pred


if __name__ == "__main__":
    main()
