"""A/B convergence runs of the training step's reference-exact variants
against the shipped defaults (port of the JAX package's
``tools/ab_convergence.py``):

  * frag_inits   ray seeds from rasterized fragments (point_inits=False,
                 the reference's FindSurfacePs, utils/FindSurfacePs.py:5-29)
                 instead of vertex projection: one mesh-kernel launch per
                 frame per step;
  * anchor_full  the SDF anchor over every template vertex (anchor_sub=0,
                 model/network.py:690-694) instead of a 16384 subsample;
  * cauchy       the reference's Cauchy surface solve (surf_newton=False,
                 utils/FindSurfacePs.py:114-163) instead of Gauss-Newton;
  * ref_exact    all three;
  * splat_free   JAX's variant lifts its splat capacity; the port's splat
                 bins every candidate, so there is nothing to lift and the
                 variant runs the defaults.

Every variant trains a fresh trainer on the same subject from the same IGR
cache, for the same steps: the same frame order (``RandomSampler`` seed 123)
and the same step noise (a ``torch.Generator`` seeded 42 for each variant),
at lr 1e-4.  Reported per variant: the hard mesh-render mask IoU of the
final state on 8 spaced frames (``eval_mask_iou``, the metric of
errors.txt) and maskE = 1 - IoU, the last step's loss, converged-ray
fraction, mask and colour losses, and seconds per step.

    python -m selfreconcode_tpu_torch.tools.ab_convergence --steps 300 \\
        --h 512 --frames 24 --variants base cauchy --device cuda

The subject (the 6890-vertex synthetic body, rendered by
``make_synthetic_subject``) is made in --root unless it is there already
(default <tmp>/srtpu_ab_<h>_<frames>); the IGR and skinner caches are
written there under the train CLI's names, so a later run reuses them.
Prints a markdown table, then one JSON line per variant.
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import tempfile
import time

import numpy as np
import torch

from ..cli.train import RESOLUTIONS as PROD_RES

CONF = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
                "configs", "config.conf")
SAMPLER_SEED = 123      # the frame order, JAX's
NOISE_SEED = 42         # the step noise of every variant
EVAL_FRAMES = 8

VARIANTS = {
    "base": {},                                   # the shipped defaults
    "frag_inits": {"point_inits": False},         # reference seeding
    "anchor_full": {"anchor_sub": 0},             # reference anchor
    "cauchy": {"surf_newton": False},             # reference surface solve
    "splat_free": {},                             # no splat cap to lift
    "ref_exact": {"point_inits": False, "anchor_sub": 0,
                  "surf_newton": False},
}
SPLAT_FREE = ("splat_free: the port's splat bins every candidate (it has no "
              "capacity), so there is no cap to lift; the variant runs the "
              "defaults")


def eval_mask_iou(trainer, dataset, fids) -> float:
    """Hard mesh-render IoU of the trainer's current state against the GT
    masks, averaged over fids: the template deformed into each frame,
    rasterized (one mesh-kernel launch per frame on the card) at the
    stage's footprint through the dataset's camera, as JAX's does (its
    ``_host_camera``: the scene's camera, or the one a checkpoint load
    wrote back)."""
    from ..models.deformer import deformer_apply
    from ..ops.rasterize import rasterize_mesh
    from ..render.camera import make_camera

    tmp, bank = trainer.tmp, trainer.bank
    dev = tmp.verts.device
    cp = dataset.camera_params
    cam = make_camera(cp["focal_length"], cp["princeple_points"],
                      cp["cam2world_coord_quat"], cp["world2cam_coord_trans"],
                      dataset.H, dataset.W, device=dev)
    binds = torch.zeros(tmp.verts.shape[0], dtype=torch.long, device=dev)
    ious = []
    with torch.no_grad():
        for fid in fids:
            f = slice(int(fid), int(fid) + 1)
            dv, _ = deformer_apply(trainer.nets.translator, trainer.skinner,
                                   tmp.verts, binds, bank["dcond"][f],
                                   bank["poses"][f], bank["trans"][f], 1.0)
            frags = rasterize_mesh(cam, dv, tmp.faces,
                                   trainer.stage_cfg.raster_footprint)
            pred = (frags.pix_to_face >= 0).cpu().numpy()
            gt = dataset.frame_data(int(fid))["mask"] > 0
            ious.append((pred & gt).sum() / max((pred | gt).sum(), 1))
    return float(np.mean(ious))


def eval_fids(frame_num: int, n: int) -> np.ndarray:
    return np.linspace(0, frame_num - 1, n).astype(int)


def make_trainer(root, conf, device, resolutions=None, skinner_res=None):
    """(dataset, trainer) on the subject at root with the synthetic body."""
    from ..data.dataset import SceneDataset
    from ..engine.trainer import Trainer
    from ..models.synthetic_body import synthetic_body_model

    conds = {"deformer": conf.get_int("mlp_deformer.condlen"),
             "renderer": conf.get_int("render_net.condlen")}
    ds = SceneDataset(root, conds)
    kw = {"skinner_res": skinner_res} if skinner_res else {}
    tr = Trainer(ds, synthetic_body_model(), conf, resolutions or PROD_RES,
                 data_root=root, device=device, **kw)
    return ds, tr


def prepare_variant(tr, label, overrides, tune=None):
    """tune (a test hook: smaller sample counts), then the variant's stage
    fields and its own step noise."""
    if tune is not None:
        tune(tr)
    if overrides:
        tr.override_stage(**overrides)
    tr.generator = torch.Generator(device=tr.device).manual_seed(NOISE_SEED)
    if label == "splat_free":
        print(SPLAT_FREE, flush=True)


def result(label, tr, ds, infos, wall, n_eval):
    """The variant's result dict from its steps' info dicts."""
    last = infos[-1]
    iou = eval_mask_iou(tr, ds, eval_fids(ds.frame_num, n_eval))
    return {"label": label, "stage": tr.stage_cfg.name, "steps": len(infos),
            "iou": iou, "maskE": 1.0 - iou, "loss": last["loss"],
            "ray_frac": last["ray_converged"] / tr.rays_per_step(),
            "rays": [int(i["ray_converged"]) for i in infos],
            "mask_loss": last.get("pc_mask_loss", -1.0),
            "color_loss": last.get("color_loss", -1.0),
            "s_per_it": wall / max(len(infos), 1), "wall_s": wall}


def run_variant(label, overrides, args, root, resolutions=None,
                skinner_res=None, tune=None):
    """Train one variant from the IGR cache for args.steps steps (IGR runs
    the conf's train.initial_iters and writes the cache when there is
    none)."""
    from ..config import parse_file
    from ..data.dataset import RandomSampler, batch_iterator

    conf = parse_file(args.conf)
    ds, tr = make_trainer(root, conf, args.device, resolutions, skinner_res)
    multires = conf.get_int("sdf_net.multires")
    pose_type = conf.get_int("train.skinner_pose_type")
    tr.initialize_sdf(
        abs(conf.get_int("train.initial_iters")),
        cache_path=osp.join(
            root, f"initial_sdf_idr_{multires}_{pose_type}_torch.pt"))
    tr.set_stage(args.stage)
    prepare_variant(tr, label, overrides, tune)

    sampler = RandomSampler(ds.frame_num, seed=SAMPLER_SEED)
    infos = []
    t0 = time.perf_counter()
    while len(infos) < args.steps:
        for fids, batch in batch_iterator(ds, sampler, tr.stage_cfg.N):
            if len(infos) >= args.steps:
                break
            infos.append(tr.train_step(np.asarray(fids), batch, 1e-4))
            if len(infos) % 50 == 0:
                print(f"  [{label}] step {len(infos)}: "
                      f"loss={infos[-1]['loss']:.4f} "
                      f"rays={infos[-1]['ray_converged']:.0f}", flush=True)
    res = result(label, tr, ds, infos, time.perf_counter() - t0, EVAL_FRAMES)
    print(f"  [{label}] DONE iou={res['iou']:.4f} loss={res['loss']:.4f} "
          f"rayfrac={res['ray_frac']:.3f} wall={res['wall_s']:.1f}s",
          flush=True)
    return res


def print_table(results):
    print("\n| variant | IoU | loss | ray_frac | mask_loss | color_loss | s |")
    print("|---|---|---|---|---|---|---|")
    for r in results:
        print(f"| {r['label']} | {r['iou']:.4f} | {r['loss']:.4f} | "
              f"{r['ray_frac']:.3f} | {r['mask_loss']:.4f} | "
              f"{r['color_loss']:.4f} | {r['wall_s']:.0f} |", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--h", type=int, default=512)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--stage", default="coarse",
                    choices=["coarse", "medium", "fine"])
    ap.add_argument("--variants", nargs="+", choices=sorted(VARIANTS),
                    default=["base", "frag_inits", "anchor_full"])
    ap.add_argument("--root", default=None,
                    help="the subject's directory (rendered there when it "
                         "holds none)")
    ap.add_argument("--conf", default=CONF, help="config file (HOCON)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None, resolutions=None, skinner_res=None, tune=None):
    """Entry point; returns the result dicts.  The keyword extras are test
    hooks, as in ``cli.train.main``: the octree schedule, the LBS volume
    size and tune(trainer), run before the variant's fields are set.
    --conf's train.initial_iters sets the IGR iterations; the IGR cache is
    the train CLI's name in the subject's root."""
    from ..cli.train import open_device
    from ..data.synthetic_subject import make_synthetic_subject

    args = parse_args(argv)
    args.device = open_device(args.device)
    root = args.root or osp.join(tempfile.gettempdir(),
                                 f"srtpu_ab_{args.h}_{args.frames}")
    if not osp.isfile(osp.join(root, "camera.npz")):
        print("rendering A/B subject...", flush=True)
        make_synthetic_subject(root, n_frames=args.frames, H=args.h,
                               W=args.h, verbose=False, device=args.device)
    results = []
    for v in args.variants:
        print(f"=== variant {v}: {VARIANTS[v]} ===", flush=True)
        results.append(run_variant(v, VARIANTS[v], args, root, resolutions,
                                   skinner_res, tune))
    print_table(results)
    for r in results:
        print(json.dumps(r), flush=True)
    return results


if __name__ == "__main__":
    main()
