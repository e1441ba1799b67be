"""Mesh acceptance metrics (port of the repository's
``tools/compare_meshes.py``): bidirectional Chamfer distance and normal
consistency between two meshes, sampled on their surfaces with the same
numpy seeds (0 for the first mesh, 1 for the second) and matched with
scipy's cKDTree.  Host evaluation; --device only refuses to run without the
card, as every tool of the port does (``--device cpu`` for tests).

    python -m selfreconcode_tpu_torch.tools.compare_meshes ours.ply \\
        theirs.npz [--samples 100000] [--device cuda]

A mesh is a ``.npz`` with ``verts`` and ``faces`` (the subject's
gt_mesh.npz, ``acceptance_run``'s gt_canonical.npz), a torch archive (a
port checkpoint's template, ``tmp``, or top-level ``verts`` and ``faces``)
or the ascii PLY the port writes (``utils/meshops.py::write_mesh``).
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def load_mesh(path: str):
    """(verts (V, 3) float64, faces (F, 3) int64)."""
    if path.endswith(".npz"):
        z = np.load(path)
        return (np.asarray(z["verts"], np.float64),
                np.asarray(z["faces"], np.int64))
    from ..engine.torch_compat import is_torch_checkpoint
    if is_torch_checkpoint(path):
        from ..engine.torch_compat import load_torch
        z = load_torch(path)
        z = z.get("tmp") or z
        return (z["verts"].double().numpy(), z["faces"].long().numpy())
    return load_ascii_ply(path)


def load_ascii_ply(path: str):
    """The ascii PLY of ``write_mesh``: x y z vertices, triangle faces."""
    with open(path) as f:
        if f.readline().strip() != "ply":
            raise ValueError(f"{path}: not a PLY file")
        nv = nf = 0
        for line in f:
            t = line.strip().split()
            if t[:2] == ["element", "vertex"]:
                nv = int(t[2])
            elif t[:2] == ["element", "face"]:
                nf = int(t[2])
            elif t[0] == "format" and t[1] != "ascii":
                raise ValueError(f"{path}: a binary PLY, only ascii is read")
            elif t[0] == "end_header":
                break
        verts = np.loadtxt(f, max_rows=nv, dtype=np.float64).reshape(nv, -1)
        faces = np.loadtxt(f, max_rows=nf, dtype=np.int64).reshape(nf, -1)
    if not (faces[:, 0] == 3).all():
        raise ValueError(f"{path}: a face that is not a triangle")
    return verts[:, :3], faces[:, 1:4]


def sample_surface(verts, faces, n, seed=0):
    """n area-weighted surface samples and their face normals."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    areas = 0.5 * np.linalg.norm(fn, axis=1)
    p = areas / areas.sum()
    fi = rng.choice(len(faces), n, p=p)
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1
    u[flip] = 1 - u[flip]
    v[flip] = 1 - v[flip]
    pts = v0[fi] + u[:, None] * (v1[fi] - v0[fi]) + v[:, None] * (v2[fi] - v0[fi])
    nrm = fn[fi] / np.clip(np.linalg.norm(fn[fi], axis=1, keepdims=True),
                           1e-12, None)
    return pts, nrm


def nn_dist_and_normal(a_pts, a_nrm, b_pts, b_nrm):
    """For each point of a: the distance to the nearest b point, and |cos|
    of the two normals."""
    from scipy.spatial import cKDTree
    d, idx = cKDTree(b_pts).query(a_pts, k=1)
    return d, np.abs((a_nrm * b_nrm[idx]).sum(1))


def compare(ours, theirs, samples: int = 100000) -> dict:
    """The metrics of two (verts, faces) meshes, as the JSON line."""
    pa, na = sample_surface(*ours, samples, seed=0)
    pb, nb = sample_surface(*theirs, samples, seed=1)
    d_ab, c_ab = nn_dist_and_normal(pa, na, pb, nb)
    d_ba, c_ba = nn_dist_and_normal(pb, nb, pa, na)
    return {
        "chamfer_l1_mm": float(round(1000.0 * (d_ab.mean() + d_ba.mean())
                                     / 2, 4)),
        "chamfer_l2_mm2": float(round(1e6 * ((d_ab ** 2).mean()
                                             + (d_ba ** 2).mean()) / 2, 4)),
        "normal_consistency": float(round((c_ab.mean() + c_ba.mean()) / 2,
                                          4)),
        "samples": samples,
    }


def main(argv=None) -> dict:
    from ..cli.train import open_device
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ours")
    ap.add_argument("theirs")
    ap.add_argument("--samples", type=int, default=100000)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    open_device(args.device)
    out = compare(load_mesh(args.ours), load_mesh(args.theirs), args.samples)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
