"""The numbers that decide ``correct``: the program's first steps against
the reference's, and the set-up stages this comparison passes through,
each held to a limit of the cell's (``workloads/<cell>.json``).

  loss_gap     |loss_p - loss_r| / |loss_r| of the first step; the later
               steps' losses part by flips that rounding sets off (a
               template vertex's |sdf| changing sign in the anchor term, a
               seed's pixel, a ray's convergence), so their largest gap,
               loss_gap_steps, is reported beside it with no limit
  grad_gap     by the worst leaf, | |g_p| - |g_r| | / max(|g_r|, median
               leaf's |g_r|), of the first step's gradient as the
               optimizer took it (the program's from Adam's first moment)
  change_gap   the same of each leaf's change over the steps, for the leaves
               whose first gradient in the reference is at least 1e-3 of the
               median leaf's (the others move by round-off under Adam)
  skinner_gap  the largest |w_p - w_r| of the skinning weight tables
  igr_miss     the share of the body's vertices that the program's SDF
               fit misses by over 1 cm, less the reference's own fit's
               (the fit's weights are chaotic in round-off: two code
               paths' fits differ by 10-30% after 400 Adam steps)
  remesh_gap   over the set-up's remesh and the window's last, the
               relative gap of the templates' vertex and face counts
  template_gap over the same remeshes, the largest distance (m) from a
               vertex of either template to the nearest vertex of the
               other: the positions that the sweep and marching cubes
               give, which the counts alone do not see

The leaves are the three networks' parameters, the per-frame bank and the
template's vertices (the inner pass's SGD).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

DEAD = 1e-3


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}


def leaf_gaps(p: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor],
              keys) -> Dict[str, float]:
    """Per leaf, | |p| - |r| | / max(|r|, the median leaf's |r|); 1 for a
    leaf the program lacks.  Each side steps its own remesh, so the
    template leaf's two norms are over templates that may differ by the
    vertices of a grid sign that flips."""
    nr = _norms({k: r[k] for k in keys})
    med = float(np.median([nr[k] for k in keys]))
    return {k: (abs(float(torch.linalg.norm(p[k].double())) - nr[k])
                / max(nr[k], med, 1e-30) if k in p else 1.0)
            for k in keys}


def gap_of_norms(p, r, keys) -> float:
    return max(leaf_gaps(p, r, keys).values(), default=0.0)


def live_leaves(g_ref: Dict[str, torch.Tensor]) -> List[str]:
    n = _norms(g_ref)
    med = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= DEAD * med]


def remesh_gap(verts_p, faces_p, verts_r, faces_r) -> float:
    """The relative gap of the vertex and face counts (their positions:
    ``template_gap``)."""
    return max(abs(verts_p.shape[0] - verts_r.shape[0]) / verts_r.shape[0],
               abs(faces_p.shape[0] - faces_r.shape[0]) / faces_r.shape[0])


def nearest_gap(a: torch.Tensor, b: torch.Tensor, chunk: int = 2048,
                k: int = 16) -> float:
    """The largest distance from a vertex of a to its nearest vertex of b.
    The candidates come from float32 distances (which lose ~0.3 mm near 0
    to cancellation), the k nearest of them are measured again in float64."""
    centre = b.mean(0)
    a, b = a - centre, b - centre
    b64 = b.double()
    worst = 0.0
    for ca in torch.split(a, chunk):
        idx = torch.cdist(ca, b).topk(min(k, b.shape[0]), largest=False)[1]
        d = (ca.double()[:, None, :] - b64[idx]).norm(dim=-1).min(1)[0]
        worst = max(worst, float(d.max()))
    return worst


def template_gap(verts_p, verts_r) -> float:
    """The two-way nearest-vertex distance (m) of two templates."""
    return max(nearest_gap(verts_p, verts_r), nearest_gap(verts_r, verts_p))


def numbers(prog, ref: dict, remesh_pairs, miss=None) -> Dict[str, float]:
    """prog: the program's side (``session.ProgramSide``); ref: the
    reference's (``reference.run.run``); remesh_pairs: [(state, program
    verts, faces, reference verts, faces)]; miss: the misses of the fit
    compared, when it is not the one the program's first step found."""
    out = {}
    lp, lr = prog.losses, ref["losses"]
    gaps = [abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf
            for a, b in zip(lp, lr)]
    out["loss_gap"] = gaps[0]
    out["loss_gap_steps"] = max(gaps)
    keys = sorted(ref["g1"])
    out["grad_gap"] = gap_of_norms(prog.g1, ref["g1"], keys)
    live = live_leaves(ref["g1"])
    dp = {k: prog.p3[k] - prog.p0[k] for k in live}
    dr = {k: ref["p3"][k] - ref["p0"][k] for k in live}
    out["change_gap"] = gap_of_norms(dp, dr, live)
    out["skinner_gap"] = float((prog.skinner_ws - ref["skinner_ws"]).abs()
                               .max())
    out["igr_miss"] = (ref["start_miss"] if miss is None else miss) \
        - ref["fit_miss"]
    out["remesh_gap"] = max(remesh_gap(vp, fp, vr, fr)
                            for _, vp, fp, vr, fr in remesh_pairs)
    out["template_gap"] = max(template_gap(vp, vr)
                              for _, vp, _, vr, _ in remesh_pairs)
    return out


def worst_leaves(prog, ref: dict, n: int = 3) -> Dict[str, list]:
    """The n leaves with the largest grad and change gaps, for reading
    the calibration."""
    keys = sorted(ref["g1"])
    live = live_leaves(ref["g1"])
    g = leaf_gaps(prog.g1, ref["g1"], keys)
    d = leaf_gaps({k: prog.p3[k] - prog.p0[k] for k in live},
                  {k: ref["p3"][k] - ref["p0"][k] for k in live}, live)
    top = lambda m: sorted(m.items(), key=lambda kv: -kv[1])[:n]  # noqa
    return {"grad": top(g), "change": top(d)}


def judge(values: Dict[str, float], limits: Dict[str, Optional[float]]):
    """(correct, [(name, value, limit)]): every number that has a limit
    must be finite and at most its limit."""
    rows = [(k, values[k], limits.get(k)) for k in values]
    ok = all(lim is None or (math.isfinite(v) and v <= lim)
             for _, v, lim in rows)
    return ok, rows
