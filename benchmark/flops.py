"""The matrix-multiply FLOPs one training step's algorithm needs, counted
from its shapes (the yardstick of ``step_mfu``).

Each of the three MLPs costs 2 * in * out FLOPs per linear layer per point
forward (``mlp_macs`` sums in * out over the published widths).  A gradient
that the algorithm takes through a net costs as much again: one reverse
pass for a gradient with respect to the points, and one for the weight
gradient of a net that the pass trains.  Counted per step (P rays, N
frames, nv template vertices, T = min(4096, nv) template vertices in the
point terms, A = min(16384, nv) anchor vertices, I Newton iterations):

  geom      translator forward on the N*nv posed template vertices
  inner     translator forward, point and weight gradients on N*nv
  solve     I + 1 evaluations at P points, each: SDF forward and point
            gradient, translator forward and its three Jacobian rows
  IFT       SDF and translator forward at P, and their weight gradients
  eikonal   SDF forward, point and weight gradients at (P + T) * 7 / 6
  deform    translator forward, three Jacobian rows and the weight
            gradient at N * 2 * (P + T)
  colour    SDF forward, point and weight gradients, colour net forward,
            input and weight gradients, translator forward and three
            Jacobian rows at P; the normal loss adds the translator's
            weight gradient at P
  anchor    SDF forward and weight gradient at A

Second-order terms (the reverse passes of the eikonal and Jacobian
gradients' own graphs) and every non-MLP product (skinning, the 3x3
solves) are left out, so the count is a lower bound of what the port
executes (``tests/test_bench_flops.py`` holds it to FlopCounterMode's).
"""
from __future__ import annotations

from typing import Dict, Sequence


def mlp_macs(widths: Sequence[int]) -> int:
    """Multiply-adds per point of an MLP whose layer widths are `widths`
    (input first)."""
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def net_macs(conf: dict) -> Dict[str, int]:
    """Multiply-adds per point of the SDF, translator and colour nets of a
    configuration's widths."""
    w = conf["widths"]
    sdf_in = 3 * (1 + 2 * int(conf["conf"]["sdf_net"]["multires"]))
    hidden = list(w["sdf_hidden"])
    skip = int(w["sdf_skip"])
    sdf = [sdf_in] + hidden + [1 + int(w["sdf_feature"])]
    # the layer before the skip outputs width - input, concatenated back
    macs_sdf = sum(a * (b - sdf_in if l + 1 == skip else b)
                   for l, (a, b) in enumerate(zip(sdf[:-1], sdf[1:])))
    t_in = (3 * (1 + 2 * int(conf["conf"]["mlp_deformer"]["multires"]))
            + int(conf["conf"]["mlp_deformer"]["condlen"]))
    r_in = (9 + int(conf["conf"]["render_net"]["condlen"])
            + 3 * 2 * int(conf["conf"]["render_net"]["multires_v"]))
    return {"sdf": macs_sdf,
            "translator": mlp_macs([t_in] + list(w["translator_hidden"])
                                   + [3]),
            "render": mlp_macs([r_in] + list(w["render_hidden"]) + [3])}


def step_flops(macs: Dict[str, int], P: int, N: int, nv: int, iters: int,
               normal_loss: bool, def_regu: bool = True) -> float:
    """FLOPs of one step (see the module docstring)."""
    S, T, R = (2.0 * macs[k] for k in ("sdf", "translator", "render"))
    t = min(4096, nv)
    a = min(16384, nv)
    e = (P + t) + (P + t) // 6
    d = N * 2 * (P + t)
    f = T * N * nv                                   # geom
    f += 3 * T * N * nv                              # inner
    f += (iters + 1) * P * (2 * S + 4 * T)           # solve
    f += P * (2 * S + 2 * T)                         # IFT
    f += 3 * S * e                                   # eikonal
    if def_regu:
        f += 5 * T * d                               # deformation term
    f += P * (3 * S + 3 * R + 4 * T)                 # colour, normals
    if normal_loss:
        f += P * T
    f += 2 * S * a                                   # anchor
    return f
