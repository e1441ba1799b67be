"""The Newton surface solve replayed as a CUDA graph against its eager loop
(``engine/surface.py``).  Imports neither JAX nor the JAX package, so that
it also runs on the card, where ``tests/conftest.py`` (which imports JAX)
cannot load:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_surface_graph.py

Between the replays the rays, start points, poses and both annealing
ratios (unsaturated) change and an Adam step moves the nets in place; a
graph that had fixed any of them at its capture would drift from the
eager loop.  The graph runs the eager loop's kernels, so the two are
expected to agree bit for bit; the test allows 1e-6.
"""
import numpy as np
import pytest
import torch

from selfreconcode_tpu_torch.engine import surface as SURF
from selfreconcode_tpu_torch.engine.surface import (SurfaceConfig,
                                                    optimize_surface_points)
from selfreconcode_tpu_torch.models.deformer import deformer_apply
from selfreconcode_tpu_torch.models.sdf import SDFNet
from selfreconcode_tpu_torch.models.skinner import build_skinner, fk_transforms
from selfreconcode_tpu_torch.models.smpl import smpl_tmp_apose, toy_smpl_model
from selfreconcode_tpu_torch.models.translator import TranslatorNet
from selfreconcode_tpu_torch.utils import trace

FRAMES = 3
LEAVES = ("dcond", "poses", "trans", "rays", "cam_c")


def small_nets(dev):
    sdf = SDFNet(hidden=(64,) * 4, skip_in=(2,), multires=6, seed=0).to(dev)
    tnet = TranslatorNet(cond_size=8, multires=6, hidden=(64, 64),
                         seed=1).to(dev)
    skinner = build_skinner(toy_smpl_model(200), np.zeros(10, np.float32),
                            smpl_tmp_apose(0), resolution=(9, 17, 9),
                            device=dev)[0]
    return sdf, tnet, skinner


def solve_inputs(nets, n_rays, seed, dev):
    """A solve's inputs: start points near the SDF's initial sphere (radius
    ~0.6) on the side facing a camera at z = -3, rays from the camera
    through the deformed start points, slightly off them."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    dirs = rnd(n_rays, 3)
    dirs[:, 2] = -dirs[:, 2].abs() - 1.0
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    init = dirs * (0.6 + 0.01 * rnd(n_rays, 1))
    binds = torch.randint(0, FRAMES, (n_rays,), generator=g)
    leaves = dict(dcond=0.01 * rnd(FRAMES, 8), poses=0.02 * rnd(FRAMES, 24, 3),
                  trans=0.1 * rnd(FRAMES, 3),
                  cam_c=torch.tensor([0.0, 0.0, -3.0]))
    leaves = {k: v.to(dev) for k, v in leaves.items()}
    init, binds = init.to(dev), binds.to(dev)
    with torch.no_grad():
        d, _ = deformer_apply(nets[1], nets[2], init, binds, leaves["dcond"],
                              leaves["poses"], leaves["trans"], 1.0)
    rays = d + 1e-3 * rnd(n_rays, 3).to(dev) - leaves["cam_c"]
    leaves["rays"] = rays / rays.norm(dim=1, keepdim=True)
    return leaves, init, binds


def newton(nets, cfg, ratios, leaves, init, binds):
    """``_newton`` as the step calls it, on the FK of the leaves' poses."""
    return SURF._newton(nets, cfg, *ratios,
                        SURF._detached(
                            leaves["dcond"],
                            fk_transforms(nets[2], leaves["poses"])[0],
                            leaves["trans"], leaves["rays"], leaves["cam_c"]),
                        init, binds)


def graph_counters():
    c = trace.read_and_clear()["counters"]
    return (c.get("solve_graph_captures", 0),
            c.get("solve_graph_replays", 0))


@pytest.mark.cuda
def test_graphed_newton_solve_equals_the_eager_loop():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run this file on the card as its "
                    "docstring says)")
    dev = torch.device("cuda")
    nets = small_nets(dev)
    opt = torch.optim.Adam([*nets[0].parameters(), *nets[1].parameters()],
                           lr=1e-3)
    cfg = SurfaceConfig(n_iters=10)
    SURF._GRAPHS.clear()
    trace.read_and_clear()
    for step in range(4):               # a capture, then three replays
        ratios = (0.6 + 0.05 * step, 0.5 + 0.07 * step)
        leaves, init, binds = solve_inputs(nets, 512, step, dev)
        graphed = newton(nets, cfg, ratios, leaves, init, binds)
        with torch.no_grad():           # no grad: the eager loop
            eager = newton(nets, cfg, ratios, leaves, init, binds)
        assert bool(eager[1].any()) and not bool(eager[3][0].all())
        for name, g, e in zip(("pts", "done", "B", "dones"), graphed, eager):
            if g.dtype == torch.bool:
                assert torch.equal(g, e), name
            else:
                torch.testing.assert_close(g, e, rtol=0, atol=1e-6,
                                           msg=name)
        opt.zero_grad()
        pts = graphed[0]
        loss = (nets[0](pts, ratios[0])[0].square().mean()
                + nets[1].offset(pts, leaves["dcond"][binds],
                                 ratios[1]).square().mean())
        loss.backward()
        opt.step()
    assert graph_counters() == (1, 3)
    # tracing on: the converged counts are read from the replay's outputs
    leaves, init, binds = solve_inputs(nets, 512, 9, dev)
    args = (*(leaves[k] for k in LEAVES), init, binds)
    trace.enable()
    try:
        optimize_surface_points(nets, cfg, 0.7, 0.8, *args)
        rows = trace.read_and_clear()["device"]["solve_converged"]
    finally:
        trace.disable()
    with torch.no_grad():
        dones = newton(nets, cfg, (0.7, 0.8), leaves, init, binds)[3]
    assert rows == [dones.sum(1).tolist()]
    # another ray count captures again; early exit and Cauchy stay eager
    leaves, init, binds = solve_inputs(nets, 384, 10, dev)
    args = (*(leaves[k] for k in LEAVES), init, binds)
    for other in (cfg, SurfaceConfig(n_iters=10, early_exit=True),
                  SurfaceConfig(n_iters=10, newton=False)):
        optimize_surface_points(nets, other, 0.7, 0.8, *args)
    assert graph_counters() == (1, 0)
