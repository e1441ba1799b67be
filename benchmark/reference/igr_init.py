"""IGR/SAL SDF pretraining to the A-pose body cloud (frozen copy of the port's
``selfreconcode_tpu_torch/engine/igr_init.py``): |sdf| + 1.0 * ||grad - n|| +
0.1 * eikonal, Adam lr 5e-3 halved every 500 steps, batch 5000, PE off."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .sdf import SDFNet, sdf_grad
from .sampling import sample_points


BATCH, LR, LR_STEP, LR_GAMMA = 5000, 5e-3, 500, 0.5
GLOBAL_SIGMA, LOCAL_SIGMA = 1.8, 0.01


def igr_pretrain(net: SDFNet, surface_pts: torch.Tensor,
                 surface_normals: torch.Tensor, n_iters: int = 1200,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Sequence] = None):
    """Fit `net` in place; returns a dict of the final losses.

    draws: optional per-iteration (idx, normal noise, uniform noise) in place
    of draws from `generator` (tests feed the JAX package's draws)."""
    opt = torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    v = surface_pts.shape[0]
    b = min(BATCH, v)
    dev = surface_pts.device
    for it in range(n_iters):
        for group in opt.param_groups:
            group["lr"] = LR * LR_GAMMA ** (it // LR_STEP)
        if draws is not None:
            idx, noise_n, noise_u = draws[it]
        else:
            idx = torch.randint(0, v, (b,), generator=generator, device=dev)
            noise_n = noise_u = None
        mnfld = surface_pts[idx]
        normals = surface_normals[idx]
        noise = None if noise_n is None else (noise_n, noise_u)
        nonmnfld = sample_points(mnfld, GLOBAL_SIGMA, LOCAL_SIGMA,
                                 generator=generator, noise=noise)
        opt.zero_grad(set_to_none=True)
        mnfld_pred = net(mnfld, 0.0)[0]
        grad_m = sdf_grad(net, mnfld, 0.0)
        grad_n = sdf_grad(net, nonmnfld, 0.0)
        mnfld_loss = mnfld_pred.abs().mean()
        eik = ((torch.linalg.norm(grad_n, dim=-1) - 1.0) ** 2).mean()
        nl = torch.linalg.norm(grad_m - normals, dim=-1).mean()
        loss = mnfld_loss + 0.1 * eik + nl
        loss.backward()
        opt.step()
    vals = torch.stack([loss, mnfld_loss, eik, nl]).detach().tolist()
    return dict(zip(("loss", "mnfld_loss", "grad_loss", "normals_loss"),
                    vals))
