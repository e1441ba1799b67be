"""Spawned-rank bodies of ``test_torch_parallel.py`` (no tests here).

Spawned processes import this module by name to run its functions, so it
imports nothing of JAX: each rank saves ``'jax' in sys.modules`` with its
results, and the tests require it false.
"""
import dataclasses
import os.path as osp
import sys

import numpy as np
import torch

THREADS = 1
TINY_RES = [(9, 9, 9), (17, 17, 17)]
RESOLUTIONS = {s: TINY_RES for s in ("coarse", "medium", "fine")}
SKINNER_RES = (17, 29, 9)
CONF = osp.join(osp.dirname(__file__), "..", "configs", "config.conf")


def tune_cpu(tr):
    """Small sample counts and THREADS torch threads for a CPU run (the
    train CLI's tune hook: it runs on every rank before the steps)."""
    torch.set_num_threads(THREADS)
    tr.override_stage(sample_pix=16, eik_tmp=128, anchor_sub=256,
                      surf_iters=2, weights=dataclasses.replace(
                          tr.stage_cfg.weights, sample_pix_num=0))


def _join(rank, world, store):
    from selfreconcode_tpu_torch import parallel as D
    torch.set_num_threads(THREADS)
    D.init_dp(rank, world, "cpu", store)


def make_train_step_sharded(sdf_net, render_net, translator, skinner,
                            lr: float = 1e-4):
    """The explicit all-reduce layout of JAX's ``make_train_step_sharded``
    (its ``parallel/sharded.py``), over the port's nets and collectives.

    Returns step(bank, pts, batch_inds, rays, gt_colors) -> global loss, a
    float.  Each rank passes its contiguous share of the rays; the bank is
    {dcond, poses, trans} (replicated leaves with requires_grad).  The local
    loss is the squared colour error + 0.1 x eikonal + 0.01 x offset norm,
    summed over the share; the loss sums, the ray count and the gradients of
    the nets and the bank are summed over ranks in one all-reduce, divided
    by the global count, and every rank takes the same SGD step in place."""
    from selfreconcode_tpu_torch import parallel as D
    from selfreconcode_tpu_torch.models.deformer import deformer_apply
    from selfreconcode_tpu_torch.models.sdf import sdf_grad

    nets = (sdf_net, translator, render_net)

    def step(bank, pts, batch_inds, rays, gt_colors) -> float:
        leaves = [p for net in nets for p in net.parameters()]
        leaves += list(bank.values())
        for p in leaves:
            p.grad = None
        _, feat = sdf_net(pts, 1.0)
        grad = sdf_grad(sdf_net, pts, 1.0)
        nx = grad / torch.linalg.norm(grad, dim=-1,
                                      keepdim=True).clamp_min(1e-12)
        _, off = deformer_apply(translator, skinner, pts, batch_inds,
                                bank["dcond"], bank["poses"], bank["trans"],
                                1.0)
        colors = render_net(pts, nx, rays, feat, 1.0)
        # squared colour error, as JAX's: |x|'s derivative flips sign on
        # last-ulp differences between shard counts
        loss = (((colors - gt_colors) ** 2).sum(-1).sum()
                + 0.1 * ((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2).sum()
                + 0.01 * torch.linalg.norm(off, dim=-1).sum())
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        head = torch.stack([loss.detach(),
                            loss.new_tensor(float(pts.shape[0]))])
        D.allreduce_sum_([head] + grads)
        loss_sum, n = head.tolist()
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(lr * (g / n))
        return loss_sum / n

    return step


def sharded_step_rank(rank, world, store, payload, out_dir):
    """The port's make_train_step_sharded on this rank's share of the
    payload's rays; saves the loss and the updated nets and bank."""
    from selfreconcode_tpu_torch import parallel as D
    from selfreconcode_tpu_torch.models.render import RenderNet
    from selfreconcode_tpu_torch.models.sdf import SDFNet
    from selfreconcode_tpu_torch.models.translator import TranslatorNet
    _join(rank, world, store)
    try:
        kw = payload["kwargs"]
        sdf = SDFNet(**kw["sdf"], seed=None)
        trans = TranslatorNet(**kw["trans"], seed=None)
        render = RenderNet(**kw["render"], seed=None)
        for net, prefix in ((sdf, "sdf."), (trans, "deformer.defs.0."),
                            (render, "netRender.")):
            net.load_state_dict({k[len(prefix):]: torch.tensor(v)
                                 for k, v in payload["params"].items()
                                 if k.startswith(prefix)})
        bank = {k: torch.tensor(v, requires_grad=True)
                for k, v in payload["bank"].items()}
        step = make_train_step_sharded(sdf, render, trans,
                                         payload["skinner"], lr=1e-4)
        share = {k: D.share(torch.tensor(payload[k]))
                 for k in ("pts", "batch_inds", "rays", "gt")}
        loss = step(bank, share["pts"], share["batch_inds"].long(),
                    share["rays"], share["gt"])
        sd = {}
        for net, prefix in ((sdf, "sdf."), (trans, "deformer.defs.0."),
                            (render, "netRender.")):
            sd.update({prefix + k: v.detach().clone()
                       for k, v in net.state_dict().items()})
        torch.save({"loss": loss, "params": sd,
                    "bank": {k: v.detach() for k, v in bank.items()},
                    "jax": "jax" in sys.modules},
                   osp.join(out_dir, f"rank{rank}.pt"))
    finally:
        D.shutdown()


def avatar_nets(state_dict, kwargs):
    """The port's three nets at the widths of `kwargs` ({sdf, trans,
    render}), holding `state_dict` (numpy, the reference's names)."""
    from selfreconcode_tpu_torch.engine.trainer import AvatarNets
    from selfreconcode_tpu_torch.models.render import RenderNet
    from selfreconcode_tpu_torch.models.sdf import SDFNet
    from selfreconcode_tpu_torch.models.translator import TranslatorNet
    nets = AvatarNets(SDFNet(**kwargs["sdf"], seed=None),
                      TranslatorNet(**kwargs["trans"], seed=None),
                      RenderNet(**kwargs["render"], seed=None))
    nets.load_state_dict({k: torch.tensor(v) for k, v in state_dict.items()})
    return nets


def port_step(inp):
    """One step of the port's make_train_step on the inputs that
    ``test_torch_step.jax_step`` returns under "port_in"; the nets, the
    bank (each leaf's .grad the gradient the step used), the new template
    and the info."""
    from selfreconcode_tpu_torch.engine.trainer import make_train_step
    nets = avatar_nets(inp["state_dict"], inp["kwargs"])
    bank = {k: torch.tensor(v, requires_grad=True)
            for k, v in inp["bank"].items()}
    opt = torch.optim.Adam(list(nets.parameters()) + list(bank.values()),
                           lr=inp["lr"], betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(nets, inp["skinner"], inp["cfg"], inp["dctnull"],
                           inp["ang"], opt)
    new_tmp, info = step(bank, inp["tmp"], inp["img"], inp["mask"],
                         inp["nrm"], inp["fids"], inp["windows"],
                         (1.0, 0.5, 1.0), inp["lr"], inp["draws"])
    return dict(info=info, nets=nets, bank=bank, tmp=new_tmp)


def port_step_rank(rank, world, store, inp, out_dir):
    """port_step as one rank of a data-parallel step; saves the info, the
    nets, the bank, their gradients and the new template."""
    from selfreconcode_tpu_torch import parallel as D
    _join(rank, world, store)
    try:
        r = port_step(inp)
        leaves = {**{f"nets.{k}": p for k, p in r["nets"].named_parameters()},
                  **{f"bank.{k}": p for k, p in r["bank"].items()}}
        torch.save({"info": r["info"],
                    "values": {k: p.detach().clone()
                               for k, p in leaves.items()},
                    "grads": {k: p.grad.clone() for k, p in leaves.items()
                              if p.grad is not None},
                    "tmp": {"verts": r["tmp"].verts.clone(),
                            "momentum": r["tmp"].momentum.clone()},
                    "jax": "jax" in sys.modules},
                   osp.join(out_dir, f"rank{rank}.pt"))
    finally:
        D.shutdown()


def tiny_trainer(scene):
    """The train CLI's trainer on a toy body, with narrow nets: SDF 4x64,
    translator and colour 2x64 (full width takes minutes on a CPU), the
    coarse stage and small sample counts; every stage remeshes each
    step."""
    from selfreconcode_tpu_torch.config import parse_file
    from selfreconcode_tpu_torch.data.dataset import SceneDataset
    from selfreconcode_tpu_torch.engine.trainer import AvatarNets, Trainer
    from selfreconcode_tpu_torch.models.render import RenderNet
    from selfreconcode_tpu_torch.models.sdf import SDFNet
    from selfreconcode_tpu_torch.models.smpl import toy_smpl_model
    from selfreconcode_tpu_torch.models.translator import TranslatorNet
    conf = parse_file(CONF)
    tr = Trainer(SceneDataset(scene, {"deformer": 128, "renderer": 256}),
                 toy_smpl_model(400), conf, RESOLUTIONS,
                 skinner_res=SKINNER_RES, data_root=scene, device="cpu")
    tr.nets = AvatarNets(
        SDFNet(hidden=(64,) * 4, skip_in=(2,), multires=2, feature_size=16,
               bias=0.25, seed=1),
        TranslatorNet(cond_size=128, multires=2, hidden=(64, 64), seed=2),
        RenderNet(feature_size=16, hidden=(64, 64), multires_v=2, seed=3))
    tr.optimizer = tr._make_optimizer()
    tr.set_stage("coarse")
    tune_cpu(tr)
    tr.override_stage(remesh_intersect=1)
    return tr


def trainer_state(tr, info):
    """Everything the ranks must hold alike after a step, and the info."""
    return {"info": info,
            "nets": {k: v.detach().clone()
                     for k, v in tr.nets.state_dict().items()},
            "grads": {f"nets.{k}": p.grad.clone()
                      for k, p in tr.nets.named_parameters()
                      if p.grad is not None},
            "bank": {k: v.detach().clone() for k, v in tr.bank.items()},
            "tmp": {"verts": tr.tmp.verts.clone(),
                    "faces": tr.tmp.faces.clone(),
                    "momentum": tr.tmp.momentum.clone(),
                    "edges": tr.tmp.topo.edges.clone(),
                    "face_pairs": tr.tmp.topo.face_pairs.clone()},
            "adam": [{k: (v.clone() if torch.is_tensor(v) else v)
                      for k, v in st.items()}
                     for st in tr.optimizer.state.values()],
            "generator": tr.generator.get_state(),
            "bbox": (tr.b_min.copy(), tr.b_max.copy())}


def trainer_steps(scene, n_steps, lr, rank=None, world=None, store=None,
                  out_dir=None):
    """n_steps coarse steps of tiny_trainer on frames 0-2, a remesh before
    each; the state after each step.  With a rank: one rank of a
    data-parallel run (set_dp after the set-up, rank 0 first), saving
    its states to out_dir/rank<r>.pt."""
    from selfreconcode_tpu_torch import parallel as D
    if rank is not None:
        _join(rank, world, store)
    try:
        with D.main_first():
            tr = tiny_trainer(scene)
        if rank is not None:
            tr.set_dp()
        states = []
        for _ in range(n_steps):
            fids = np.array([0, 1, 2])
            info = tr.train_step(fids, tr.dataset.batch_raw(fids), lr)
            states.append(trainer_state(tr, info))
        if rank is not None:
            torch.save({"states": states, "jax": "jax" in sys.modules},
                       osp.join(out_dir, f"rank{rank}.pt"))
        return states
    finally:
        D.shutdown()


def trainer_steps_rank(rank, world, store, scene, n_steps, lr, out_dir):
    trainer_steps(scene, n_steps, lr, rank, world, store, out_dir)
