"""The training step's outer pass as a prelude and a body
(``engine/trainer.py``: ``outer_prelude``, ``outer_terms`` and its backward
``outer_body``), and on the card the body replayed as one CUDA graph.
Imports neither JAX nor the JAX package, so that it also runs on the card,
where ``tests/conftest.py`` (which imports JAX) cannot load:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_outer_graph.py

On the CPU the prelude and the body, run eagerly, are the outer loss as it
was before the split (kept here, ``outer_loss_as_it_was``) and its
backward, bit for bit.  On the card the graph runs the eager body's
kernels in the same order, so the card's tests ask for its bits too, under
deterministic algorithms: without them the per-frame means' ``index_add``
adds with atomics, in an order that no two runs share.
"""
import dataclasses
import os
import os.path as osp

import numpy as np
import pytest
import torch

from selfreconcode_tpu_torch import parallel as D
from selfreconcode_tpu_torch.engine import losses as L
from selfreconcode_tpu_torch.engine import trainer as TTR
from selfreconcode_tpu_torch.engine.surface import (SurfaceConfig,
                                                    surface_points)
from selfreconcode_tpu_torch.models.deformer import (deformer_jacobian,
                                                     point_jacobian)
from selfreconcode_tpu_torch.models.sdf import sdf_grad, sdf_value_and_grad
from selfreconcode_tpu_torch.models.skinner import (fk_transforms, frame_rows,
                                                    posed_skeleton)
from selfreconcode_tpu_torch.render.camera import cam_pos, view_rays
from selfreconcode_tpu_torch.utils import to_device, trace
from selfreconcode_tpu_torch.utils.math import (gm_robust, inv3x3,
                                                log_singular_values_sq_sum,
                                                normalize)
from selfreconcode_tpu_torch.utils.sampling import (sample_points,
                                                    subsample_mask_topk)

RES = {s: [(9, 9, 9), (17, 17, 17)] for s in ("coarse", "medium", "fine")}
FINER = ((9, 9, 9), (17, 17, 17), (33, 33, 33))


def outer_loss_as_it_was(tr, bank, new_tmp, gtCs, gtNs, fids, init_pts,
                         sel_ok, ray_rows, ray_cols, ray_binds, windows,
                         ratios, draws):
    """``make_train_step``'s outer loss before its split into a prelude and
    a body: one function with the solve inside it, the ratios as numbers
    and the template's subsamples taken where their terms need them."""
    cfg, w = tr.stage_cfg, tr.stage_cfg.weights
    N, H, W = cfg.N, cfg.H, cfg.W
    sdf_net, translator = tr.nets.sdf, tr.nets.translator
    render_net, skinner = tr.nets.netRender, tr.skinner
    surf_nets = (sdf_net, translator, skinner)
    surf_cfg = SurfaceConfig(n_iters=cfg.surf_iters,
                             athreshold_deg=tr.ang_thresh,
                             newton=cfg.surf_newton)
    dctnull_dev = to_device(tr.dctnull, skinner.joints.device)

    def frame_params(bank, fids):
        poses, trans = bank["poses"][fids], bank["trans"][fids]
        if not cfg.opt_pose:
            poses = poses.detach()
        if not cfg.opt_trans:
            trans = trans.detach()
        return poses, trans, bank["dcond"][fids], bank["rcond"][fids]

    def share_mean(v, n_all):
        return v.mean() * (v.shape[0] / n_all)

    def gt_normals(cam, gtNs, ray_binds, ray_rows, ray_cols):
        gtn = gtNs[ray_binds, ray_rows, ray_cols]
        R = cam.R
        gtn_w = torch.einsum("ij,nj->ni",
                             torch.stack([-R[:, 0], R[:, 1], -R[:, 2]], 1),
                             gtn)
        norms = torch.linalg.norm(gtn_w, dim=-1, keepdim=True)
        return gtn_w / norms.clamp_min(1e-4), norms[..., 0] > 1e-4

    r_sdf, r_def, r_ren = ratios
    cam = TTR.camera_from_bank(bank, H, W, cfg)
    poses, trans, dcond, _ = frame_params(bank, fids)
    new_verts = new_tmp.verts.detach()
    nv = new_verts.shape[0]
    n_rays = ray_rows.shape[0]
    info = {}
    pix = torch.stack([ray_cols.float(), ray_rows.float(),
                       torch.ones(n_rays, device=new_verts.device)], dim=-1)
    rays = view_rays(cam, pix)
    A = fk_transforms(skinner, poses)[0]
    pts, done = surface_points(
        surf_nets, surf_cfg, r_sdf, r_def, dcond, A, trans, rays,
        cam_pos(cam), init_pts, ray_binds)
    done = done & sel_ok
    info["ray_converged"] = done.sum()
    use_normals = cfg.has_normals and w.normal_weight > 0.0
    if use_normals:
        gtn_w, nok = gt_normals(cam, gtNs, ray_binds, ray_rows, ray_cols)
    else:
        nok = torch.zeros_like(done)
    with torch.no_grad():
        cnt_c = L.frame_counts(ray_binds, done, N)
        cnt_n = L.frame_counts(ray_binds, nok & done, N)
        D.allreduce_sum_([cnt_c, cnt_n])

    valid_v = torch.ones(nv, dtype=torch.bool, device=new_verts.device)
    tidx, _ = subsample_mask_topk(valid_v, TTR.n_eik_tmp(cfg, nv),
                                  scores=draws.eik_scores)
    base = torch.cat([D.all_gather_rows(pts.detach()), new_verts[tidx]],
                     dim=0)
    nonmnfld = sample_points(base, 1.8, 0.01,
                             noise=(draws.eik_normal, draws.eik_uniform))
    n_eik = nonmnfld.shape[0]
    nonmnfld = D.share(nonmnfld)
    g_eik = sdf_grad(sdf_net, nonmnfld, r_sdf)
    grad_loss = share_mean((torch.linalg.norm(g_eik, dim=-1) - 1.0) ** 2,
                           n_eik)
    info["grad_loss"] = grad_loss
    total = grad_loss * w.grad_weight

    if w.offset_weight > 0.0:
        M = nonmnfld.shape[0]
        bn = torch.arange(N, device=pts.device).repeat_interleave(M)
        off = translator.offset(nonmnfld.repeat(N, 1),
                                frame_rows(dcond, bn), r_def)
        off_l = share_mean(torch.linalg.norm(off, dim=-1), N * n_eik)
        info["offset_loss"] = off_l
        total = total + off_l * w.offset_weight

    if w.def_regu_weight > 0.0:
        jit_pts = sample_points(base, 1.8, 0.01, ratio=0,
                                noise=(draws.def_normal,))
        dr_pts = torch.cat([base, jit_pts], dim=0)
        n_dr = dr_pts.shape[0]
        dr_pts = D.share(dr_pts)
        M = dr_pts.shape[0]
        bd = torch.arange(N, device=pts.device).repeat_interleave(M)
        conds = frame_rows(dcond, bd)
        jac, _ = point_jacobian(
            lambda q: translator(q, conds, r_def)[0], dr_pts.repeat(N, 1))
        s2 = log_singular_values_sq_sum(jac)
        def_loss = share_mean(gm_robust(s2, w.def_regu_c, square=True),
                              N * n_dr)
        info["def_loss"] = def_loss
        total = total + def_loss * w.def_regu_weight

    main = D.is_main()
    if main and (cfg.opt_pose or cfg.opt_trans) and w.dct_weight > 0.0:
        wposes = bank["poses"][windows]
        if not cfg.opt_pose:
            wposes = wposes.detach()
        Nw = windows.shape[1]
        pj = posed_skeleton(skinner, wposes.reshape(N * Nw, 24, 3))
        dct_loss = L.dct_prior_loss(dctnull_dev, pj.reshape(N, Nw, 24, 3))
        info["dct_loss"] = dct_loss
        total = total + dct_loss * w.dct_weight

    _, g_pts, feat = sdf_value_and_grad(sdf_net, pts, r_sdf)
    nx = normalize(g_pts)
    jac_d, _ = deformer_jacobian(translator, skinner, pts, ray_binds,
                                 dcond, A, trans, r_def)
    jinv, inv_ok = inv3x3(jac_d)
    info["inv_ok"] = inv_ok.sum()
    crays = torch.einsum("nij,nj->ni", jinv, rays)
    crays = normalize(torch.where(inv_ok[:, None], crays, rays))

    if w.color_weight > 0.0:
        colors = render_net(pts, nx, crays, feat, r_ren)
        gt = gtCs[ray_binds, ray_rows, ray_cols]
        color_loss = L.color_l1_loss(colors, gt, ray_binds, done, cnt_c)
        info["color_loss"] = color_loss
        total = total + w.color_weight * color_loss

    if use_normals:
        with torch.no_grad():
            ndef = torch.einsum("nji,nj->ni", jinv, nx)
            ndef = torch.where(inv_ok[:, None], ndef,
                               torch.einsum("nij,nj->ni", jac_d, nx))
            ndef = normalize(ndef)
            if w.weighted_normal:
                wgt = ((-rays * ndef).sum(-1)).clamp(0.0, 1.0) ** 2
            else:
                wgt = torch.ones(n_rays, device=pts.device)
        gtn_c = torch.einsum("nji,nj->ni", jac_d, gtn_w)
        normal_loss = L.normal_loss(gtn_c, nx, wgt, ray_binds, nok & done,
                                    cnt_n)
        info["normal_loss"] = normal_loss
        total = total + w.normal_weight * normal_loss

    if main:
        if draws.anchor_scores is not None:
            aidx, avalid = subsample_mask_topk(
                valid_v, cfg.anchor_sub, scores=draws.anchor_scores)
            averts = new_verts[aidx]
        else:
            averts, avalid = new_verts, valid_v
        anchor = L.sdf_anchor_loss(sdf_net(averts, r_sdf)[0], avalid, 0.0)
        info["pc_loss_sdf"] = anchor
        total = total + anchor * w.pc_weight
    return total, info


def _with_normals(scene, H, W):
    """The synthetic scene with a normal map per frame (the outer pass's
    normal loss then runs)."""
    import cv2
    os.makedirs(osp.join(scene, "normals"), exist_ok=True)
    rng = np.random.default_rng(0)
    for name in sorted(os.listdir(osp.join(scene, "imgs"))):
        nrm = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        cv2.imwrite(osp.join(scene, "normals", name[:-3] + "png"), nrm)


def _trainer(root, stage, device, H, rays, **counts):
    """The synthetic trainer with normal maps, in `stage`, with `rays` rays
    a frame and the sample counts `counts`, remeshed."""
    from selfreconcode_tpu_torch.data.dataset import make_synthetic_scene
    scene = osp.join(str(root), "scene")
    make_synthetic_scene(scene, n_frames=4, H=H, W=H)
    _with_normals(scene, H, H)
    tr, ds = TTR.build_synthetic_trainer(str(root), n_frames=4, H=H, W=H,
                                         resolutions=RES, device=device)
    tr.set_stage(stage)
    _override(tr, rays, **counts)
    w = tr.stage_cfg.weights
    assert tr.stage_cfg.has_normals and w.normal_weight > 0.0
    assert w.dct_weight > 0.0 and tr.stage_cfg.opt_pose
    tr.remesh(1.0)
    return tr, ds


def _override(tr, rays, **counts):
    tr.override_stage(sample_pix=rays, weights=dataclasses.replace(
        tr.stage_cfg.weights, sample_pix_num=0), **counts)


def _outer_args(tr, ds, i):
    """Step i's geom and inner passes on frames i.., with its own draws
    and deformation ratio: the outer pass's arguments."""
    step, cfg = tr._get_step_fn(), tr.stage_cfg
    fids = (np.arange(cfg.N) + i) % ds.frame_num
    gtCs, gtMs, gtNs, fids_t, windows = tr.step_batch(fids,
                                                      ds.batch_raw(fids))
    draws = TTR.draw_step_noise(cfg, tr.tmp.verts.shape[0], tr.generator,
                                tr.device)
    assert draws.anchor_scores is not None
    # unsaturated ratios, all three: each net reads its band weights
    ratios = (0.9 - 0.05 * i, 0.55 + 0.1 * i, 0.8)
    tr.optimizer.zero_grad(set_to_none=False)
    init_pts, sel_ok, idx, mgtMs = step.geom_pass(tr.bank, tr.tmp, gtMs,
                                                  fids_t, ratios[1], draws)
    new_tmp = step.inner_pass(tr.bank, tr.tmp, fids_t, mgtMs, ratios[1])[0]
    binds, rows, cols = step.ray_pixels(idx)
    return (tr.bank, new_tmp, gtCs, gtNs, fids_t, init_pts, sel_ok, rows,
            cols, binds, windows, ratios, draws)


def _leaves(tr):
    return {**{f"nets.{k}": p for k, p in tr.nets.named_parameters()},
            **{f"bank.{k}": v for k, v in tr.bank.items()}}


def _grads(tr):
    return {k: None if p.grad is None else p.grad.clone()
            for k, p in _leaves(tr).items()}


def _set_grads(tr, grads):
    """Put the leaves' .grad back to `grads`, in place where a leaf has
    one (a graph adds into it there)."""
    for k, p in _leaves(tr).items():
        if grads[k] is None:
            p.grad = None
        elif p.grad is None:
            p.grad = grads[k].clone()
        else:
            p.grad.copy_(grads[k])


def _assert_same(a, b):
    (ta, ia, ga), (tb, ib, gb) = a, b
    assert torch.equal(ta, tb), (float(ta), float(tb))
    assert set(ia) == set(ib)
    for k in ia:
        assert torch.equal(ia[k], ib[k]), (k, ia[k], ib[k])
    assert set(ga) == set(gb)
    for k in ga:
        if ga[k] is None:
            assert gb[k] is None, k
        else:
            assert gb[k] is not None and torch.equal(ga[k], gb[k]), k


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("stage", ["fine", "coarse"])
def test_split_outer_pass_is_the_outer_loss_bit_for_bit(tmp_path, stage):
    """The prelude and then the body on its buffers, and the CPU's
    ``outer_pass``, against the outer loss as it was and its backward: the
    total, every info value and every leaf's .grad, after one step (fine:
    N=1, coarse: N=3 with the DCT prior over its windows; normal loss on)."""
    tr, ds = _trainer(tmp_path, stage, "cpu", 32, 16, eik_tmp=128,
                      anchor_sub=256, surf_iters=3)
    assert tr.stage_cfg.N == {"fine": 1, "coarse": 3}[stage]
    assert tr.tmp.verts.shape[0] > 256
    fids = np.arange(tr.stage_cfg.N)
    tr.train_step(fids, ds.batch_raw(fids), 1e-5)
    step = tr._get_step_fn()
    args = _outer_args(tr, ds, 1)
    inner = _grads(tr)
    total, info = outer_loss_as_it_was(tr, *args)
    total.backward()
    want = (total.detach(), {k: v.detach() for k, v in info.items()},
            _grads(tr))
    assert want[1]["ray_converged"] > 0 and want[1]["normal_loss"] > 0

    _set_grads(tr, inner)
    x = step.outer_prelude(*args)
    total, info = step.outer_body(tr.bank, x)
    _assert_same((total, info, _grads(tr)), want)

    _set_grads(tr, inner)
    trace.read_and_clear()
    total, info = step.outer_pass(*args)
    _assert_same((total, info, _grads(tr)), want)
    assert not {"outer_graph_captures", "outer_graph_replays"} & set(
        trace.read_and_clear()["counters"])


# -- on the card ------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run this file on the card as its "
                    "docstring says)")


@pytest.fixture
def deterministic(monkeypatch):
    """torch's deterministic algorithms, and cuBLAS's workspace setting
    that they ask for."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(was)


def _graph_counts():
    c = trace.read_and_clear()["counters"]
    return (c.get("outer_graph_captures", 0),
            c.get("outer_graph_replays", 0))


def _eager_then_graphed(tr, ds, i):
    """Step i's outer pass run eagerly (the prelude, then the body) and then
    as the step runs it, from the same gradients; asserts the two agree bit
    for bit, then takes Adam's step, so that the next step's parameters
    differ."""
    step = tr._get_step_fn()
    args = _outer_args(tr, ds, i)
    inner = _grads(tr)
    total, info = step.outer_body(tr.bank, step.outer_prelude(*args))
    eager = (total, info, _grads(tr))
    _set_grads(tr, inner)
    total, info = step.outer_pass(*args)
    _assert_same((total, info, _grads(tr)), eager)
    assert eager[1]["ray_converged"] > 0
    for g in tr.optimizer.param_groups:
        g["lr"] = 1e-5
    tr.optimizer.step()
    tr.tmp = args[1]


@pytest.mark.cuda
@pytest.mark.parametrize("stage, rays", [("fine", 6144), ("coarse", 2048)])
def test_graphed_outer_pass_is_the_eager_one_bit_for_bit(
        tmp_path, deterministic, stage, rays):
    """Fine (N=1, 6,144 rays) and coarse (N=3, 3x2,048 rays): two steps
    whose ratios, frames, draws and parameters differ; the first captures
    the graph and replays it, the second replays it."""
    _needs_card()
    tr, ds = _trainer(tmp_path, stage, "cuda", 128, rays, eik_tmp=256,
                      anchor_sub=512)
    trace.read_and_clear()
    for i in range(2):
        _eager_then_graphed(tr, ds, i)
    assert _graph_counts() == (1, 1)


@pytest.mark.cuda
def test_a_remesh_and_new_storage(tmp_path, deterministic):
    """A remesh to another vertex count replays the graph (only the
    template's fixed-size subsamples enter it); leaves whose .grad was set
    to None, a checkpoint load and a new optimizer capture anew, and each
    capture's first replay is the eager pass's bits."""
    from selfreconcode_tpu_torch.engine.checkpoint import (load_checkpoint,
                                                           save_checkpoint)
    _needs_card()
    tr, ds = _trainer(tmp_path, "fine", "cuda", 64, 512, eik_tmp=256,
                      anchor_sub=512)
    trace.read_and_clear()
    _eager_then_graphed(tr, ds, 0)
    nv = tr.tmp.verts.shape[0]
    mc = tr.discretize_sdf(1.0, resolutions=FINER)
    tr.tmp = TTR.make_template(mc.verts, mc.faces)
    assert tr.tmp.verts.shape[0] not in (nv, 0)
    _eager_then_graphed(tr, ds, 1)
    assert _graph_counts() == (1, 1)

    tr.optimizer.zero_grad(set_to_none=True)      # new .grad storage
    _eager_then_graphed(tr, ds, 2)
    assert _graph_counts() == (1, 0)

    path = osp.join(str(tmp_path), "ckpt.pt")
    save_checkpoint(path, tr, 0)
    load_checkpoint(path, tr)                     # a new step function
    _override(tr, 512, eik_tmp=256, anchor_sub=512)
    _eager_then_graphed(tr, ds, 3)
    _eager_then_graphed(tr, ds, 4)
    assert _graph_counts() == (1, 1)

    tr.optimizer = tr._make_optimizer()           # as the SDF fit does
    tr._step_fn = None
    _eager_then_graphed(tr, ds, 5)
    assert _graph_counts() == (1, 0)
