"""The forward kinematics of the port's skinner (``models/skinner.py``),
one homogeneous build for all joints and then the chain, and its use in the
training step: one FK per pose set per pass, the geom pass's ray seeds with
no masked selection, and on the card no host sync from the geom pass to
the step's readback.  Imports neither JAX nor the JAX package, so that it also
runs on the card, where ``tests/conftest.py`` (which imports JAX) cannot
load:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_fk.py

Tolerance of the FK against the per-joint chain: rtol 1e-6, atol 1e-6.
Both multiply the same float32 4x4 matrices in the same order along every
path from the root; only the local transforms are built in one call, which
changes no value (they are copies of the rotations and offsets), so on the
card the test asks for the chain's bits.
"""
import dataclasses
import os.path as osp

import numpy as np
import pytest
import torch

from selfreconcode_tpu_torch.engine import surface as SURF
from selfreconcode_tpu_torch.engine import trainer as TTR
from selfreconcode_tpu_torch.models import deformer as DEF
from selfreconcode_tpu_torch.models import skinner as SK
from selfreconcode_tpu_torch.models.smpl import smpl_tmp_apose, toy_smpl_model
from selfreconcode_tpu_torch.render.camera import (Camera,
                                                   transform_points_screen)
from selfreconcode_tpu_torch.utils import trace
from selfreconcode_tpu_torch.utils.math import batch_rodrigues, make_homo

RES = {s: [(9, 9, 9), (17, 17, 17)] for s in ("coarse", "medium", "fine")}
# every module that calls the FK by its own name
FK_USERS = (SK, DEF, SURF, TTR)


def chain_fk(skinner, poses):
    """The FK one joint at a time, each joint's transform its parent's
    times its own."""
    B, n = poses.shape[0], len(skinner.parents)
    Rs = batch_rodrigues(poses.reshape(-1, 3)).reshape(B, n, 3, 3)
    J = skinner.joints
    results = [make_homo(Rs[:, 0], J[0].expand(B, 3))]
    for i in range(1, n):
        p = skinner.parents[i]
        results.append(results[p] @ make_homo(Rs[:, i],
                                              (J[i] - J[p]).expand(B, 3)))
    results = torch.stack(results, dim=1)
    return (torch.einsum("bjik,jkl->bjil", results, skinner.init_pose_inv),
            results)


@pytest.fixture(scope="module")
def skinner():
    return SK.build_skinner(toy_smpl_model(200), np.zeros(10, np.float32),
                            smpl_tmp_apose(0), resolution=(9, 17, 9))[0]


def random_tree_skinner(n_joints, seed):
    """A skinner whose tree is random: each joint's parent any earlier
    joint; its skeleton and A-pose inverses random too."""
    g = torch.Generator().manual_seed(seed)
    parents = (0,) + tuple(int(torch.randint(0, j, (1,), generator=g))
                           for j in range(1, n_joints))
    R = batch_rodrigues(torch.randn(n_joints, 3, generator=g))
    inv = make_homo(R, torch.randn(n_joints, 3, generator=g))
    return SK.Skinner(ws=torch.zeros(1, 8 * n_joints), ws_dims=(1, 1, 1),
                      b_min=-torch.ones(3), b_max=torch.ones(3),
                      joints=torch.randn(n_joints, 3, generator=g),
                      init_pose_inv=inv, parents=parents)


@pytest.mark.parametrize("B", [1, 3, 9])
def test_level_batched_fk_equals_the_joint_chain(skinner, B):
    """The FK (built in one call, then chained) against the chain that
    builds each joint's transform alone."""
    g = torch.Generator().manual_seed(B)
    poses = 0.5 * torch.randn(B, 24, 3, generator=g)
    A, results = SK.fk_transforms(skinner, poses)
    wantA, want = chain_fk(skinner, poses)
    torch.testing.assert_close(results, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(A, wantA, rtol=1e-6, atol=1e-6)


def test_fk_gradient_equals_the_joint_chain(skinner):
    """The one homogeneous build carries the chain's gradient (its backward
    gathers the joints' offsets and rotations in one call: rtol 1e-5)."""
    g = torch.Generator().manual_seed(7)
    poses = (0.5 * torch.randn(3, 24, 3, generator=g)).requires_grad_(True)
    w = torch.randn(3, 24, 4, 4, generator=g)
    grads = [torch.autograd.grad((fk(skinner, poses)[0] * w).sum(), poses)[0]
             for fk in (SK.fk_transforms, chain_fk)]
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_joints, seed", [(30, 0), (12, 1)])
def test_fk_follows_any_tree(n_joints, seed):
    sk = random_tree_skinner(n_joints, seed)
    g = torch.Generator().manual_seed(seed)
    poses = 0.5 * torch.randn(4, n_joints, 3, generator=g)
    for got, want in zip(SK.fk_transforms(sk, poses), chain_fk(sk, poses)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 30])
def test_fk_is_the_joint_chain_bit_for_bit_on_the_card(B):
    """On the card the FK keeps the chain's bits, which the first step of
    a training run needs to match a reference that runs the chain: it takes
    the chain's products, one (B,4,4) product a joint (cuBLAS rounds a
    batch of several joints' products otherwise at one pose set)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run this file on the card as its "
                    "docstring says)")
    sk = SK.build_skinner(toy_smpl_model(200), np.zeros(10, np.float32),
                          smpl_tmp_apose(0), resolution=(9, 17, 9),
                          device="cuda")[0]
    g = torch.Generator().manual_seed(B)
    poses = (0.3 * torch.randn(B, 24, 3, generator=g)).cuda()
    for got, want in zip(SK.fk_transforms(sk, poses), chain_fk(sk, poses)):
        assert torch.equal(got, want)


def test_make_homo_copies_nothing_from_the_host(monkeypatch):
    R = batch_rodrigues(torch.randn(5, 3))
    t = torch.randn(5, 3)

    def refused(*a, **kw):
        raise AssertionError("a tensor made from host values")

    monkeypatch.setattr(torch, "tensor", refused)
    monkeypatch.setattr(torch, "as_tensor", refused)
    H = make_homo(R, t)
    monkeypatch.undo()
    assert torch.equal(H[:, :3, :3], R) and torch.equal(H[:, :3, 3], t)
    assert torch.equal(H[:, 3], torch.tensor([0.0, 0, 0, 1]).expand(5, 4))


def _trainer(root, device="cpu", stage="coarse"):
    tr, ds = TTR.build_synthetic_trainer(str(root), n_frames=4, H=32, W=32,
                                         resolutions=RES, device=device)
    tr.set_stage(stage)
    tr.override_stage(sample_pix=16, eik_tmp=128, anchor_sub=256,
                      surf_iters=3, weights=dataclasses.replace(
                          tr.stage_cfg.weights, sample_pix_num=0))
    return tr, ds


def _step(tr, ds, i):
    fids = (np.arange(tr.stage_cfg.N) + i) % ds.frame_num
    return tr.train_step(fids, ds.batch_raw(fids), 1e-3)


def _wrap_fk(monkeypatch, wrapper):
    """Replace the FK by wrapper(FK) wherever a module calls it."""
    wrapped = wrapper(SK.fk_transforms)
    for mod in FK_USERS:
        if hasattr(mod, "fk_transforms"):
            monkeypatch.setattr(mod, "fk_transforms", wrapped)


@pytest.mark.parametrize("dct_weight, n_fk", [(None, 5), (0.0, 4)])
def test_a_step_runs_one_fk_per_pass(tmp_path, monkeypatch, dct_weight,
                                     n_fk):
    """geom, inner (its deform and the consistency term), the outer pass's
    prelude (the solve, detached) and body (the IFT correction and the
    Jacobian) and the DCT windows: 5 FKs, 4 without the DCT prior."""
    tr, ds = _trainer(tmp_path)
    assert tr.stage_cfg.weights.dct_weight > 0.0
    assert tr.stage_cfg.weights.def_consistent_weight > 0.0
    if dct_weight is not None:
        tr.override_stage(weights=dataclasses.replace(
            tr.stage_cfg.weights, dct_weight=dct_weight))
    _step(tr, ds, 0)                       # the stage's first step remeshes
    calls = []

    def counted(fk):
        def run(*a, **kw):
            calls.append(a[1].shape[0])
            return fk(*a, **kw)
        return run

    _wrap_fk(monkeypatch, counted)
    info = _step(tr, ds, 1)
    assert np.isfinite(info["loss"])
    assert len(calls) == n_fk, calls
    N, Nw = tr.stage_cfg.N, tr.stage_cfg.window
    assert calls[:4] == [N, N, N, N]       # the passes' poses
    if n_fk == 5:
        assert calls[4] == N * Nw          # the DCT windows


def _with_normals(scene, H, W):
    """Give the synthetic scene a normal map per frame (the outer pass's
    normal loss then runs)."""
    import cv2
    import os
    os.makedirs(osp.join(scene, "normals"), exist_ok=True)
    rng = np.random.default_rng(0)
    for name in sorted(os.listdir(osp.join(scene, "imgs"))):
        nrm = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        cv2.imwrite(osp.join(scene, "normals", name[:-3] + "png"), nrm)


def masked_point_seeds(cam, verts, def_verts):
    """``point_seeds`` as it was, with masked selections (four host reads a
    frame on the card)."""
    H, W = cam.H, cam.W
    nv = verts.shape[0]
    big = 3e38
    seed = torch.cat([verts, verts.new_zeros(1, 3)])
    inits, covers = [], []
    for dv in def_verts:
        s = transform_points_screen(cam, dv)
        col = torch.round(s[:, 0]).long()
        row = torch.round(s[:, 1]).long()
        z = s[:, 2]
        ok = (z > 0.0) & (col >= 0) & (col < W) & (row >= 0) & (row < H)
        pix = row.clamp(0, H - 1) * W + col.clamp(0, W - 1)
        zimg = torch.full((H * W,), big)
        zimg.scatter_reduce_(0, pix[ok], z[ok], "amin")
        win = ok & (z <= zimg[pix])
        vid = torch.full((H * W,), nv, dtype=torch.long)
        vid.scatter_reduce_(0, pix[win], torch.arange(nv)[win], "amin")
        covers.append((zimg < big).reshape(H, W))
        inits.append(seed[vid].reshape(H, W, 3))
    return torch.stack(inits), torch.stack(covers)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_point_seeds_equal_the_masked_selection(seed):
    """The seeds and the cover, bit for bit, of the masked-selection
    version, on frames with depth ties (vertices repeated, and vertices
    at one depth within one pixel), vertices off the image and vertices
    at or behind the camera."""
    g = torch.Generator().manual_seed(seed)
    H, W = 24, 40
    cam = Camera(torch.tensor([30.0, 31.0]), torch.tensor([19.5, 11.2]),
                 torch.eye(3), torch.tensor([0.0, 0.0, 2.5]), H, W)
    nv = 700
    verts = torch.randn(nv, 3, generator=g)
    frames = []
    for _ in range(2):
        dv = torch.randn(nv, 3, generator=g) * torch.tensor([1.6, 1.0, 0.3])
        dv[100:150] = dv[50:100]                      # the same point twice
        dv[150:200] = dv[200:250] + torch.tensor([1e-3, 0.0, 0.0])
        dv[250:300, 2] = -2.5 - torch.rand(50, generator=g)   # z <= 0
        dv[300, 2] = -2.5
        dv[300:350, :2] *= 8.0                        # off the image
        frames.append(dv)
    def_verts = torch.stack(frames)
    got = TTR.point_seeds(cam, verts, def_verts)
    want = masked_point_seeds(cam, verts, def_verts)
    s = transform_points_screen(cam, frames[0])
    assert (s[:, 2] <= 0).sum() >= 50 and (s[:, 0] < 0).any()
    assert want[1].any() and not want[1].all()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["fine", "coarse"])
def test_no_sync_from_the_geom_pass_to_the_readback(tmp_path, monkeypatch,
                                                    stage):
    """The second step of a fine stage (one frame) and of a coarse stage
    (three frames splatted), the first having captured the solve's and
    the outer pass's graphs and learnt the update's flags, under
    ``torch.cuda.set_sync_debug_mode("error")`` from the geom pass's start
    to the step's readback: a sync there raises.  The outer pass's body
    replays its graph there, so the FKs that run on the host are the geom
    pass's, the inner pass's and the solve's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run this file on the card as its "
                    "docstring says)")
    from selfreconcode_tpu_torch.data.dataset import make_synthetic_scene
    scene = osp.join(str(tmp_path), "scene")
    make_synthetic_scene(scene, n_frames=4, H=32, W=32)
    _with_normals(scene, 32, 32)
    tr, ds = _trainer(tmp_path, device="cuda", stage=stage)
    assert tr.stage_cfg.has_normals and tr.stage_cfg.weights.normal_weight > 0
    assert tr.stage_cfg.N == {"fine": 1, "coarse": 3}[stage]
    _step(tr, ds, 0)
    checking = {"on": False, "geom": 0, "fk": 0}

    def strict(fk):
        def run(*a, **kw):
            if checking["on"]:
                assert torch.cuda.get_sync_debug_mode() == 2     # "error"
                checking["fk"] += 1
            return fk(*a, **kw)
        return run

    class Span(trace.span):
        __slots__ = ()

        def __enter__(self):
            out = super().__enter__()
            if checking["on"] and self.name == "step.geom":
                checking["geom"] += 1
                torch.cuda.set_sync_debug_mode("error")
            return out

    readback = trace.tolist

    def tolist(t):
        torch.cuda.set_sync_debug_mode(0)
        return readback(t)

    _wrap_fk(monkeypatch, strict)
    monkeypatch.setattr(trace, "span", Span)
    monkeypatch.setattr(trace, "tolist", tolist)
    checking["on"] = True
    trace.read_and_clear()
    try:
        info = _step(tr, ds, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert checking == {"on": True, "geom": 1, "fk": 3}
    assert trace.read_and_clear()["counters"]["outer_graph_replays"] == 1
    assert np.isfinite(info["loss"]) and "normal_loss" in info


def test_a_step_whose_info_keys_change_raises(tmp_path):
    """The update learns the info keys at the step function's first step;
    a later step that sets others raises before the all-reduce, where it
    would otherwise drop a new key or report a missing one as 0."""
    tr, ds = _trainer(tmp_path)
    assert tr.stage_cfg.weights.dct_weight > 0.0
    assert "dct_loss" in _step(tr, ds, 0)
    # the step function reads the weights it was made with: take the DCT
    # prior off behind its back, so its key goes missing
    object.__setattr__(tr.stage_cfg.weights, "dct_weight", 0.0)
    with pytest.raises(RuntimeError, match="dct_loss"):
        _step(tr, ds, 1)
