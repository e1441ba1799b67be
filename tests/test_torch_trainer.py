"""Trainer-level behaviour of the port against the JAX package: the stage
switch and the loose-cloth config.

* ``set_stage`` resets ``forward_time`` to 0 as JAX's does
  (trainer.py:1254), so the new stage remeshes at its first step, at its
  own octree resolutions.  Both trainers run that step's bookkeeping with
  the real remesh and a stub in place of the step function (whose parity
  ``test_torch_step.py`` holds), on the JAX package's toy trainer scene.
* ``configs/config_loose.conf`` (as ``tests/test_loose_config.py`` runs it
  in JAX): two CPU steps on a 32x32 synthetic subject with normal maps
  freeze the principal point and T bit for bit, keep the normal loss off
  (its weight -0.1 <= 0) and move the focal length.
"""
import os.path as osp

import numpy as np
import pytest
import torch

from selfreconcode_tpu.engine import trainer as JTR
from selfreconcode_tpu_torch.config import parse_file
from selfreconcode_tpu_torch.data.dataset import SceneDataset
from selfreconcode_tpu_torch.engine import trainer as TTR
from selfreconcode_tpu_torch.models.sdf import SDFNet
from selfreconcode_tpu_torch.models.smpl import toy_smpl_model

CONFIGS = osp.join(osp.dirname(__file__), "..", "configs")
RES = {"coarse": [(9, 9, 9), (17, 17, 17)],
       "medium": [(9, 9, 9), (17, 17, 17), (33, 33, 33)],
       "fine": [(9, 9, 9), (17, 17, 17), (33, 33, 33)]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spy_remesh(trainer, calls):
    real = trainer.remesh

    def remesh(ratio):
        calls.append(tuple(tuple(r) for r in trainer.stage_cfg.resolutions))
        return real(ratio)
    trainer.remesh = remesh


def test_set_stage_resets_forward_time_as_jax(tmp_path):
    jtr, jds = JTR.build_synthetic_trainer(str(tmp_path / "j"), n_frames=4,
                                           H=32, W=32, resolutions=RES)
    jtr.mc_cap_floor = 4096
    ttr = TTR.Trainer(
        SceneDataset(str(tmp_path / "j" / "scene"),
                     {"deformer": 128, "renderer": 256}),
        toy_smpl_model(400), parse_file(osp.join(CONFIGS, "config.conf")),
        RES, skinner_res=(17, 29, 9), device="cpu")
    fids = np.array([0, 1])
    batch = jds.batch(fids)
    calls = {"jax": [], "port": []}
    for name, tr in (("jax", jtr), ("port", ttr)):
        tr.set_stage("coarse")
        tr.forward_time, tr.remesh_time = 7, 3.25   # mid-way through coarse
        tr.set_stage("medium")
        assert tr.forward_time == 0, name
        _spy_remesh(tr, calls[name])
    # one step each: the real remesh, a stub for the step function
    jtr._get_step_fn = lambda: (lambda state, *a: (state, {}))
    jtr._train_step_impl(fids, batch, 1e-3, None, sync=True)
    ttr._step_fn = lambda bank, tmp, *a: (tmp, {})
    ttr.train_step(fids, ttr.dataset.batch_raw(fids), 1e-3)
    medium = tuple(tuple(r) for r in RES["medium"])
    assert calls["jax"] == calls["port"] == [medium]
    assert ttr.remesh_time == jtr.remesh_time == 4.0
    assert ttr.forward_time == jtr.forward_time == 1
    assert ttr.tmp.topo.edges.shape[0] > 0


def test_loose_config_freezes_camera_and_skips_normal_loss(tmp_path):
    from selfreconcode_tpu_torch.data.synthetic_subject import \
        make_synthetic_subject
    from selfreconcode_tpu_torch.models.synthetic_body import \
        synthetic_body_model

    scene = str(tmp_path / "subject")
    make_synthetic_subject(scene, n_frames=4, H=32, W=32, n_verts=2000,
                           body_res=40, verbose=False, device="cpu")
    conf = parse_file(osp.join(CONFIGS, "config_loose.conf"))
    ds = SceneDataset(scene, {"deformer": 128, "renderer": 256})
    assert ds.has_normals
    tr = TTR.Trainer(ds, synthetic_body_model(2000, res=40), conf,
                     {s: RES["coarse"] for s in RES},
                     skinner_res=(17, 29, 9), device="cpu")
    tr.set_stage("coarse")
    tr.override_stage(sample_pix=16, eik_tmp=128, anchor_sub=256,
                      surf_iters=2)
    cfg = tr.stage_cfg
    assert cfg.opt_cam_focal and not cfg.opt_cam_principal
    assert not cfg.opt_cam_T and not cfg.opt_cam_quat
    assert cfg.weights.normal_weight == -0.1
    # in place of IGR (minutes at full width on one CPU thread): the SDF's
    # geometric init with bias 0.5, a sphere of radius ~0.27 in the box
    tr.nets.sdf.load_state_dict(SDFNet(multires=6, bias=0.5,
                                       seed=1).state_dict())
    cam0 = {k: v.detach().clone() for k, v in tr.bank.items()}
    for i in range(2):
        fids = np.array([(3 * i) % 4, (3 * i + 1) % 4, (3 * i + 2) % 4])
        info = tr.train_step(fids, ds.batch_raw(fids), 1e-3)
        assert "normal_loss" not in info
        assert all(np.isfinite(v) for v in info.values()), info
    for k in ("princeple_points", "world2cam_coord_trans",
              "cam2world_coord_quat"):
        assert torch.equal(tr.bank[k], cam0[k]), k
    assert (tr.bank["focal_length"] != cam0["focal_length"]).any()
