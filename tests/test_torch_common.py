"""Shared set-up of the slice-level parity tests (``test_torch_step.py``,
``test_torch_infer.py``): the JAX side's scene, narrow nets, toy skinner and
remeshed template, and their counterparts in the port.  No tests here.

The scene is the JAX package's 32x32 synthetic scene; the nets are narrow
(SDF 4x64, translator 2x64, colour 2x64) with JAX weights carried across by
``interop.py``; the template is the JAX remesh of the init SDF, padded like
the JAX trainer pads it (``nv``/``nf`` count the real rows).
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import torch

from selfreconcode_tpu.data.dataset import SceneDataset as JScene
from selfreconcode_tpu.data.dataset import make_synthetic_scene
from selfreconcode_tpu.engine import trainer as JTR
from selfreconcode_tpu.models import render as JR
from selfreconcode_tpu.models import sdf as JSDF
from selfreconcode_tpu.models import skinner as JSK
from selfreconcode_tpu.models import smpl as JSMPL
from selfreconcode_tpu.models import translator as JT
from selfreconcode_tpu.ops import marching_cubes as JMC
from selfreconcode_tpu.ops import sparse_sdf as JSS
from selfreconcode_tpu.render.camera import ang_threshold, make_camera
from selfreconcode_tpu_torch.engine import trainer as TTR
from selfreconcode_tpu_torch.interop import params_from_jax
from selfreconcode_tpu_torch.models.render import RenderNet
from selfreconcode_tpu_torch.models.sdf import SDFNet
from selfreconcode_tpu_torch.models.skinner import Skinner
from selfreconcode_tpu_torch.models.translator import TranslatorNet

H = W = 32
SDF_KW = dict(hidden=(64,) * 4, skip_in=(2,), multires=2, feature_size=16)
TR_KW = dict(cond_size=8, multires=2, hidden=(64, 64))
RN_KW = dict(feature_size=16, hidden=(64, 64), multires_v=2)
NET_KW = {"sdf": SDF_KW, "trans": TR_KW, "render": RN_KW}


def _round(x, m):
    return -(-x // m) * m


def jax_scene(root, res=None, depth_in_trans=False, half=0.8, hw=H):
    """The JAX side: scene, toy skinner, narrow nets and their params, the
    padded template (TemplateState) and the ray angle threshold.  `res` is
    the octree schedule of the template sweep (default: the JAX trainer's
    test schedule).  depth_in_trans moves the camera's 2.5 m offset from T
    into every frame's trans (the reference data's convention, which the
    port's generator writes); the images stay valid, camera-space geometry
    being the same."""
    scene = osp.join(root, "scene")
    make_synthetic_scene(scene, n_frames=4, H=hw, W=hw)
    if depth_in_trans:
        cam = dict(np.load(osp.join(scene, "camera.npz")))
        rec = dict(np.load(osp.join(scene, "smpl_rec.npz")))
        rec["trans"] = rec["trans"] + cam["T"]
        cam["T"] = np.zeros_like(cam["T"])
        np.savez(osp.join(scene, "camera.npz"), **cam)
        np.savez(osp.join(scene, "smpl_rec.npz"), **rec)
    ds = JScene(scene, conds_lens={"deformer": 8, "renderer": 16},
                use_native=False)
    jsk, _, _ = JSK.build_skinner(JSMPL.toy_smpl_model(400),
                                  jnp.asarray(ds.shape),
                                  JSMPL.smpl_tmp_apose(1),
                                  resolution=(17, 29, 9),
                                  table_dtype=jnp.float32)
    nets = (JSDF.SDFNet(**SDF_KW), JT.TranslatorNet(**TR_KW),
            JR.RenderNet(**RN_KW))
    params = {"sdf": JSDF.init_sdf_params(jax.random.PRNGKey(1), nets[0]),
              "trans": JT.init_translator_params(jax.random.PRNGKey(2),
                                                 nets[1]),
              "render": JR.init_render_params(jax.random.PRNGKey(3), nets[2])}
    # the template: the JAX remesh of the init SDF, padded like the trainer
    # swept over a cube that holds the whole init sphere (the toy body's bbox
    # is thinner than the sphere and would cut its front and back away)
    res = tuple(tuple(r) for r in (res or JTR._DEFAULT_TEST_RES))
    b_min, b_max = np.full(3, -half, np.float32), np.full(3, half, np.float32)
    spacing, origin = JSS.grid_world_coords(res[-1], b_min, b_max)
    vol = JSS.sparse_sdf_grid(
        lambda p: JSDF.sdf_value_only(params["sdf"], nets[0], p, 1.0), res,
        b_min, b_max, 0.0, JSS.default_caps(res))
    # extracted at iso 0.02, not 0: the SDF anchor term is mean |sdf(verts)|,
    # and on the zero set itself sign(sdf) flips on float32 noise between
    # the two frameworks, moving the gradient by far more than the tolerance
    mc = JMC.marching_cubes(vol, origin, spacing, 0.02, 40000, 80000, 20000)
    nv, nf = int(mc.nv), int(mc.nf)
    vcap, fcap = _round(nv, 1024), _round(nf, 1024)
    vv = np.arange(vcap) < nv
    fv = np.arange(fcap) < nf
    tmp = JTR.TemplateState(
        verts=jnp.asarray(np.where(vv[:, None],
                                   np.asarray(mc.verts)[:vcap], 0.0),
                          jnp.float32),
        vert_valid=jnp.asarray(vv),
        faces=jnp.asarray(np.where(fv[:, None], np.asarray(mc.faces)[:fcap],
                                   0), jnp.int32),
        face_valid=jnp.asarray(fv),
        edges=jnp.zeros((1024, 2), jnp.int32),
        edge_valid=jnp.zeros((1024,), bool),
        edge_faces=jnp.zeros((1024, 2), jnp.int32),
        ef_valid=jnp.zeros((1024,), bool),
        momentum=jnp.zeros((vcap, 3)))
    cp = ds.camera_params
    cam = make_camera(cp["focal_length"], cp["princeple_points"],
                      cp["cam2world_coord_quat"], cp["world2cam_coord_trans"],
                      hw, hw)
    return dict(ds=ds, jsk=jsk, nets=nets, params=params, tmp=tmp, nv=nv,
                nf=nf, res=res, vcap=vcap, fcap=fcap,
                ang=ang_threshold(cam, 0.5))


def port_nets(params_np):
    sd = params_from_jax(params_np)
    nets = TTR.AvatarNets(SDFNet(**SDF_KW, seed=None),
                          TranslatorNet(**TR_KW, seed=None),
                          RenderNet(**RN_KW, seed=None))
    nets.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return nets


def port_skinner(jsk):
    t = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    return Skinner(ws=t(jsk.ws), ws_dims=tuple(jsk.ws_dims), b_min=t(jsk.b_min),
                   b_max=t(jsk.b_max), joints=t(jsk.joints),
                   init_pose_inv=t(jsk.init_pose_inv),
                   parents=tuple(jsk.parents))


def port_template(s):
    """The JAX template's real rows as the port's exact-size Template."""
    return TTR.make_template(
        torch.tensor(np.asarray(s["tmp"].verts)[:s["nv"]]),
        torch.tensor(np.asarray(s["tmp"].faces)[:s["nf"]]).long())
