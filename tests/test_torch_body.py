"""The port's synthetic body, SMPL pickle loader and asset search against the
JAX package's.

The body is numpy apart from its marching cubes, which each package runs in
its own framework on the CPU: the port's must give JAX's base mesh bit for
bit, or the longest-edge splits (ties broken in stable order) would build
another 6890-vertex mesh.  Tolerances: faces identical; vertices, weights,
regressor and blend bases atol 1e-6; every SMPLSchemaError message
identical (both loaders read the same file).

Run as a script, it measures the skinner build at the full volume
(129x225x65) on the default synthetic body, the port's CPU build against
JAX's:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_body.py
"""
import os.path as osp
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from selfreconcode_tpu.models import smpl as JSMPL
from selfreconcode_tpu.models import synthetic_body as JSB
from selfreconcode_tpu_torch.models import smpl as TSMPL
from selfreconcode_tpu_torch.models import synthetic_body as TSB

FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "weights")


def assert_bodies_equal(port, jax_model, atol=1e-6):
    np.testing.assert_array_equal(port.faces, np.asarray(jax_model.faces))
    np.testing.assert_array_equal(port.parents, np.asarray(jax_model.parents))
    for k in FIELDS:
        np.testing.assert_allclose(getattr(port, k),
                                   np.asarray(getattr(jax_model, k)),
                                   rtol=0, atol=atol, err_msg=k)


def test_base_mesh_is_jax_bit_for_bit():
    joints = TSB._skeleton_joints()
    np.testing.assert_array_equal(joints, JSB._skeleton_joints())
    tv, tf = TSB._mesh_body(joints, 40)
    jv, jf = JSB._mesh_body(joints, 40)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("n_verts,res", [(2000, 40), (6890, 72)])
def test_body_matches_jax(n_verts, res):
    port = TSB.synthetic_body_model(n_verts, res=res)
    jm = JSB.synthetic_body_model(n_verts, res=res)
    assert port.v_template.shape == (n_verts, 3)
    assert_bodies_equal(port, jm)
    # watertight and consistently oriented: each directed edge once, each
    # undirected edge in exactly two faces
    f = port.faces.astype(np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    assert len(np.unique(e[:, 0] << 32 | e[:, 1])) == len(e)
    _, counts = np.unique(e.min(1) << 32 | e.max(1), return_counts=True)
    assert (counts == 2).all()


def _small_pickle(tmp_path, name="neutral_smpl_with_cocoplus_reg.pkl"):
    path = str(tmp_path / name)
    TSB.save_smpl_pickle(TSB.synthetic_body_model(2000, res=40), path)
    return path


def test_pickle_round_trip_through_both_loaders(tmp_path):
    path = _small_pickle(tmp_path)
    with open(path, "rb") as f:
        raw = pickle.load(f, encoding="latin1")
    assert hasattr(raw["J_regressor"], "todense")
    assert raw["shapedirs"].shape == (2000, 3, 10)
    assert raw["kintree_table"][0, 0] == np.uint32(4294967295)
    port = TSMPL.load_smpl_pickle(path)
    assert_bodies_equal(port, JSMPL.load_smpl_pickle(path), atol=0)
    assert_bodies_equal(port, JSB.synthetic_body_model(2000, res=40))
    # the JAX writer's pickle reads the same
    jpath = str(tmp_path / "jax.pkl")
    JSB.save_smpl_pickle(JSB.synthetic_body_model(2000, res=40), jpath)
    assert_bodies_equal(TSMPL.load_smpl_pickle(jpath), port, atol=0)


def _transposed_jr(d):
    d["J_regressor"] = np.asarray(d["J_regressor"].todense()).T


CORRUPT = {
    "missing": lambda d: d.pop("weights"),
    "posedirs": lambda d: d.update(posedirs=d["posedirs"][..., :206]),
    "faces": lambda d: d.update(
        f=np.concatenate([d["f"], [[0, 1, d["v_template"].shape[0]]]])),
    "jreg": lambda d: d.update(
        J_regressor=np.zeros((d["v_template"].shape[0], 25))),
    "kintree": lambda d: d["kintree_table"].__setitem__((0, 5), 10),
    "wsum": lambda d: d.update(weights=d["weights"] * 2.0),
    "notdict": lambda d: d.clear(),
    "vtemplate": lambda d: d.update(v_template=d["v_template"][:, :2]),
    "shapedirs": lambda d: d.update(shapedirs=d["shapedirs"][:10]),
    "kintree_shape": lambda d: d.update(
        kintree_table=d["kintree_table"][:, :23]),
}


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_schema_errors_match_jax(tmp_path, case):
    with open(_small_pickle(tmp_path), "rb") as f:
        data = pickle.load(f, encoding="latin1")
    data["kintree_table"] = np.array(data["kintree_table"])
    CORRUPT[case](data)
    path = str(tmp_path / f"bad_{case}.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)
    with pytest.raises(TSMPL.SMPLSchemaError) as mine:
        TSMPL.load_smpl_pickle(path)
    with pytest.raises(JSMPL.SMPLSchemaError) as ref:
        JSMPL.load_smpl_pickle(path)
    assert str(mine.value) == str(ref.value)
    assert str(mine.value).startswith(path + ": ")


def test_plain_smpl_regressor_orientation_is_normalized(tmp_path):
    with open(_small_pickle(tmp_path), "rb") as f:
        data = pickle.load(f, encoding="latin1")
    _transposed_jr(data)
    path = str(tmp_path / "transposed.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)
    np.testing.assert_array_equal(
        TSMPL.load_smpl_pickle(path).j_regressor,
        np.asarray(JSMPL.load_smpl_pickle(path).j_regressor))


def test_get_smpl_search_order(tmp_path, monkeypatch):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    monkeypatch.setenv("SMPL_MODEL_DIR", str(b))
    with pytest.raises(FileNotFoundError) as e:
        TSMPL.get_smpl("female", model_dir=str(a))
    msg = str(e.value)
    tried = [str(a / "female_smpl_with_cocoplus_reg.pkl"),
             osp.join(osp.dirname(TSMPL.__file__), "assets",
                      "female_smpl_with_cocoplus_reg.pkl"),
             str(b / "female_smpl_with_cocoplus_reg.pkl")]
    assert all(p in msg for p in tried)
    assert [msg.index(p) for p in tried] == sorted(msg.index(p) for p in tried)
    # $SMPL_MODEL_DIR is found, and model_dir wins over it
    _small_pickle(b, "female_smpl_with_cocoplus_reg.pkl")
    assert TSMPL.get_smpl("female").v_template.shape == (2000, 3)
    TSB.save_smpl_pickle(TSMPL.toy_smpl_model(),
                         str(a / "female_smpl_with_cocoplus_reg.pkl"))
    assert TSMPL.get_smpl("female", model_dir=str(a)).v_template.shape == \
        (800, 3)
    monkeypatch.delenv("SMPL_MODEL_DIR")
    with pytest.raises(FileNotFoundError):
        TSMPL.get_smpl("female")


def measure_full_volume_skinner():
    """The skinner of the default synthetic body at the full volume
    (129x225x65), built by the port on the CPU and by JAX on the CPU:
    prints the weight tables' largest difference and how many table entries
    differ by more than 1e-3, and the largest distance between the two
    deformations under one pose, of the body's vertices and of points 3 cm
    off the body along its normals (where a trained template lies)."""
    import time

    import jax
    import torch
    from selfreconcode_tpu.models import skinner as JSK
    from selfreconcode_tpu_torch.models import skinner as TSK
    from selfreconcode_tpu_torch.models.smpl import smpl_tmp_apose
    from selfreconcode_tpu_torch.utils.meshops import vertex_normals

    res = (129, 225, 65)
    body = TSB.synthetic_body_model()
    pose = smpl_tmp_apose(1)
    t0 = time.perf_counter()
    tsk, tverts, faces = TSK.build_skinner(body, np.zeros(10, np.float32),
                                           pose, resolution=res)
    t1 = time.perf_counter()
    jsk, jverts, _ = JSK.build_skinner(JSB.synthetic_body_model(),
                                       jnp.zeros(10), pose, resolution=res,
                                       table_dtype=jnp.float32)
    jws = np.asarray(jax.block_until_ready(jsk.ws))
    t2 = time.perf_counter()
    tws = tsk.ws.numpy()
    d = np.abs(tws - jws)
    print(f"port CPU build {t1 - t0:.1f} s, JAX CPU build {t2 - t1:.1f} s")
    print(f"A-pose verts max |diff| "
          f"{np.abs(tverts.numpy() - np.asarray(jverts)).max():.3g} m")
    print(f"weight table max |diff| {d.max():.3g}; entries > 1e-3: "
          f"{int((d > 1e-3).sum())} of {d.size}")
    rng = np.random.default_rng(0)
    poses = (pose + rng.normal(0, 0.2, pose.shape)).astype(np.float32)
    trans = np.array([0.02, -0.01, 2.6], np.float32)
    vn = vertex_normals(tverts, torch.as_tensor(faces).long()).numpy()
    for label, pts in (("body vertices", tverts.numpy()),
                       ("points 3 cm off the body",
                        tverts.numpy() + 0.03 * vn)):
        pts = pts.astype(np.float32)
        jd = np.asarray(JSK.skinner_apply(
            jsk, jnp.asarray(pts), jnp.zeros(len(pts), jnp.int32),
            jnp.asarray(poses[None]), jnp.asarray(trans[None])))
        td = TSK.skinner_apply(tsk, torch.from_numpy(pts),
                               torch.zeros(len(pts), dtype=torch.long),
                               torch.from_numpy(poses[None]),
                               torch.from_numpy(trans[None])).numpy()
        print(f"{label}: posed max distance port vs JAX "
              f"{np.linalg.norm(td - jd, axis=-1).max():.3g} m")


if __name__ == "__main__":
    sys.exit(measure_full_volume_skinner())
