"""The port's synthetic subject against the JAX package's generator.

Both render a 3-frame 48x48 subject of the 2000-vertex synthetic body (JAX
through its Pallas rasterizer in interpret mode, the port through the mesh
kernel's plain version).  The port keeps the 2.6 m camera distance in each
frame's trans instead of the camera's T, so camera-space geometry, and the
pixels, are the same.  Tolerances: masks equal on >= 99.9% of pixels;
images and normal maps within 2 levels of 255 where both hit; the pieces
(poses, canonical mesh, clothing, subdivision) exact or atol 1e-6.  The
manifest and the done-marker are written after the last frame: a render
interrupted at frame 1 leaves neither.  The trainer's raster footprint,
which reads the body's depth from the camera's T in JAX and from T plus
trans in the port, comes out the same on the two subjects.
"""
import json
import os.path as osp
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from selfreconcode_tpu.data import synthetic_subject as JSS
from selfreconcode_tpu.data.dataset import SceneDataset as JaxSceneDataset
from selfreconcode_tpu.engine.trainer import Trainer as JaxTrainer
from selfreconcode_tpu_torch.config import parse_file
from selfreconcode_tpu_torch.data import synthetic_subject as TSS
from selfreconcode_tpu_torch.data.dataset import SceneDataset
from selfreconcode_tpu_torch.engine.trainer import Trainer
from selfreconcode_tpu_torch.models.synthetic_body import synthetic_body_model

KW = dict(n_frames=3, H=48, W=48, n_verts=2000, body_res=40, verbose=False)


@pytest.fixture(scope="module")
def subjects(tmp_path_factory):
    root = tmp_path_factory.mktemp("subject")
    JSS.make_synthetic_subject(str(root / "jax"), **KW)
    TSS.make_synthetic_subject(str(root / "port"), device="cpu", **KW)
    return root / "jax", root / "port"


def _read(root, sub, fid):
    return cv2.imread(str(root / sub / f"{fid}.png")).astype(np.int64)


def test_frames_match_jax(subjects):
    jroot, proot = subjects
    for fid in range(KW["n_frames"]):
        jm, pm = _read(jroot, "masks", fid)[..., 0], _read(proot, "masks",
                                                           fid)[..., 0]
        assert (jm > 0).sum() > 100
        assert (jm == pm).mean() >= 0.999
        both = (jm > 0) & (pm > 0)
        for sub in ("imgs", "normals"):
            d = np.abs(_read(jroot, sub, fid) - _read(proot, sub, fid))
            assert d[both].max() <= 2, (sub, fid, d[both].max())
            assert (_read(proot, sub, fid)[pm == 0] == 0).all()


def test_scene_files_match_jax(subjects):
    jroot, proot = subjects
    jr, pr = np.load(jroot / "smpl_rec.npz"), np.load(proot / "smpl_rec.npz")
    np.testing.assert_array_equal(pr["poses"], jr["poses"])
    np.testing.assert_array_equal(pr["trans"], jr["trans"] + TSS.DISTANCE)
    jc, pc = np.load(jroot / "camera.npz"), np.load(proot / "camera.npz")
    for k in ("fx", "fy", "cx", "cy", "quat"):
        np.testing.assert_array_equal(pc[k], jc[k])
    np.testing.assert_allclose(pc["T"] + TSS.DISTANCE, jc["T"], atol=1e-7)
    jg, pg = np.load(jroot / "gt_mesh.npz"), np.load(proot / "gt_mesh.npz")
    np.testing.assert_array_equal(pg["faces"], jg["faces"])
    np.testing.assert_allclose(pg["verts"], jg["verts"], atol=1e-6)
    np.testing.assert_allclose(pg["cloth"], jg["cloth"], atol=1e-6)
    assert json.loads((proot / "subject_manifest.json").read_text()) == \
        json.loads((jroot / "subject_manifest.json").read_text())
    assert (proot / "subject_done.json").is_file()


def test_stage_footprint_matches_jax(subjects):
    jroot, proot = subjects
    res = {s: [(9, 9, 9), (17, 17, 17)] for s in ("coarse", "medium", "fine")}
    conf = parse_file(osp.join(osp.dirname(__file__), "..", "configs",
                               "config.conf"))
    tr = Trainer(SceneDataset(str(proot), {"deformer": 128, "renderer": 256}),
                 synthetic_body_model(2000, res=40), conf, res,
                 skinner_res=(17, 29, 9), device="cpu")
    tr.set_stage("coarse")
    # JAX's method on JAX's subject, with the port's sweep box
    jtr = SimpleNamespace(b_min=tr.b_min, b_max=tr.b_max,
                          dataset=JaxSceneDataset(str(jroot), use_native=False))
    jtr._host_camera = lambda: JaxTrainer._host_camera(jtr)
    jfp = JaxTrainer._stage_footprint(jtr, res["coarse"])
    assert tr.stage_cfg.raster_footprint == jfp
    assert 6 < jfp < 32     # clipped at neither end: the depth decides it


def test_pieces_match_jax():
    rng = np.random.default_rng(0)
    faces = rng.integers(0, 50, (80, 3)).astype(np.int32)
    je, jf = JSS.subdiv_topology(faces, 50)
    te, tf = TSS.subdiv_topology(faces, 50)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tf, jf)
    v = rng.normal(size=(200, 3)).astype(np.float32)
    n = rng.normal(size=(200, 3)).astype(np.float32)
    np.testing.assert_array_equal(TSS.clothing_offsets(v, n, seed=3),
                                  JSS.clothing_offsets(v, n, seed=3))


def test_manifest_is_written_last(tmp_path, monkeypatch):
    root = tmp_path / "s"
    kw = dict(KW, n_frames=3, H=24, W=24)
    TSS.make_synthetic_subject(str(root), device="cpu", **kw)
    manifest = json.loads((root / "subject_manifest.json").read_text())
    assert manifest["seed"] == 0 and (root / "subject_done.json").is_file()
    # same parameters: a complete earlier render is kept, frame for frame
    stamp = (root / "masks" / "1.png").stat().st_mtime_ns
    TSS.make_synthetic_subject(str(root), device="cpu", **kw)
    assert (root / "masks" / "1.png").stat().st_mtime_ns == stamp

    # another seed, interrupted while writing frame 1: nothing may claim the
    # root, though frame 0 of the new run and frames 1-2 of the old one exist
    real = cv2.imwrite

    def interrupted(path, img, *a):
        if path.endswith("masks/1.png"):
            raise KeyboardInterrupt
        return real(path, img, *a)

    monkeypatch.setattr(TSS.cv2, "imwrite", interrupted)
    with pytest.raises(KeyboardInterrupt):
        TSS.make_synthetic_subject(str(root), device="cpu", seed=1, **kw)
    assert not (root / "subject_manifest.json").exists()
    assert not (root / "subject_done.json").exists()
    monkeypatch.setattr(TSS.cv2, "imwrite", real)
    # the rerun renders every frame again, then claims the root
    TSS.make_synthetic_subject(str(root), device="cpu", seed=1, **kw)
    assert (root / "masks" / "1.png").stat().st_mtime_ns != stamp
    assert json.loads((root / "subject_manifest.json").read_text())[
        "seed"] == 1
    assert (root / "subject_done.json").is_file()
