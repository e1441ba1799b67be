"""The port's acceptance flow (``selfreconcode_tpu_torch/tools``:
``acceptance_run``, ``accept_report``, ``compare_meshes``,
``host_mask_eval``, and ``bench_infer`` (with and without
--no-early-exit) / ``profile_step --data`` on its checkpoint) on the CPU, at a 32x32 subject of 6 frames, and against the
repository's own tools (loaded by path, as ``test_torch_ab_tools.py``
does).

* acceptance_run end to end: the subject, three stages in three epochs (2
  coarse, 3 medium and 6 fine steps at small sample counts), inference of 2
  frames, errors.txt, the canonical ground truth and the report; the last
  line printed is the returned JSON.
* accept_report: the port's report is the root tool's, character for
  character, on the train log of that run and on a log where a resumed
  run redid an epoch (its duplicated steps: the last sample wins); the
  train CLI's lines are held to the tool's regexes (every step and epoch
  parsed).
* compare_meshes: the port's JSON line is the root tool's on the same
  ``.ply`` / ``.npz`` pair (same sampling seeds, same cKDTree).
* The pose defect of the JAX flow: the clothed ground truth posed into the
  canonical pose against itself reads 0 on identical samples and only the
  sampling floor with the tool's two seeds (2.06 mm Chamfer-L1 at 100k
  samples), against the zero-pose gt_mesh.npz it reads 48.5 mm (normal
  consistency 0.80: the arms' 55 degree pose gap), over 15 times the
  floor.
* coverage_fill is bitwise the root tool's on random, degenerate and
  off-screen triangles; the CPU-rendered training masks miss at most 2% of
  the exact silhouette (the mesh kernel's plain version against an exact
  fill, edge pixels only at 32x32) and add at most 2% outside it.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os.path as osp
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from selfreconcode_tpu_torch.models.sdf import SDFNet
from selfreconcode_tpu_torch.tools import accept_report as AR
from selfreconcode_tpu_torch.tools import acceptance_run as ACC
from selfreconcode_tpu_torch.tools import bench_infer as BI
from selfreconcode_tpu_torch.tools import compare_meshes as CM
from selfreconcode_tpu_torch.tools import host_mask_eval as HME
from selfreconcode_tpu_torch.tools import profile_step as PS

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
RES = {s: [(9, 9, 9), (17, 17, 17)] for s in ("coarse", "medium", "fine")}
FRAMES = 6


def root_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", osp.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_counts(trainer):
    """Sample counts a CPU run can afford, in any stage."""
    trainer.override_stage(sample_pix=16, eik_tmp=128, anchor_sub=256,
                           surf_iters=2, weights=dataclasses.replace(
                               trainer.stage_cfg.weights, sample_pix_num=0))


def stdout_of(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args, **kw)
    return ret, buf.getvalue()


@pytest.fixture(scope="module")
def accepted(tmp_path_factory):
    """acceptance_run on a 6-frame 32x32 subject with an IGR cache (the
    SDF's geometric init, bias 0.5) and the stages at epochs 0 / 1 / 2:
    (root, conf path, summary, stdout)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    base = tmp_path_factory.mktemp("accept")
    root = base / "subject"
    root.mkdir()
    torch.save(SDFNet(multires=6, bias=0.5, seed=1).state_dict(),
               root / "initial_sdf_idr_6_1_torch.pt")
    conf = open(osp.join(REPO, "configs", "config.conf")).read()
    for a, b in (("start_epoch = 6", "start_epoch = 1"),
                 ("start_epoch = 12", "start_epoch = 2")):
        assert conf.count(a) == 1
        conf = conf.replace(a, b)
    (base / "c.conf").write_text(conf)
    out, text = stdout_of(
        ACC.main, [str(root), str(FRAMES), "2", "--conf",
                   str(base / "c.conf"), "--h", "32", "--infer-frames", "2",
                   "--device", "cpu"],
        resolutions=RES, skinner_res=(17, 29, 9), tune=small_counts)
    yield root, base / "c.conf", out, text
    torch.set_num_threads(n)


def test_acceptance_run_on_cpu(accepted):
    root, _, out, text = accepted
    assert json.loads(text.strip().splitlines()[-1]) == json.loads(
        json.dumps(out))
    for f in ("train.log", "gt_canonical.npz", "rec/latest.pt",
              "rec/tmp.ply", "rec/errors.txt", "subject_done.json"):
        assert (root / f).is_file(), f
    # 6 frames: 2 coarse steps (N = 3), 3 medium (N = 2), 6 fine (N = 1)
    assert out["projected_from"] == {"coarse": 2, "medium": 3, "fine": 6}
    assert out["projected_steps"] == {"coarse": 6 * 150, "medium": 6 * 225,
                                      "fine": 189 * 450}
    assert all(len(out["stages"][s]["epoch_s"]) == 1 for s in out["stages"])
    for k in ("maskE_mean", "maskE_max", "maskE_min", "normal_consistency"):
        assert 0.0 <= out[k] <= 1.0, k
    for k in ("chamfer_l1_mm", "chamfer_l2_mm2", "projected_h", "train_s",
              "infer_s"):
        assert math.isfinite(out[k]) and out[k] > 0, k
    assert "TRAIN WALL-CLOCK" in text and "projected onto" in text


def test_accept_report_matches_root_tool(accepted, tmp_path):
    root, _, _, _ = accepted
    log = (root / "train.log").read_text()
    samples, epochs = AR.parse_log(str(root / "train.log"))
    assert [e for e, _ in samples] == [0] * 2 + [1] * 3 + [2] * 6
    assert sorted(epochs) == [0, 1, 2]
    # a resumed run appends to the log and redoes epoch 2 with other stamps
    resumed = tmp_path / "resumed"
    (resumed / "rec").mkdir(parents=True)
    shutil.copyfile(root / "rec" / "errors.txt",
                    resumed / "rec" / "errors.txt")
    redo = log[log.index("(2/0): loss"):]
    redo = re.sub(r"([0-9.]+)s/it", lambda m: f"{float(m[1]) + 0.5:.2f}s/it",
                  redo)
    (resumed / "train.log").write_text(log + redo)
    ref = root_tool("accept_report")
    for r in (root, resumed):
        for flags in ([], ["--medium", "1", "--fine", "2", "--frames", "6",
                           "--epochs-total", "2"]):
            want = stdout_of(ref.main, [str(r)] + flags)
            got = stdout_of(AR.main, [str(r)] + flags + ["--device", "cpu"])
            assert got == want
    assert AR.parse_log(str(resumed / "train.log"))[0][-4:] != samples[-4:]


def test_compare_meshes_matches_root_tool(accepted, monkeypatch):
    root, _, _, _ = accepted
    pair = [str(root / "rec" / "tmp.ply"), str(root / "gt_mesh.npz"),
            "--samples", "20000"]
    monkeypatch.setattr(sys, "argv", ["compare_meshes.py"] + pair)
    _, want = stdout_of(root_tool("compare_meshes").main)
    got, text = stdout_of(CM.main, pair + ["--device", "cpu"])
    assert text == want
    assert json.loads(want) == got


def test_canonical_gt_removes_the_pose_gap(accepted):
    root, _, _, _ = accepted
    canon = CM.load_mesh(str(root / "gt_canonical.npz"))
    zero = CM.load_mesh(str(root / "gt_mesh.npz"))
    np.testing.assert_array_equal(canon[1], zero[1])
    p, n = CM.sample_surface(*canon, 20000, seed=0)
    d, cos = CM.nn_dist_and_normal(p, n, p, n)
    assert d.max() == 0.0 and cos.min() > 1 - 1e-9
    floor = CM.compare(canon, canon)
    gap = CM.compare(canon, zero)
    assert floor["chamfer_l1_mm"] < 2.5 and floor["normal_consistency"] > 0.99
    assert gap["chamfer_l1_mm"] > 15 * floor["chamfer_l1_mm"]
    assert 40.0 < gap["chamfer_l1_mm"] < 60.0, gap
    assert gap["normal_consistency"] < 0.9, gap


def test_coverage_fill_matches_root_tool():
    ref = root_tool("host_mask_eval").coverage_fill
    rng = np.random.default_rng(3)
    H, W = 48, 40
    xy = rng.uniform(-20, 60, (300, 2))
    faces = rng.integers(0, 300, (400, 3))
    faces[:20, 1] = faces[:20, 0]                       # degenerate: a line
    xy[:10] = xy[10:20]                                 # coincident points
    xy[290:] += 500.0                                   # off-screen
    faces[380:] = rng.integers(290, 300, (20, 3))
    small = xy[faces].max(1) - xy[faces].min(1)
    keep = small.max(1) < 60                            # bbox under 64 px
    for cols in (faces[keep], faces[keep][:, ::-1]):    # both windings
        np.testing.assert_array_equal(HME.coverage_fill(xy, cols, H, W),
                                      ref(xy, cols, H, W))
    assert HME.coverage_fill(xy, faces[keep], H, W).any()


def test_host_mask_eval_on_cpu(accepted):
    root, _, _, _ = accepted
    shutil.rmtree(root / "masks_clean", ignore_errors=True)
    only, _ = stdout_of(HME.main, ["--root", str(root), "--masks-only",
                                   "--device", "cpu"])
    assert only["frames"] == FRAMES and "maskE_clean_mean" not in only
    assert only["hole_fraction"] <= 0.02 and only["excess_fraction"] <= 0.02
    out, _ = stdout_of(HME.main, ["--root", str(root), "--frames", "2",
                                  "--device", "cpu"])
    assert out["frames"] == 2
    for k in ("maskE_clean_mean", "maskE_clean_max", "maskE_clean_min",
              "maskE_dirty_mean"):
        assert 0.0 <= out[k] <= 1.0, k
    lines = (root / "rec" / "errors_clean.txt").read_text().splitlines()
    assert lines[0].startswith("maskE, mean: ") and lines[1] == "maskE:"
    assert len(lines) == 2 + FRAMES and lines[-1] == f"{FRAMES - 1}: -1.000000"


def test_bench_infer_and_restored_profile_on_cpu(accepted):
    root, conf, _, _ = accepted
    runs = [stdout_of(BI.main, ["--data", str(root), "--frames", "2",
                                "--device", "cpu"] + flag,
                      resolutions=RES)[0]
            for flag in ([], ["--no-early-exit"])]
    for frames in runs:
        assert [f["fid"] for f in frames] == [0, 3]
        assert all(0.0 <= f["mask_err"] <= 1.0 and f["s"] > 0
                   for f in frames)
    # all 30 iterations move no converged point: the same hit pixels, and
    # every early-exit convergence holds
    for a, b in zip(*runs):
        assert a["hit_pixels"] == b["hit_pixels"]
        assert b["converged_pixels"] >= a["converged_pixels"]
    prof, text = stdout_of(PS.main, ["--data", str(root), "--conf",
                                     str(conf), "--steps", "1", "--device",
                                     "cpu"], resolutions=RES,
                           tune=small_counts)
    assert "stage fine" in text and math.isfinite(prof["sum"]["wall_ms"])
