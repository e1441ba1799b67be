"""The step's passes, the synthetic trainer and the timing tools of the
port (``engine/trainer.py``: ``make_train_step``'s ``geom_pass`` /
``inner_pass`` / ``outer_pass``, ``build_synthetic_trainer``,
``build_synthetic_bench_step``, ``bench_throughput``;
``selfreconcode_tpu_torch/tools``: ``profile_step``, ``bench_outer``,
``bench_remesh``, ``parity_sweep``), on the CPU at a test's size.

* The three passes called in order, with the step's draws, give the
  step's template, info and gradients bit for bit (the same float32 ops in
  the same order on one CPU thread).
* The synthetic trainer against JAX's at 4 frames of 32x32: the same
  images and masks (the camera's distance sits in trans in the port and in
  T in JAX: their sum is held equal), the same sweep box, and, on JAX's
  SDF carried across, the same remesh: vertex and face counts equal, the
  vertices within ``test_torch_remesh.py``'s tolerance (1e-5 absolute for
  99.5% of them, 1e-4 for all; JAX's crossings on + boundary edges sit at
  the origin and are left out).
* bench_throughput returns a finite rate and JAX's detail keys.
* parity_sweep at the size of the JAX package's sweep-vs-dense test
  (11x14x8 -> 81x105x57, a 4x128 SDF fit by 100 IGR iterations to a
  2000-vertex body): 0 sign mismatches and the crossing-adjacent voxels
  within 1e-5 of the dense values.
* Every tool's main runs on the CPU (``--device cpu``) and refuses to run
  on ``--device cuda`` without a card.
"""
import dataclasses
import math
import os.path as osp

import cv2
import jax
import numpy as np
import pytest
import torch

from selfreconcode_tpu.engine import trainer as JTR
from selfreconcode_tpu_torch.engine import trainer as TTR
from selfreconcode_tpu_torch.interop import params_from_jax
from selfreconcode_tpu_torch.tools import (accept_report, acceptance_run,
                                           bench_infer, bench_outer,
                                           bench_remesh, compare_meshes,
                                           host_mask_eval, parity_sweep,
                                           profile_step)

RES = {s: [(9, 9, 9), (17, 17, 17)] for s in ("coarse", "medium", "fine")}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_counts(trainer):
    """Sample counts a CPU run can afford, in any stage."""
    trainer.override_stage(sample_pix=16, eik_tmp=128, anchor_sub=256,
                           surf_iters=2, weights=dataclasses.replace(
                               trainer.stage_cfg.weights, sample_pix_num=0))


def test_passes_in_order_are_the_step(tmp_path):
    """Two trainers built alike: one takes step(), the other runs
    geom_pass, inner_pass, ray_pixels and outer_pass with the same draws."""
    trainers = []
    for name in ("step", "passes"):
        tr, ds = TTR.build_synthetic_trainer(str(tmp_path / name),
                                             n_frames=4, H=32, W=32,
                                             resolutions=RES, device="cpu")
        tr.set_stage("coarse")
        small_counts(tr)
        tr.remesh(1.0)
        trainers.append((tr, ds))
    (ta, ds), (tb, _) = trainers
    np.testing.assert_array_equal(ta.tmp.verts.numpy(), tb.tmp.verts.numpy())
    fids = np.arange(ta.stage_cfg.N)
    gtCs, gtMs, gtNs, fids_t, windows = ta.step_batch(fids,
                                                      ds.batch_raw(fids))
    draws = TTR.draw_step_noise(ta.stage_cfg, ta.tmp.verts.shape[0],
                                ta.generator, "cpu")
    ratios = (1.0, 0.5, 1.0)
    new_a, info_a = ta._get_step_fn()(ta.bank, ta.tmp, gtCs, gtMs, gtNs,
                                      fids_t, windows, ratios, 1e-4, draws)

    step = tb._get_step_fn()
    tb.optimizer.zero_grad(set_to_none=False)
    init_pts, sel_ok, idx, mgtMs = step.geom_pass(tb.bank, tb.tmp, gtMs,
                                                  fids_t, ratios[1], draws)
    new_b, pc_loss, inner_info = step.inner_pass(tb.bank, tb.tmp, fids_t,
                                                 mgtMs, ratios[1])
    binds, rows, cols = step.ray_pixels(idx)
    outer, outer_info = step.outer_pass(tb.bank, new_b, gtCs, gtNs, fids_t,
                                        init_pts, sel_ok, rows, cols, binds,
                                        windows, ratios, draws)
    info_b = {**outer_info, **inner_info, "loss": outer + pc_loss}

    np.testing.assert_array_equal(new_a.verts.numpy(), new_b.verts.numpy())
    np.testing.assert_array_equal(new_a.momentum.numpy(),
                                  new_b.momentum.numpy())
    assert set(info_a) == set(info_b)
    for k, v in info_b.items():
        assert info_a[k] == float(v), k
    mask = TTR.grad_mask_tree(ta.bank, ta.stage_cfg)
    leaves_a = list(ta.nets.parameters()) + [
        v for k, v in ta.bank.items() if mask[k]]
    leaves_b = list(tb.nets.parameters()) + [
        v for k, v in tb.bank.items() if mask[k]]
    assert sum(p.grad is not None for p in leaves_a) > 10
    for pa, pb in zip(leaves_a, leaves_b):
        assert (pa.grad is None) == (pb.grad is None)
        if pa.grad is not None:
            np.testing.assert_array_equal(pa.grad.numpy(), pb.grad.numpy())


def test_synthetic_trainer_matches_jax(tmp_path):
    jtr, jds = JTR.build_synthetic_trainer(str(tmp_path / "j"), n_frames=4,
                                           H=32, W=32, resolutions=RES)
    jtr.mc_cap_floor = 4096
    ttr, tds = TTR.build_synthetic_trainer(str(tmp_path / "t"), n_frames=4,
                                           H=32, W=32, resolutions=RES,
                                           device="cpu")
    for f in range(4):
        for sub in ("imgs", "masks"):
            a, b = (cv2.imread(str(tmp_path / r / "scene" / sub / f"{f}.png"),
                               cv2.IMREAD_UNCHANGED) for r in ("j", "t"))
            np.testing.assert_array_equal(a, b)
    jcam, tcam = (np.load(str(tmp_path / r / "scene" / "camera.npz"))
                  for r in ("j", "t"))
    jrec, trec = (np.load(str(tmp_path / r / "scene" / "smpl_rec.npz"))
                  for r in ("j", "t"))
    np.testing.assert_array_equal(trec["poses"], jrec["poses"])
    np.testing.assert_allclose(trec["trans"] + tcam["T"],
                               jrec["trans"] + jcam["T"], atol=1e-7)
    for k in ("fx", "fy", "cx", "cy", "quat"):
        np.testing.assert_array_equal(tcam[k], jcam[k])
    np.testing.assert_allclose(ttr.b_min, jtr.b_min, atol=1e-6)
    np.testing.assert_allclose(ttr.b_max, jtr.b_max, atol=1e-6)

    sd = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                jtr.state.params))
    ttr.nets.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    for tr in (jtr, ttr):
        tr.set_stage("coarse")
    nv, nf = jtr.remesh(1.0)
    assert ttr.remesh(1.0) == (nv, nf) and nv > 0
    np.testing.assert_allclose(ttr.b_min, jtr.b_min, atol=1e-6)
    np.testing.assert_allclose(ttr.b_max, jtr.b_max, atol=1e-6)
    jv = np.asarray(jtr.state.tmp.verts)[:nv]
    tv = ttr.tmp.verts.numpy()
    ownerless = (jv == 0).all(1)
    err = np.abs(tv - jv).max(1)[~ownerless]
    assert (err <= 1e-5).mean() >= 0.995 and err.max() <= 1e-4, err.max()
    np.testing.assert_array_equal(ttr.tmp.faces.numpy(),
                                  np.asarray(jtr.state.tmp.faces)[:nf])


def test_bench_throughput_and_bench_step(tmp_path):
    rate, detail = TTR.bench_throughput(
        sample_rays=32, H=32, W=32, iters=2, n_batches=2,
        root=str(tmp_path), resolutions=RES["fine"], device="cpu")
    assert math.isfinite(rate) and rate > 0
    # JAX's bench_throughput returns these keys (trainer.py:1699-1701)
    assert set(detail) == {"step_s", "remesh_s", "remesh_intersect"}
    assert detail["remesh_intersect"] == 120          # the fine stage's
    run, args = TTR.build_synthetic_bench_step(
        sample_rays=32, H=32, W=32, root=str(tmp_path),
        resolutions=RES["fine"], device="cpu")
    assert run.trainer.stage_cfg.name == "fine"
    assert run.trainer.rays_per_step() == 32
    assert math.isfinite(run(*args))


def test_parity_sweep_small_is_sign_exact(capsys):
    """At the size of the JAX package's own sweep-vs-dense test
    (test_sparse_sdf.py: a 2000-vertex body, a 4x128 SDF, four levels up to
    81x105x57), with 100 IGR iterations."""
    out = parity_sweep.main(
        ["--stage", "fine", "--igr-iters", "100", "--device", "cpu"],
        resolutions=[(11, 14, 8), (21, 27, 15), (41, 53, 29), (81, 105, 57)],
        net_kw=dict(hidden=(128,) * 4, skip_in=(2,), feature_size=32),
        body_kw=dict(n_verts=2000, res=48))
    assert out["sign_mismatches"] == 0 and out["ok"]
    assert out["crossing_max_err"] < 1e-5
    assert out["crossing_adjacent_voxels"] > 1000
    assert 0 < out["sweep_queries"] < out["dense"]
    assert "RESULT stage=fine res=(81, 105, 57) sign_mismatches=0" in \
        capsys.readouterr().out


def test_timing_tools_run_on_cpu(tmp_path):
    """profile_step, bench_outer and bench_remesh through their entry
    points on the synthetic trainer at 32x32: every part timed by the host
    clock, the device numbers not measured."""
    common = ["--h", "32", "--root", str(tmp_path), "--device", "cpu"]
    prof = profile_step.main(common + ["--stage", "coarse", "--steps", "1"],
                             resolutions=RES, tune=small_counts)
    assert set(prof) == {"geom_pass", "inner_pass", "outer_pass", "sum",
                         "train_step"}
    outer = bench_outer.main(common + ["--stage", "fine", "--iters", "1"],
                             resolutions=RES, tune=small_counts)
    assert set(outer) == {"surface solve", "surface solve + IFT bwd",
                          "loss forward", "outer pass", "adam", "backward"}
    rem = bench_remesh.main(common + ["--stage", "fine", "--iters", "1"],
                            resolutions=RES)
    assert len(rem.pop("warm_remesh_ms")) == 1
    for t in (*prof.values(), *outer.values(), *rem.values()):
        assert math.isfinite(t["wall_ms"])
        assert t["span_ms"] is None and t["busy_ms"] is None


@pytest.mark.parametrize("tool,argv", [
    (acceptance_run, []), (accept_report, ["nowhere"]),
    (compare_meshes, ["a.ply", "b.npz"]), (host_mask_eval, []),
    (parity_sweep, []), (profile_step, []), (bench_outer, []),
    (bench_remesh, []), (bench_infer, [])])
def test_tools_refuse_to_run_without_cuda(tool, argv):
    """Every tool defaults to --device cuda and does not fall back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)
    assert osp.basename(tool.__file__)[:-3] == tool.__name__.rsplit(".")[-1]
