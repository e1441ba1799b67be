"""Data-parallel training of the port on the CPU: ranks are spawned
processes over gloo (``parallel/sharded.py``, ``--mesh dp=N``).

* (a) JAX's toy ``make_train_step_sharded`` (its dry run's step), rebuilt
  over the port's nets and collectives in ``torch_dp_workers.py``, on 2
  ranks against JAX's on a 2-device CPU mesh (conftest forces 8): the same
  numpy-seeded narrow nets (JAX weights carried across by ``interop.py``),
  toy skinner and 128 rays.  JAX's own tolerances
  (``tests/test_parallel.py``): loss rtol 1e-5, nets and bank rtol 1e-4 /
  atol 1e-5.
* (b) Two ``Trainer`` steps, each after a remesh, on a 32x32 toy scene
  with narrow nets: dp=2 against one process, every info value, the nets,
  their gradients, the bank, the template, Adam's state and the sweep bbox
  at rtol 1e-4 / atol 1e-5, the generator's state equal; the two ranks
  bitwise equal after each step.
* (c) ``cli.train.main --mesh dp=2 --device cpu`` against the same run
  without ``--mesh``: every tensor of ``latest.pt`` at the same tolerance.
* (d) The CLI's rejections of --mesh.
* (e), in ``test_torch_parallel_mesh.py``: the training step on 2 ranks
  against JAX's in its data-parallel layout.

Each rank runs one torch thread and saves ``'jax' in sys.modules``, which
must be false: the bodies live in ``torch_dp_workers.py``, which imports
nothing of JAX.
"""
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from selfreconcode_tpu.models import deformer as JD
from selfreconcode_tpu.models import render as JR
from selfreconcode_tpu.models import sdf as JSDF
from selfreconcode_tpu.models import skinner as JSK
from selfreconcode_tpu.models import smpl as JSMPL
from selfreconcode_tpu.models import translator as JT
from selfreconcode_tpu.parallel.sharded import make_train_step_sharded
from selfreconcode_tpu_torch.cli import train as cli
from selfreconcode_tpu_torch.data.dataset import make_synthetic_scene
from selfreconcode_tpu_torch.interop import params_from_jax
from selfreconcode_tpu_torch.models.sdf import SDFNet
from test_torch_common import RN_KW, SDF_KW, TR_KW, port_skinner

import torch_dp_workers as W

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(W.THREADS)
    yield
    torch.set_num_threads(n)


def spawn(fn, world, *args):
    """fn(rank, world, store, *args) on `world` spawned ranks; a failing
    rank raises here."""
    store = osp.join(args[-1], "store")
    mp.start_processes(fn, args=(world, store) + args, nprocs=world,
                       start_method="spawn")


def load_ranks(out_dir, world):
    ranks = [torch.load(osp.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    assert not any(r["jax"] for r in ranks), "a rank imported jax"
    return ranks


def leaves(tree, prefix=""):
    """{path: numpy array} of a nest of dicts, lists and tensors."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in leaves(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in leaves(sub, f"{prefix}{i}/").items()}
    if torch.is_tensor(tree):
        tree = tree.numpy()
    return {prefix: np.asarray(tree)}


def assert_close(ref, got, what):
    a, b = leaves(ref), leaves(got)
    assert a.keys() == b.keys(), (what, a.keys() ^ b.keys())
    for k in a:
        np.testing.assert_allclose(b[k].astype(np.float64),
                                   a[k].astype(np.float64), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what}: {k}")


def assert_bitwise(a, b, what):
    a, b = leaves(a), leaves(b)
    assert a.keys() == b.keys()
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    assert not bad, f"{what}: the ranks differ in {bad}"


def test_sharded_step_matches_jax_on_two_devices(tmp_path):
    """(a)"""
    rng = np.random.default_rng(0)
    B, n_rays = 2, 128
    jsk, _, _ = JSK.build_skinner(JSMPL.toy_smpl_model(400), jnp.zeros(10),
                                  JSMPL.smpl_tmp_apose(1),
                                  resolution=(17, 29, 9),
                                  table_dtype=jnp.float32)
    jnets = (JSDF.SDFNet(**SDF_KW), JT.TranslatorNet(**TR_KW),
             JR.RenderNet(**RN_KW))
    params = {"sdf": JSDF.init_sdf_params(jax.random.PRNGKey(1), jnets[0]),
              "trans": JT.init_translator_params(jax.random.PRNGKey(2),
                                                 jnets[1]),
              "render": JR.init_render_params(jax.random.PRNGKey(3),
                                              jnets[2])}
    rays = rng.standard_normal((n_rays, 3)).astype(np.float32)
    data = {"pts": (0.2 * rng.standard_normal((n_rays, 3))).astype(
                np.float32),
            "batch_inds": rng.integers(0, B, n_rays).astype(np.int32),
            "rays": rays / np.linalg.norm(rays, axis=-1, keepdims=True),
            "gt": rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)}
    bank = {"dcond": rng.normal(0, 0.1, (B, TR_KW["cond_size"])),
            "poses": rng.normal(0, 0.2, (B, 24, 3)),
            "trans": rng.normal(0, 0.1, (B, 3))}
    bank = {k: v.astype(np.float32) for k, v in bank.items()}
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    jstep = make_train_step_sharded(
        mesh, jnets[0], jnets[2], JD.Deformer(translator=jnets[1],
                                              skinner=jsk))
    jloss, jparams, jbank = jstep(
        params, jax.tree_util.tree_map(jnp.asarray, bank),
        *(jnp.asarray(data[k]) for k in ("pts", "batch_inds", "rays",
                                         "gt")))
    payload = {**data, "bank": bank, "skinner": port_skinner(jsk),
               "params": params_from_jax(
                   jax.tree_util.tree_map(np.asarray, params)),
               "kwargs": {"sdf": SDF_KW, "trans": TR_KW, "render": RN_KW}}
    spawn(W.sharded_step_rank, 2, payload, str(tmp_path))
    r0, r1 = load_ranks(str(tmp_path), 2)
    assert_bitwise(r0, r1, "sharded step")
    np.testing.assert_allclose(r0["loss"], float(jloss), rtol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert_close(want, {k: r0["params"][k] for k in want}, "nets")
    assert_close(jax.tree_util.tree_map(np.asarray, jbank), r0["bank"],
                 "bank")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp") / "scene")
    make_synthetic_scene(root, n_frames=4, H=32, W=32)
    return root


def test_trainer_steps_across_a_remesh_match_one_process(scene, tmp_path):
    """(b)"""
    ref = W.trainer_steps(scene, 2, 1e-4)
    spawn(W.trainer_steps_rank, 2, scene, 2, 1e-4, str(tmp_path))
    r0, r1 = load_ranks(str(tmp_path), 2)
    for i, (want, a, b) in enumerate(zip(ref, r0["states"], r1["states"])):
        assert_bitwise(a, b, f"step {i}")
        assert set(a["info"]) == set(want["info"])
        assert_close(want, a, f"step {i}")
    # the second step ran on a second remesh
    assert ref[1]["info"]["remesh"] == 2.0


def test_cli_mesh_dp2_matches_one_process(scene, tmp_path):
    """(c): the port's counterpart of JAX's (slow)
    test_cli_train_mesh_matches_single_device.  The IGR cache is the SDF's
    geometric init with bias 0.5, a sphere of radius ~0.27 (the runs skip
    IGR); the first run builds the skinner cache, which the second
    copies."""
    import shutil
    ckpts = {}
    caches = ("initial_sdf_idr_6_1_torch.pt", "initial_skinner_1_torch.pt")
    for tag, extra in (("single", []), ("dp2", ["--mesh", "dp=2"])):
        root = str(tmp_path / tag)
        shutil.copytree(scene, root, ignore=shutil.ignore_patterns("init*"))
        if tag == "single":
            torch.save(SDFNet(multires=6, bias=0.5, seed=1).state_dict(),
                       osp.join(root, caches[0]))
        else:
            for c in caches:
                shutil.copyfile(osp.join(str(tmp_path / "single"), c),
                                osp.join(root, c))
        out = cli.main(["--conf", W.CONF, "--data", root, "--save-folder",
                        "rec", "--toy-smpl", "--max-epochs", "0",
                        "--device", "cpu"] + extra,
                       resolutions=W.RESOLUTIONS, skinner_res=W.SKINNER_RES,
                       tune=W.tune_cpu)
        assert (out is None) == (tag == "dp2")
        ckpts[tag] = torch.load(osp.join(root, "rec", "latest.pt"),
                                weights_only=False)
        assert not osp.exists(osp.join(root, "rec", ".dp_store"))
    single, dp = ckpts["single"], ckpts["dp2"]
    assert single["opt_times"] == dp["opt_times"] == 1
    for key in ("nets", "bank", "tmp", "bbox"):
        assert_close(single[key], dp[key], key)
    assert_close(single["optimizer"]["state"], dp["optimizer"]["state"],
                 "adam")


def test_cli_mesh_rejections(scene, monkeypatch):
    """(d): a malformed --mesh, N above the device count for cuda, and an
    image height that N does not divide (JAX cli/train.py:101-108)."""
    base = ["--conf", W.CONF, "--data", scene, "--save-folder", "rec",
            "--toy-smpl"]
    for bad in ("dp=x", "dp=0", "dp=", "tp=2"):
        with pytest.raises(SystemExit):
            cli.main(base + ["--mesh", bad, "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(base + ["--mesh", "dp=1", "--device", "cuda:1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, found 1"):
        cli.main(base + ["--mesh", "dp=2", "--device", "cuda"])
    with pytest.raises(ValueError, match="height 32 must divide by dp=3"):
        cli.main(base + ["--mesh", "dp=3", "--device", "cpu"])
    assert not os.path.exists(osp.join(scene, "rec"))

