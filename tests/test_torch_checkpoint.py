"""Checkpoint interchange: a JAX ``latest.pkl``, a reference ``.pth`` and
the port's ``.pt`` into the port's ``load_checkpoint``, held against the JAX
package's loaders on the same files.

The JAX side trains 2 coarse steps (N = 1, 32 rays, 128 eikonal points,
every template vertex in the anchor) on its 32x32 four-frame synthetic scene
at full ``config.conf`` width, moves the bank's focal length by +1% (a
trained camera that differs from ``camera.npz``) and saves ``latest.pkl``;
the port loads that file into a Trainer on the same scene with the JAX
skinner carried across.

Tolerances: everything a load restores (nets, bank, template, the dataset's
camera, Adam's moments and step count) is bit for bit.  One port step from
the loaded checkpoint against JAX's next step, with the step tests' draws
(``test_torch_step.jax_draws``) and tolerances: every info loss 1e-4
relative, ray_converged within 1% of P, the template after its SGD step
1e-6, parameters after Adam 0.05 * lr where the port's gradient exceeds
1e-6 of its leaf's largest.  The debug dump's splat mask (radius 0.096 px,
so every hit moves with the camera) within one grey level of JAX's.
"""
import os.path as osp
import pickle
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from selfreconcode_tpu.engine import checkpoint as JCK
from selfreconcode_tpu.engine.torch_compat import load_reference_sdf
from selfreconcode_tpu.engine.trainer import build_synthetic_trainer
from selfreconcode_tpu_torch.config import parse_file
from selfreconcode_tpu_torch.data.dataset import SceneDataset
from selfreconcode_tpu_torch.engine import checkpoint as CK
from selfreconcode_tpu_torch.engine import trainer as TTR
from selfreconcode_tpu_torch.engine.torch_compat import CAM_KEYS
from selfreconcode_tpu_torch.interop import (bank_from_jax, params_from_jax,
                                             template_from_jax)
from selfreconcode_tpu_torch.models.smpl import toy_smpl_model
from test_torch_common import port_skinner
from test_torch_compat import _reference_format_pth
from test_torch_step import P, jax_draws

CONF = osp.join(osp.dirname(__file__), "..", "configs", "config.conf")
RES = [(9, 9, 9), (17, 17, 17)]
LR = 1e-4


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def jax_trainer(root):
    tr, ds = build_synthetic_trainer(root, n_frames=4, H=32, W=32,
                                     resolutions={s: RES for s in
                                                  ("coarse", "medium", "fine")})
    return tr, ds


def port_trainer(scene, jtr):
    """A port Trainer at config.conf width on the JAX scene, with the JAX
    trainer's skinner carried across."""
    ds = SceneDataset(scene, {"deformer": 128, "renderer": 256})
    tr = TTR.Trainer(ds, toy_smpl_model(400), parse_file(CONF),
                     {s: RES for s in ("coarse", "medium", "fine")},
                     skinner_res=(17, 29, 9), device="cpu")
    tr.skinner = port_skinner(jtr.skinner)
    return tr


def small_stage(tr, N=None):
    """The step tests' sizes on either framework's trainer."""
    kw = {"N": N} if N else {}
    tr.override_stage(sample_pix=P, eik_tmp=128, anchor_sub=0,
                      surf_iters=3, **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """JAX: 2 steps, camera moved, latest.pkl saved; then JAX's next step
    from that state (recorded before anything loads the file)."""
    root = str(tmp_path_factory.mktemp("ck"))
    jtr, jds = jax_trainer(root)
    jtr.set_stage("coarse")
    small_stage(jtr, N=1)
    # a splat cap above the fullest cell: at its own 64 JAX drops candidates
    # (a reference defect, ROADMAP Queue 3) where the port drops none
    jtr.override_stage(splat_cap=512)
    for i, f in enumerate((1, 2)):
        fids = np.array([f])
        jtr.train_step(fids, jds.batch(fids), LR, jax.random.PRNGKey(i))
    bank = dict(jtr.state.bank)
    bank["camera"] = {**bank["camera"],
                      "focal_length": bank["camera"]["focal_length"] * 1.01}
    jtr.state = jtr.state._replace(bank=bank)
    pkl = osp.join(root, "latest.pkl")
    JCK.save_checkpoint(pkl, jtr, epoch=1)
    saved = {"params": np_tree(jtr.state.params),
             "bank": np_tree(jtr.state.bank),
             "opt": np_tree(jtr.state.opt_state),
             "tmp": np_tree(jtr.state.tmp._asdict())}
    key = jax.random.PRNGKey(7)
    fids = np.array([3])
    cfg = jtr.stage_cfg
    nv = int(np.asarray(jtr.state.tmp.vert_valid).sum())
    vcap = jtr.state.tmp.verts.shape[0]
    jinfo = jtr.train_step(fids, jds.batch(fids), LR, key)
    return dict(root=root, scene=osp.join(root, "scene"), pkl=pkl, jtr=jtr,
                saved=saved, jinfo=jinfo, fids=fids, key=key, jcfg=cfg,
                nv=nv, vcap=vcap, j_params=np_tree(jtr.state.params),
                j_tmp=np_tree(jtr.state.tmp))


@pytest.fixture(scope="module")
def loaded(trained):
    tr = port_trainer(trained["scene"], trained["jtr"])
    epoch = CK.load_checkpoint(trained["pkl"], tr)
    return tr, epoch


def test_jax_pickle_loads_bit_for_bit(trained, loaded):
    tr, epoch = loaded
    s = trained["saved"]
    assert epoch == 1 and tr.opt_times == 2 and tr.forward_time == 2
    assert tr.stage_cfg.name == "coarse"
    want = params_from_jax(s["params"])
    got = tr.nets.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    for k, v in bank_from_jax(s["bank"]).items():
        np.testing.assert_array_equal(tr.bank[k].detach().numpy(), v,
                                      err_msg=k)
    t = template_from_jax(s["tmp"])
    np.testing.assert_array_equal(tr.tmp.verts.numpy(), t["verts"])
    np.testing.assert_array_equal(tr.tmp.faces.numpy(), t["faces"])
    np.testing.assert_array_equal(tr.tmp.momentum.numpy(), t["momentum"])
    np.testing.assert_array_equal(tr.b_min, np.float32(trained["jtr"].b_min))
    np.testing.assert_array_equal(tr.b_max, np.float32(trained["jtr"].b_max))


def test_jax_adam_moments_carry_over(trained, loaded):
    tr, _ = loaded
    adam = trained["saved"]["opt"][0]
    count = int(adam.count)
    assert count == 2
    params = {**dict(tr.nets.named_parameters()), **tr.bank}
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        flat = {**params_from_jax(tree[0]), **bank_from_jax(tree[1])}
        assert set(flat) == set(params)
        for n, v in flat.items():
            st = tr.optimizer.state[params[n]]
            assert float(st["step"]) == count
            np.testing.assert_array_equal(st[key].numpy(), v, err_msg=n)


def port_pt(trained, path):
    """The checkpoint as the port's own .pt, written without the port's
    loader (interop's key maps straight into a Trainer), so that a port
    which reads only its own format resumes the same state."""
    s, jtr = trained["saved"], trained["jtr"]
    tr = port_trainer(trained["scene"], jtr)
    tr.nets.load_state_dict({k: torch.tensor(v) for k, v in
                             params_from_jax(s["params"]).items()})
    with torch.no_grad():
        for k, v in bank_from_jax(s["bank"]).items():
            tr.bank[k].copy_(torch.tensor(v))
    t = template_from_jax(s["tmp"])
    tr.tmp = TTR.make_template(*(torch.tensor(t[k]) for k in
                                 ("verts", "faces", "momentum")))
    tr.b_min, tr.b_max = np.float32(jtr.b_min), np.float32(jtr.b_max)
    tr.set_stage("coarse")
    tr.opt_times = tr.forward_time = 2
    CK.save_checkpoint(path, tr, 1)


@pytest.mark.parametrize("fmt", ["JAX .pkl", "port .pt"])
def test_resume_writes_the_bank_back_into_the_dataset(trained, tmp_path, fmt):
    """Both frameworks resume from the checkpoint (the port from the file
    itself or from its .pt copy), whose camera is not camera.npz's: the
    dataset holds the file's camera, poses and trans, and the debug dump's
    splat mask, rendered through the dataset's camera, is JAX's."""
    path = trained["pkl"]
    if fmt == "port .pt":
        path = str(tmp_path / "latest.pt")
        port_pt(trained, path)
    tr = port_trainer(trained["scene"], trained["jtr"])
    CK.load_checkpoint(path, tr)
    jtr, jds = jax_trainer(trained["root"])
    JCK.load_checkpoint(trained["pkl"], jtr)
    npz = np.load(osp.join(trained["scene"], "camera.npz"))
    assert not np.allclose(tr.dataset.camera_params["focal_length"],
                           [npz["fx"], npz["fy"]])
    for k in CAM_KEYS:
        np.testing.assert_array_equal(tr.dataset.camera_params[k],
                                      jds.camera_params[k], err_msg=k)
    np.testing.assert_array_equal(tr.dataset.poses, jds.poses)
    np.testing.assert_array_equal(tr.dataset.trans, jds.trans)
    np.testing.assert_array_equal(tr.dataset.conds["deformer"],
                                  jds.conds["deformer"])
    # a splat cap that holds every vertex: at the stage's cap JAX drops the
    # candidates of its fullest cells (a reference defect, ROADMAP Queue 3)
    nv = int(np.asarray(jtr.state.tmp.vert_valid).sum())
    jtr.override_stage(splat_cap=-(-nv // 64) * 64)
    jtr.save_debug(str(tmp_path / "j"), np.array([1]), None)
    tr.save_debug(str(tmp_path / "t"), np.array([1]), None)
    mj = cv2.imread(str(tmp_path / "j" / "m0.png"), cv2.IMREAD_GRAYSCALE)
    mt = cv2.imread(str(tmp_path / "t" / "m0.png"), cv2.IMREAD_GRAYSCALE)
    assert (mj > 0).sum() >= 5
    assert np.abs(mj.astype(int) - mt.astype(int)).max() <= 1
    # the dataset holds a copy: training the bank leaves it as loaded
    focal = tr.dataset.camera_params["focal_length"].copy()
    with torch.no_grad():
        tr.bank["focal_length"].add_(1.0)
    np.testing.assert_array_equal(tr.dataset.camera_params["focal_length"],
                                  focal)


def test_port_step_matches_jax_next_step(trained, monkeypatch):
    """One port step from the loaded JAX checkpoint (Adam's moments
    included) against the JAX trainer's next step from the same state."""
    tr = port_trainer(trained["scene"], trained["jtr"])
    CK.load_checkpoint(trained["pkl"], tr)
    small_stage(tr, N=1)
    jcfg = trained["jcfg"]
    assert tr.stage_cfg.rays() == P and tr.stage_cfg.eik_tmp == jcfg.eik_tmp
    draws = jax_draws(trained["key"], jcfg, trained["nv"], trained["vcap"])
    monkeypatch.setattr(TTR, "draw_step_noise", lambda *a: draws)
    fids = trained["fids"]
    info = tr.train_step(fids, trained["jtr"].dataset.batch(fids), LR)
    ji = trained["jinfo"]
    for k in ("loss", "grad_loss", "def_loss", "dct_loss", "color_loss",
              "pc_loss_sdf", "pc_mask_loss", "pc_defconst_loss", "inv_ok"):
        np.testing.assert_allclose(info[k], ji[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert ji["inv_ok"] == P and ji["splat_overflow"] == 0
    assert abs(info["ray_converged"] - ji["ray_converged"]) <= 0.01 * P
    nv = trained["nv"]
    np.testing.assert_allclose(tr.tmp.verts.numpy(),
                               trained["j_tmp"].verts[:nv], atol=1e-6)
    want = params_from_jax(trained["j_params"])
    for name, p in tr.nets.named_parameters():
        g = p.grad.abs().numpy()
        sel = g > 1e-6 * g.max()
        np.testing.assert_allclose(p.detach().numpy()[sel],
                                   want[name].reshape(p.shape)[sel], rtol=0,
                                   atol=0.05 * LR, err_msg=name)


def test_reference_pth_loads_as_in_jax(trained, tmp_path):
    """A reference .pth into both frameworks: the same nets, bank, dataset
    camera and shape; Adam fresh in both."""
    s = trained["saved"]
    pth = str(tmp_path / "ref.pth")
    _reference_format_pth(s["params"], s["bank"], pth, F=4)
    jtr, jds = jax_trainer(trained["root"])
    tr = port_trainer(trained["scene"], jtr)
    assert JCK.load_checkpoint(pth, jtr) == 42
    assert CK.load_checkpoint(pth, tr) == 42
    jp = params_from_jax(np_tree(jtr.state.params))
    for k, v in tr.nets.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jp[k], err_msg=k)
    for k, v in bank_from_jax(np_tree(jtr.state.bank)).items():
        np.testing.assert_array_equal(tr.bank[k].detach().numpy(), v,
                                      err_msg=k)
    for k in CAM_KEYS:
        np.testing.assert_array_equal(tr.dataset.camera_params[k],
                                      jds.camera_params[k], err_msg=k)
    np.testing.assert_array_equal(tr.dataset.poses, jds.poses)
    np.testing.assert_array_equal(tr.dataset.shape, jds.shape)
    assert len(tr.optimizer.state) == 0
    adam = jtr.state.opt_state[0]
    assert int(adam.count) == 0
    assert all(not np.asarray(x).any()
               for x in jax.tree_util.tree_leaves((adam.mu, adam.nu)))


def _sdf_sources(trained, tmp_path):
    """{format: (path, the SDF state_dict it holds, how JAX's --sdf-model
    reads the file or None)}: JAX's cli/train.py:122-131."""
    s = trained["saved"]
    sdf_np = params_from_jax({"sdf": s["params"]["sdf"], "trans": [],
                              "render": []})
    # another SDF than the checkpoint's: every weight halved
    other = {k: 0.5 * v for k, v in sdf_np.items()}
    layers = [{"v": other[f"sdf.lin{l}.weight_v"],
               "g": other[f"sdf.lin{l}.weight_g"].reshape(-1),
               "b": other[f"sdf.lin{l}.bias"]}
              for l in range(len(s["params"]["sdf"]))]
    want = {k[4:]: v for k, v in other.items()}
    full = str(tmp_path / "full.pth")
    _reference_format_pth({**s["params"], "sdf": layers}, s["bank"], full, 4)
    bare = str(tmp_path / "bare.pth")
    torch.save({k: torch.tensor(v) for k, v in want.items()}, bare)
    pkl = str(tmp_path / "sdf.pkl")
    with open(trained["pkl"], "rb") as f:
        payload = pickle.load(f)
    payload["params"]["sdf"] = layers
    with open(pkl, "wb") as f:
        pickle.dump(payload, f)
    tr = port_trainer(trained["scene"], trained["jtr"])
    tr.nets.sdf.load_state_dict({k: torch.tensor(v) for k, v in want.items()})
    pt = str(tmp_path / "port.pt")
    CK.save_checkpoint(pt, tr, 0)
    def jax_pickle_sdf(path):
        with open(path, "rb") as f:
            return pickle.load(f)["params"]["sdf"]

    return {"port .pt": (pt, want, None),
            "reference .pth": (full, want, load_reference_sdf),
            "bare SDF .pth": (bare, want, load_reference_sdf),
            "JAX .pkl": (pkl, want, jax_pickle_sdf)}


@pytest.mark.parametrize("fmt", ["port .pt", "reference .pth",
                                 "bare SDF .pth", "JAX .pkl"])
def test_sdf_model_from_each_format(trained, tmp_path, fmt):
    """--sdf-model: the SDF of any format replaces the checkpoint's, Adam
    restarts, the rest is the checkpoint's; where JAX reads the format, its
    --sdf-model gives the same nets."""
    path, want, jax_sdf = _sdf_sources(trained, tmp_path)[fmt]
    sdf = CK.load_sdf_state(path)
    assert set(sdf) == set(want)
    tr = port_trainer(trained["scene"], trained["jtr"])
    CK.load_checkpoint(trained["pkl"], tr, sdf_state=sdf)
    got = tr.nets.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got["sdf." + k].numpy(), v, err_msg=k)
    ck = params_from_jax(trained["saved"]["params"])
    for k, v in ck.items():
        if not k.startswith("sdf."):
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert len(tr.optimizer.state) == 0
    if jax_sdf is not None:
        jtr, _ = jax_trainer(trained["root"])
        JCK.load_checkpoint(trained["pkl"], jtr, sdf_params=jax_sdf(path))
        jp = params_from_jax(np_tree(jtr.state.params))
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), jp[k], err_msg=k)


@pytest.mark.parametrize("tamper", ["a missing leaf", "another shape"])
def test_adam_restarts_when_the_state_does_not_fit(trained, tamper, capsys):
    payload = CK.load_jax_pickle(trained["pkl"])
    mu = payload["opt_state"][0][1]
    if tamper == "a missing leaf":
        del mu[1]["poses"]
    else:
        mu[1]["poses"] = mu[1]["poses"][:2]
    tr = port_trainer(trained["scene"], trained["jtr"])
    CK.restore_from_jax(payload, tr)
    assert len(tr.optimizer.state) == 0
    assert "Adam restarts" in capsys.readouterr().out


class _Evil:
    def __reduce__(self):
        return (print, ("this must not run",))


@pytest.mark.parametrize("what", ["random bytes", "a torch archive of "
                                  "neither kind", "a pickle of another dict",
                                  "a pickle naming another class",
                                  "a torch archive naming another class"])
def test_a_file_of_no_known_format_raises(tmp_path, what, capsys):
    """Every torch archive is read weights-only, so a port-shaped archive
    that pickles a callable is refused before it runs, as a JAX-shaped
    pickle is."""
    path = str(tmp_path / "x.ckpt")
    if what == "random bytes":
        with open(path, "wb") as f:
            f.write(np.random.default_rng(0).bytes(256))
    elif what == "a torch archive of neither kind":
        torch.save({"state_dict": {}}, path)
    elif what == "a torch archive naming another class":
        torch.save({"nets": {}, "bank": {}, "x": _Evil()}, path)
    elif what == "a pickle of another dict":
        with open(path, "wb") as f:
            pickle.dump({"epoch": 1, "weights": np.zeros(3)}, f)
    else:
        with open(path, "wb") as f:
            pickle.dump({"params": {}, "bank": {}, "x": _Evil()}, f)
    match = {"random bytes": "not a torch archive",
             "a torch archive of neither kind": "found keys",
             "a pickle of another dict": "found",
             "a pickle naming another class": "refusing class builtins.print",
             "a torch archive naming another class":
                 "pickles more than tensors, refused"}
    with pytest.raises(ValueError, match=match[what]):
        CK.load_checkpoint(path, None)
    if what == "a torch archive naming another class":
        with pytest.raises(ValueError, match=match[what]):
            CK.load_sdf_state(path)
    assert "this must not run" not in capsys.readouterr().out


def test_jax_pickle_loads_without_jax_or_optax(trained):
    """The loader needs neither JAX nor its optimizer library: a process
    in which both imports fail reads the payload and its Adam record."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['optax'] = None\n"
            "from selfreconcode_tpu_torch.engine.checkpoint import "
            "load_jax_pickle, AdamState\n"
            f"p = load_jax_pickle({trained['pkl']!r})\n"
            "assert isinstance(p['opt_state'][0], AdamState)\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules "
            "if sys.modules[m] is not None]\n"
            "print(int(p['opt_state'][0][0]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=osp.join(osp.dirname(__file__), ".."),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "2"
