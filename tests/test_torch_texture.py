"""Texture baking: ``texture/uv.py`` and ``cli/texture.py`` of the port
against the JAX package's.

JAX bakes at footprint 64 through its XLA rasterizer, whose cells keep 48
faces and drop the rest; the port bakes in its 32 px cells and drops
nothing.  Every case asserts that JAX dropped no face (``overflow`` 0 at
footprint 64 on each frame), where the two must agree.

Tolerances: ``pix_to_face`` identical; the per-texel weight (the filled
slots' sum, or the mean's sum) within 1e-6; the texture within 1e-6 (the
median takes one of the candidates' colours or the mean of two, so where the
slot sets agree it is equal up to the last bit of that mean).  The median
helpers are held to numpy bit for bit.  ``prepare``'s deformed vertices
within the deformer tests' tolerance (1e-5 relative to max(|x|, 1)); the
extracted ``texture.png`` byte for byte.
"""
import dataclasses
import os
import os.path as osp
import shutil
import warnings

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfreconcode_tpu.cli import texture as JCLI
from selfreconcode_tpu.engine import checkpoint as JCK
from selfreconcode_tpu.engine.trainer import build_synthetic_trainer
from selfreconcode_tpu.ops import rasterize as JRA
from selfreconcode_tpu.render import camera as JCAM
from selfreconcode_tpu.texture import uv as J
from selfreconcode_tpu.utils import meshops as JM
from selfreconcode_tpu_torch.cli import texture as TCLI
from selfreconcode_tpu_torch.ops import mesh_kernels as MK
from selfreconcode_tpu_torch.ops import rasterize as TRA
from selfreconcode_tpu_torch.render import camera as TCAM
from selfreconcode_tpu_torch.texture import uv as T
from selfreconcode_tpu_torch.utils import trace
from test_torch_common import port_skinner

OBJ = """
v 0 0 0
v 1 0 0
v 0 1 0
vt 0.1 0.1
vt 0.9 0.1
vt 0.1 0.9
f 1/1 2/2 3/3
"""


def test_load_obj_with_uv_matches_jax(tmp_path):
    """The JAX test's OBJ, and faces without texture ids (f v, f v//vn)."""
    p = tmp_path / "m.obj"
    p.write_text(OBJ + "v 1 1 0\nf 2 4 3\nf 1//1 4//1 2//1\n")
    for a, b in zip(T.load_obj_with_uv(str(p)), J.load_obj_with_uv(str(p))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def cameras(H, W, focal=60.0):
    args = (np.array([focal, focal], np.float32),
            np.array([W / 2, H / 2], np.float32),
            np.array([1.0, 0, 0, 0], np.float32),
            np.array([0.0, 0.0, 2.0], np.float32), H, W)
    return JCAM.make_camera(*args), TCAM.make_camera(*args)


def square():
    """The JAX tests' front-facing square (two faces, UV = the square)."""
    s = 0.5
    verts = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return verts, faces, uvs


def bumpy_grid(n=6, seed=0):
    """An n x n grid over [-0.6, 0.6]^2, z a smooth bump, UV the grid: a
    curved surface, so each frame's weights vary over it."""
    g = np.linspace(-0.6, 0.6, n + 1, dtype=np.float32)
    x, y = np.meshgrid(g, g)
    z = 0.15 * np.cos(2.0 * x) * np.cos(1.5 * y)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(n * n).reshape(n, n) + np.arange(n)[:, None]
    quads = np.stack([i, i + 1, i + n + 2, i + n + 1], -1).reshape(-1, 4)
    faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]]).astype(
        np.int32)
    uvs = np.stack([(x + 0.6) / 1.2, (y + 0.6) / 1.2], -1).reshape(-1, 2)
    return verts, faces, uvs.astype(np.float32)


def rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def flat(H, W, rgb):
    return np.broadcast_to(np.float32(rgb), (H, W, 3)).copy()


def case(name):
    """(H, W, per-frame verts, images, faces, uvs) of each baking case."""
    if name == "bumpy":
        H = W = 128
        verts, faces, uvs = bumpy_grid()
        rng = np.random.default_rng(0)
        vlist = [verts @ rot_y(a).T for a in (-0.3, 0.0, 0.25, 0.5)]
        imgs = [rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
                for _ in vlist]
        return H, W, vlist, imgs, faces, uvs
    H = W = 64
    verts, faces, uvs = square()
    imgs = {"flat": [flat(H, W, (1, 0, 0))],
            "corrupted": [flat(H, W, 0.5)] * 4 + [flat(H, W, (1, 0, 0))],
            # two frames: every texel has 2 filled slots, an even count
            "even": [flat(H, W, 0.25), flat(H, W, 0.75)]}[name]
    return H, W, [verts] * len(imgs), imgs, faces, uvs


CASES = [("flat", 8), ("flat", 1), ("corrupted", 8), ("corrupted", 1),
         ("even", 8), ("bumpy", 8), ("bumpy", 1)]


def jax_frame(jcam, verts, faces, jit, weight_pow=8.0):
    """JAX's per-frame pass (texture/uv.py:84-102) at footprint 64, jitted
    as the bake runs it or eager: (fragments, weight (H, W))."""
    fj = jnp.asarray(faces)
    valid = jnp.ones(len(faces), bool)

    def frame_pass(v):
        frags = JRA.rasterize_mesh(jcam, v, fj, valid, 64)
        f = jnp.maximum(frags.pix_to_face, 0)
        tri = fj[f]
        b = frags.bary[..., :, None]
        n = (JM.vertex_normals(v, fj, valid)[tri] * b).sum(-2)
        n = n / jnp.clip(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-6,
                         None)
        d = JCAM.cam_pos(jcam) - (v[tri] * b).sum(-2)
        d = d / jnp.clip(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-6,
                         None)
        w = jnp.clip(jnp.abs((n * d).sum(-1)), 0.0, 1.0) ** weight_pow
        return frags, jnp.where(frags.pix_to_face >= 0, w, 0.0)

    frags, w = (jax.jit(frame_pass) if jit else frame_pass)(
        jnp.asarray(verts))
    return frags, np.asarray(w)


def texel_map(uvs, faces_vt, face, bary, w, T):
    """uv.py:110-117 in numpy, per pixel: (texel index ty * T + tx, -1
    where the weight is 0; uv * (T - 1) unrounded)."""
    uv = (uvs[faces_vt[np.maximum(face, 0)]] * bary[..., None]).sum(-2)
    s = np.stack([uv[..., 0] * (T - 1), (1.0 - uv[..., 1]) * (T - 1)], -1)
    t = np.clip(s.round().astype(np.int64), 0, T - 1)
    return np.where(w > 0, t[..., 1] * T + t[..., 0], -1), s


@pytest.mark.parametrize("name,k", CASES, ids=[f"{n}-k{k}" for n, k in CASES])
def test_bake_texture_matches_jax(name, k):
    """Per frame: JAX drops no face, and its eager pass gives the port's
    fragments face for face and its weights within 1e-6.  JAX's bake runs
    the pass jitted, where XLA contracts the edge tests into FMAs, so on a
    pixel on a shared edge it may pick the neighbour (at most 0.5% of the
    pixels), and its weights move by a few float32 ulps of |n.v| raised to
    the 8th power (2e-6 per pixel, so 4 frames' slot sums within 8e-6);
    a pixel with the same face maps to another texel only where its
    uv * (T - 1) lies within 1e-4 of a rounding boundary (the rasterizers'
    barycentrics differ in the last bits).  The baked texture agrees within
    1e-6, and its weight within 8e-6, on every texel no such pixel lands
    on, which must be all but 1%."""
    T_ = 64
    H, W, vlist, imgs, faces, uvs = case(name)
    jcam, tcam = cameras(H, W)
    ft = torch.tensor(faces).long()
    moved = set()
    for v in vlist:
        eager = JRA.rasterize_mesh(jcam, jnp.asarray(v), jnp.asarray(faces),
                                   jnp.ones(len(faces), bool), 64)
        assert int(eager.overflow) == 0
        face, bary, wt = (x.numpy() for x in T.frame_weights(
            tcam, torch.tensor(v), ft, 32, 8.0))
        _, we = jax_frame(jcam, v, faces, jit=False)
        np.testing.assert_array_equal(face, np.asarray(eager.pix_to_face))
        np.testing.assert_allclose(wt, we, rtol=0, atol=1e-6)
        frags, wj = jax_frame(jcam, v, faces, jit=True)
        pj = np.asarray(frags.pix_to_face)
        same = pj == face
        assert (~same).mean() <= 5e-3
        np.testing.assert_allclose(wt[same], wj[same], rtol=0, atol=2e-6)
        np.testing.assert_array_equal(wt[same] > 0, wj[same] > 0)
        lj, sj = texel_map(uvs, faces, pj, np.asarray(frags.bary), wj, T_)
        lt, _ = texel_map(uvs, faces, face, bary, wt, T_)
        flip = lj != lt
        frac = np.abs(sj - np.floor(sj) - 0.5).min(-1)
        assert (frac[flip & same] < 1e-4).all()
        moved |= set(lj[flip]) | set(lt[flip])
    moved.discard(-1)
    tex_j, w_j = J.bake_texture(jcam, vlist, imgs, faces, faces, uvs,
                                tex_size=T_, footprint=64, k_best=k)
    tex_t, w_t = T.bake_texture(tcam, vlist, imgs, faces, faces, uvs,
                                tex_size=T_, k_best=k)
    assert tex_t.dtype == np.float32 and w_t.dtype == np.float32
    assert len(moved) <= 0.01 * T_ * T_
    keep = np.ones(T_ * T_, bool)
    keep[list(moved)] = False
    keep = keep.reshape(T_, T_)
    covered = w_j > 0
    assert covered.mean() > 0.1
    np.testing.assert_array_equal((w_t > 0)[keep], covered[keep])
    np.testing.assert_allclose(w_t[keep], w_j[keep], rtol=0, atol=8e-6)
    np.testing.assert_allclose(tex_t[keep], tex_j[keep], rtol=0, atol=1e-6)
    if name == "even" and k > 1:
        # np.nanmedian's mean of the two middle values, not the lower one
        np.testing.assert_allclose(tex_t[covered], 0.5, atol=1e-6)
    if name == "corrupted" and k > 1:
        np.testing.assert_allclose(tex_t[covered][:, 0], 0.5, atol=1e-6)


def test_slot_median_is_numpys_nanmedian():
    """Random slots with every fill count 0..K (every even count too)."""
    rng = np.random.default_rng(1)
    K, n = 8, 900
    w = rng.uniform(0.1, 1, (n, K)).astype(np.float32)
    fill = np.arange(n) % (K + 1)
    w[np.arange(K)[None, :] >= fill[:, None]] = 0.0
    c = rng.uniform(0, 1, (n, K, 3)).astype(np.float32)
    got = T.slot_median(torch.tensor(w), torch.tensor(c)).numpy()
    with warnings.catch_warnings():
        # all-empty texels are all-NaN by design, as in uv.py
        warnings.simplefilter("ignore", RuntimeWarning)
        want = np.nan_to_num(np.nanmedian(
            np.where((w > 0)[..., None], c, np.nan), axis=1), nan=0.0)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_best_per_texel_is_numpys_lexsort():
    """Among equal weights the lowest pixel index wins, as np.lexsort's
    stable order keeps it."""
    rng = np.random.default_rng(2)
    lin = rng.integers(0, 40, 500)
    ws = rng.choice(np.float32([0.2, 0.5, 0.5, 0.9]), 500)
    order = np.lexsort((-ws, lin))
    first = np.r_[True, lin[order][1:] != lin[order][:-1]]
    got = T.best_per_texel(torch.tensor(lin), torch.tensor(ws)).numpy()
    np.testing.assert_array_equal(got, order[first])


def test_insert_slots_replaces_only_a_strictly_weaker_slot():
    slot_w = torch.tensor([[0.5, 0.2, 0.2], [0.3, 0.3, 0.3]])
    slot_c = torch.zeros(2, 3, 3)
    lin = torch.tensor([0, 0, 1])
    ws = torch.tensor([0.2, 0.4, 0.3])
    cols = torch.arange(9, dtype=torch.float32).reshape(3, 3)
    T.insert_slots(slot_w, slot_c, lin, ws, cols)
    # texel 0: its best candidate (0.4) replaces the first weakest slot;
    # texel 1: 0.3 is not greater than 0.3, nothing moves
    np.testing.assert_array_equal(slot_w.numpy(), np.float32(
        [[0.5, 0.4, 0.2], [0.3, 0.3, 0.3]]))
    np.testing.assert_array_equal(slot_c[0, 1].numpy(), [3, 4, 5])
    assert not slot_c[1].any()


@pytest.mark.cuda
def test_bake_launches_the_mesh_kernel_once_per_frame():
    """On a CUDA camera: one mesh-kernel launch per frame.  Each half of
    the bake on the card is held to the CPU on the same inputs: the view
    weights from the card's fragments within 4e-6 (the card sums the vertex
    normals with atomic adds in another order: a few float32 ulps of n.v,
    times 8 for the 8th power), and the aggregation (stable sorts, slot
    insert, median) from the card's fragments and weights within 1e-6.  The
    rasterizer is held to its plain version by chip_smoke.py; the whole pass
    is not held across devices, where the projection's matmul rounds
    differently and pixels on an edge may change face."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs in chip_smoke.py on the card)")
    H, W, vlist, imgs, faces, uvs = case("bumpy")
    _, tcam = cameras(H, W)
    cam = TCAM.Camera(*(getattr(tcam, k).cuda() for k in
                        ("focal", "principal", "R", "T")), H, W)
    trace.read_and_clear()
    T.bake_texture(cam, vlist, imgs, faces, faces, uvs, tex_size=64)
    assert trace.read_and_clear()["counters"]["mesh_raster_launches"] == \
        len(vlist)
    fc, ft = torch.tensor(faces).long(), torch.tensor(faces).long().cuda()
    frags = []
    for v in vlist:
        vg = torch.tensor(v).cuda()
        fr = TRA.rasterize_mesh(cam, vg, ft, 32)
        g = T.view_weights(cam, vg, ft, fr, 8.0)
        c = T.view_weights(tcam, torch.tensor(v), fc,
                           TRA.Fragments(*(x.cpu() for x in fr)), 8.0)
        np.testing.assert_allclose(g[2].cpu().numpy(), c[2].numpy(), rtol=0,
                                   atol=4e-6)
        frags.append(g)
    for k in (8, 1):
        tg, wg = T.accumulate_texture(frags, imgs, faces, uvs, 64, k, "cuda")
        tc, wc = T.accumulate_texture(
            [tuple(x.cpu() for x in f) for f in frags], imgs, faces, uvs, 64,
            k, "cpu")
        np.testing.assert_allclose(tg, tc, rtol=0, atol=1e-6)
        np.testing.assert_allclose(wg, wc, rtol=0, atol=1e-6)


def cylinder(center, radius, half_h, n=8):
    """A band of 2n faces around the vertical axis through center, UV
    cylindrical (faces_vt = faces_v)."""
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([radius * np.sin(a), np.zeros(n), radius * np.cos(a)], 1)
    verts = np.concatenate([ring + [0, -half_h, 0], ring + [0, half_h, 0]])
    verts = (verts + center).astype(np.float32)
    i = np.arange(n)
    j = (i + 1) % n
    faces = np.concatenate([np.stack([i, j, j + n], 1),
                            np.stack([i, j + n, i + n], 1)]).astype(np.int32)
    uvs = np.stack([a / (2 * np.pi), np.zeros(n)], 1)
    uvs = np.concatenate([uvs, uvs + [0, 1]]).astype(np.float32)
    return verts, faces, uvs


@pytest.fixture(scope="module")
def rec_root(tmp_path_factory):
    """A JAX checkpoint (camera moved +1% from camera.npz), config.conf,
    both frameworks' skinner caches of the JAX skinner and a 16-face UV'd
    template/uvmap.obj in <scene>/rec."""
    root = str(tmp_path_factory.mktemp("tex"))
    jtr, _ = build_synthetic_trainer(root, n_frames=4, H=32, W=32)
    scene = osp.join(root, "scene")
    rec = osp.join(scene, "rec")
    os.makedirs(osp.join(rec, "template"))
    bank = dict(jtr.state.bank)
    bank["camera"] = {**bank["camera"],
                      "focal_length": bank["camera"]["focal_length"] * 1.01}
    jtr.state = jtr.state._replace(bank=bank)
    JCK.save_checkpoint(osp.join(rec, "latest.pkl"), jtr, epoch=3)
    shutil.copyfile(osp.join(osp.dirname(__file__), "..", "configs",
                             "config.conf"), osp.join(rec, "config.conf"))
    sk = jtr.skinner
    np.savez(osp.join(scene, "initial_skinner_1_v5.npz"),
             ws=np.asarray(sk.ws), b_min=np.asarray(sk.b_min),
             b_max=np.asarray(sk.b_max), joints=np.asarray(sk.joints),
             init_pose_inv=np.asarray(sk.init_pose_inv),
             parents=np.asarray(sk.parents), ws_dims=np.asarray(sk.ws_dims),
             body_vs=np.asarray(jtr.body_vs), body_fs=jtr.body_fs)
    torch.save({**dataclasses.asdict(port_skinner(sk)),
                "body_vs": torch.tensor(np.asarray(jtr.body_vs)),
                "body_fs": torch.tensor(np.asarray(jtr.body_fs))},
               osp.join(scene, "initial_skinner_1_torch.pt"))
    b_min, b_max = np.asarray(sk.b_min), np.asarray(sk.b_max)
    ext = b_max - b_min
    v, f, uv = cylinder((b_min + b_max) / 2, 0.3 * min(ext[0], ext[2]),
                        0.3 * ext[1])
    with open(osp.join(rec, "template", "uvmap.obj"), "w") as fh:
        fh.writelines(f"v {x} {y} {z}\n" for x, y, z in v)
        fh.writelines(f"vt {a} {b}\n" for a, b in uv)
        fh.writelines(f"f {a}/{a} {b}/{b} {c}/{c}\n" for a, b, c in f + 1)
    return scene, rec


def test_texture_cli_matches_jax(rec_root):
    """prepare on the JAX checkpoint in both frameworks (the port reads it
    as latest.pt: load_checkpoint tells formats apart by content), then
    extract from JAX's tex_predata.npz in both."""
    scene, rec = rec_root
    JCLI.prepare(["--rec-root", rec, "--num", "3", "--toy-smpl"])
    j = dict(np.load(osp.join(rec, "tex_predata.npz")))
    shutil.copyfile(osp.join(rec, "latest.pkl"), osp.join(rec, "latest.pt"))
    out = TCLI.prepare(["--rec-root", rec, "--num", "3", "--toy-smpl",
                        "--device", "cpu"])
    t = dict(np.load(osp.join(rec, "tex_predata.npz")))
    assert set(t) == set(j)
    assert out["def_vs_shape"] == (3, 16, 3)
    for k in j:
        if k == "def_vs":
            np.testing.assert_allclose(
                t[k], j[k], rtol=1e-5,
                atol=1e-5 * max(float(np.abs(j[k]).max()), 1.0))
        else:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # the trained camera, not camera.npz's
    npz = np.load(osp.join(scene, "camera.npz"))
    assert not np.allclose(t["focal"], [npz["fx"], npz["fy"]])
    np.savez(osp.join(rec, "tex_predata.npz"), **j)
    jcam = JCAM.make_camera(j["focal"], j["princeple"], j["quat"], j["T"],
                            int(j["H"]), int(j["W"]))
    for v in j["def_vs"]:
        frags = JRA.rasterize_mesh(jcam, jnp.asarray(v),
                                   jnp.asarray(j["faces_v"]),
                                   jnp.ones(len(j["faces_v"]), bool), 64)
        assert int(frags.overflow) == 0 and (np.asarray(
            frags.pix_to_face) >= 0).any()
    JCLI.extract(["--rec-root", rec, "--save-name", "texture_jax.png",
                  "--tex-size", "128"])
    res = TCLI.extract(["--rec-root", rec, "--tex-size", "128",
                        "--device", "cpu"])
    assert res["frames"] == 3 and res["tex_shape"] == (128, 128, 3)
    assert res["coverage"] > 0
    got = cv2.imread(res["path"])
    want = cv2.imread(osp.join(rec, "texture_jax.png"))
    np.testing.assert_array_equal(got, want)


def test_texture_cli_refuses_cuda_without_a_card(rec_root):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, rec = rec_root
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCLI.extract(["--rec-root", rec])
